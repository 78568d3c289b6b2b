"""Plain-torch version of the block-ELL semiring SpMV (the kernel's oracle)."""
from __future__ import annotations

import torch


def ell_spmv_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                 semiring: str = "minplus") -> torch.Tensor:
    """cols/vals [R, D]; x [M] (→ y [R]) or [M, B] (→ y [R, B]), weights
    broadcast across the B lanes."""
    gathered = torch.index_select(x, 0, cols.reshape(-1)).reshape(
        cols.shape + x.shape[1:])           # [R, D] or [R, D, B]
    if x.ndim == 2:
        vals = vals[..., None]
    if semiring == "minplus":
        return torch.amin(gathered + vals, dim=1)
    if semiring == "plustimes":
        return torch.sum(gathered * vals, dim=1)
    raise ValueError(semiring)
