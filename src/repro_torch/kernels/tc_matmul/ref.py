"""Plain-torch versions of the masked lower-triangular L·L triangle count
and of the kernel's pack pass."""
from __future__ import annotations

import torch


def tc_matmul_ref(lower: torch.Tensor) -> torch.Tensor:
    """sum((L @ L) * L) as a 0-dim tensor of lower's dtype."""
    return ((lower @ lower) * lower).sum()


def pack_lower_ref(lower: torch.Tensor, tile: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack pass: (L8, L8T), int8 [Np, Np] with Np = N rounded up to
    `tile`, holding the strict lower triangle of `lower` and its transpose,
    zeros everywhere else. Raises ValueError on a strictly lower entry that
    is neither 0 nor 1 (the kernel's device-side assert)."""
    n = lower.shape[0]
    n_pad = -(-n // tile) * tile
    low = torch.tril(lower, -1)
    if not bool(((low == 0) | (low == 1)).all()):
        raise ValueError("a strictly lower entry is neither 0 nor 1")
    l8 = torch.zeros((n_pad, n_pad), dtype=torch.int8, device=lower.device)
    l8[:n, :n] = low.to(torch.int8)
    return l8, l8.t().contiguous()
