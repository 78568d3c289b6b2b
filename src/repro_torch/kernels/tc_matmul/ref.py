"""Plain-torch version of the masked lower-triangular L·L triangle count."""
from __future__ import annotations

import torch


def tc_matmul_ref(lower: torch.Tensor) -> torch.Tensor:
    """sum((L @ L) * L) as a 0-dim tensor of lower's dtype."""
    return ((lower @ lower) * lower).sum()
