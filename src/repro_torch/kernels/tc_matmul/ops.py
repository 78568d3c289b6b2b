"""Graph-level wrapper: CSR → strict-lower dense tiles → triangle count.

Counts each triangle once: L[i,j] = 1 iff (i,j) ∈ E∪Eᵀ and i > j (undirected
closure, strict lower triangle); triangles = Σ (L·L)⊙L. Dense N² storage:
sized for per-device vertex blocks of a few thousand, as the reference is.
"""
from __future__ import annotations

import numpy as np
import torch

from ...graph.csr import CSRGraph
from .kernel import tc_matmul


def prepare_lower(g: CSRGraph, block: int = 128) -> torch.Tensor:
    """Dense strict-lower adjacency of the undirected closure, padded to a
    multiple of `block`; built on the host in numpy, then moved to the
    graph's device."""
    n = g.num_nodes
    n_pad = -(-n // block) * block
    a = np.zeros((n_pad, n_pad), np.float32)
    src = g.edge_src.cpu().numpy()
    dst = g.indices.cpu().numpy()
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    a[hi[keep], lo[keep]] = 1.0
    return torch.from_numpy(a).to(g.device)


def count_triangles_dense(lower: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """The triangle count of `prepare_lower`'s output as an int32 0-dim tensor."""
    block = min(block, lower.shape[0])
    return tc_matmul(lower, block=block).to(torch.int32)
