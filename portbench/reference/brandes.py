"""Betweenness over a source set. The reading is the widest gap of any
vertex, |got - want| / max(|want|, 1): a relative error where BC is large
and an absolute one where it is below 1. A value that is not finite reads
1e30."""
import torch

from portbench.reference import algorithms

READING = "bc_rel_gap"


def reference(edges, items, params, control=False):
    """One BC [N] per source set in `items`, in float64; the control in
    bfloat16 (the program computes in float32)."""
    dtype = torch.bfloat16 if control else torch.float64
    return [algorithms.brandes(edges, srcs, dtype=dtype) for srcs in items]


def gap(got, want) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        g = torch.as_tensor(g).to(torch.float64)
        w = w.to(torch.float64)
        if not bool(torch.isfinite(g).all()):
            return 1e30
        worst = max(worst, float(((g - w).abs() / w.abs().clamp(min=1.0)).max()))
    return worst
