"""Personalized PageRank per source. The reading is the widest L1 gap of a
checked row, sum over vertices of |got - want|; a row that is not finite
reads 1e30."""
import torch

from portbench.reference import algorithms

READING = "ppr_l1_gap"


def reference(edges, items, params, control=False):
    """One [N] row per source in `items`, in float64; the control in
    bfloat16 (the program computes in float32)."""
    dtype = torch.bfloat16 if control else torch.float64
    return list(algorithms.ppr(edges, items, beta=params["beta"], delta=params["delta"],
                               max_iter=params["maxIter"], dtype=dtype))


def gap(got, want) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        g = torch.as_tensor(g).to(torch.float64)
        if not bool(torch.isfinite(g).all()):
            return 1e30
        worst = max(worst, float((g - w.to(torch.float64)).abs().sum()))
    return worst
