"""PageRank of the whole graph. The reading is the widest relative gap of
any vertex, |got - want| / want (every rank is at least (1 - delta) / N);
a result that is not finite reads 1e30."""
import torch

from portbench.reference import algorithms

READING = "pr_rel_gap"


def reference(edges, items, params, control=False):
    """One [N] vector per item (items are placeholders: the answer has no
    source), in float64; the control in bfloat16."""
    dtype = torch.bfloat16 if control else torch.float64
    want = algorithms.pagerank(edges, beta=params["beta"], delta=params["delta"],
                               max_iter=params["maxIter"], dtype=dtype)
    return [want for _ in items]


def gap(got, want) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        g = torch.as_tensor(g).to(torch.float64)
        if not bool(torch.isfinite(g).all()):
            return 1e30
        w = w.to(torch.float64)
        worst = max(worst, float(((g - w).abs() / w).max()))
    return worst
