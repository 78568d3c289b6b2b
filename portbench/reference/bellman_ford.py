"""Shortest distances, compared exactly: the reading is the number of
entries of the checked rows that differ from Bellman-Ford's."""
import torch

from portbench.reference import algorithms

READING = "dist_mismatch"


def reference(edges, items, params, control=False):
    """One int32 [N] row per source in `items`; the control stops the
    fixed point one round before its last change."""
    return list(algorithms.bellman_ford(edges, items, rounds_short=1 if control else 0))


def gap(got, want) -> float:
    return float(sum(int((torch.as_tensor(g).to(torch.int64) != w.to(torch.int64)).sum())
                     for g, w in zip(got, want)))
