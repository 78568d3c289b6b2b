"""Hop levels, compared exactly: the reading is the number of entries of
the checked rows that differ from a level-synchronous BFS."""
import torch

from portbench.reference import algorithms

READING = "level_mismatch"


def reference(edges, items, params, control=False):
    """One int32 [N] row per source in `items` (-1 unreached); the control
    stops one expansion early."""
    return list(algorithms.bfs_levels(edges, items, rounds_short=1 if control else 0))


def gap(got, want) -> float:
    return float(sum(int((torch.as_tensor(g).to(torch.int64) != w.to(torch.int64)).sum())
                     for g, w in zip(got, want)))
