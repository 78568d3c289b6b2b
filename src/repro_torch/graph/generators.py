"""Graph generators patterned on the paper's Table 2 suite.

PyTorch counterpart of `repro.graph.generators`: the same numpy draws from
the same seeds, so a generator gives the reference's graph, array for
array, on `device` (`None` = the card).

The paper evaluates on social networks (small-world, skewed), road networks
(large diameter, degree ~2), an RMAT graph (a=0.57,b=0.19,c=0.19,d=0.05 —
SNAP's parameters, quoted in §5), and a uniform-random graph (Green-Marl's
generator). We generate scaled-down instances of each family; edge weights
are uniform in [1, 100] exactly as the paper assigns for SSSP.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges

WEIGHT_LO, WEIGHT_HI = 1, 100


def _weights(rng: np.random.Generator, e: int) -> np.ndarray:
    return rng.integers(WEIGHT_LO, WEIGHT_HI + 1, size=e)


def uniform_random(n: int, avg_degree: int = 8, seed: int = 0, device=None) -> CSRGraph:
    """Uniform-random directed graph (the paper's UR, via Green-Marl's generator)."""
    rng = np.random.default_rng(seed)
    e = n * avg_degree
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    return from_edges(n, src, dst, _weights(rng, e), drop_self_loops=True, device=device)


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         device=None) -> CSRGraph:
    """RMAT with the paper's SNAP parameters (d = 1-a-b-c = 0.05): skewed degrees."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    e = n * edge_factor
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for bit in range(scale):
        r = rng.random(e)
        # quadrant probabilities a, b, c, d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    return from_edges(n, src, dst, _weights(rng, e), drop_self_loops=True, device=device)


def road(side: int, seed: int = 0, device=None) -> CSRGraph:
    """Grid 'road network': degree ≤ 4, large diameter (the paper's US/GR analogue)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    idx = (ii * side + jj).ravel()
    right = idx[(jj < side - 1).ravel()]
    down = idx[(ii < side - 1).ravel()]
    src = np.concatenate([right, down])
    dst = np.concatenate([right + 1, down + side])
    # drop a few edges so it is not perfectly regular
    keep = rng.random(len(src)) > 0.03
    src, dst = src[keep], dst[keep]
    return from_edges(n, src, dst, _weights(rng, len(src)), undirected=True, device=device)


def small_world(n: int, k: int = 8, p: float = 0.1, seed: int = 0, device=None) -> CSRGraph:
    """Watts-Strogatz-style social graph (the paper's OK/LJ/PK analogue)."""
    rng = np.random.default_rng(seed)
    base = np.arange(n)
    srcs, dsts = [], []
    for off in range(1, k // 2 + 1):
        srcs.append(base)
        dsts.append((base + off) % n)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    rewire = rng.random(len(src)) < p
    dst = np.where(rewire, rng.integers(0, n, size=len(dst)), dst)
    return from_edges(n, src, dst, _weights(rng, len(src)), undirected=True,
                      drop_self_loops=True, device=device)


def powerlaw_social(n: int, avg_degree: int = 12, seed: int = 0, device=None) -> CSRGraph:
    """Skewed-degree 'twitter-like' graph via preferential attachment sampling."""
    rng = np.random.default_rng(seed)
    e = n * avg_degree
    # Zipf-ish destination popularity
    ranks = np.arange(1, n + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    dst = rng.choice(n, size=e, p=probs)
    src = rng.integers(0, n, size=e)
    return from_edges(n, src, dst, _weights(rng, e), drop_self_loops=True, device=device)


def preferential_attachment(n: int, m: int = 8, seed: int = 0, device=None) -> CSRGraph:
    """Barabási-Albert preferential attachment: every new vertex attaches m
    edges to existing vertices chosen ∝ degree. True power-law degrees with
    a heavy hub tail (max degree ~ m·√n) — the adversarial input for the
    degree-bucketed engine, without the memory blow-up of a Zipf hub."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    repeated = [0]               # endpoint multiset: sampling it is ∝ degree
    for v in range(1, n):
        k = min(m, v)            # early vertices: fewer distinct targets exist
        chosen = set()
        while len(chosen) < k:
            chosen.add(repeated[rng.integers(len(repeated))])
        for u in chosen:
            src_l.append(v)
            dst_l.append(u)
            repeated.append(v)
            repeated.append(u)
    src = np.asarray(src_l, np.int64)
    dst = np.asarray(dst_l, np.int64)
    return from_edges(n, src, dst, _weights(rng, len(src)), undirected=True,
                      drop_self_loops=True, device=device)


SUITE = {
    # acronym -> (factory, kwargs)   — scaled-down Table 2
    "TW": (powerlaw_social, dict(n=4096, avg_degree=12, seed=1)),
    "SW": (uniform_random, dict(n=8192, avg_degree=4, seed=2)),
    "OK": (small_world, dict(n=2048, k=64, p=0.05, seed=3)),
    "WK": (powerlaw_social, dict(n=2048, avg_degree=48, seed=4)),
    "LJ": (small_world, dict(n=4096, k=24, p=0.1, seed=5)),
    "PK": (small_world, dict(n=2048, k=32, p=0.15, seed=6)),
    "US": (road, dict(side=96, seed=7)),
    "GR": (road, dict(side=64, seed=8)),
    "RM": (rmat, dict(scale=12, edge_factor=5, seed=9)),
    "UR": (uniform_random, dict(n=4096, avg_degree=8, seed=10)),
}


def load_suite(names=None, device=None) -> dict:
    names = names or list(SUITE)
    out = {}
    for name in names:
        fn, kw = SUITE[name]
        out[name] = fn(**kw, device=device)
    return out
