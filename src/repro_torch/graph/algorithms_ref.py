"""Reference (oracle) implementations of the bundled programs, in NumPy.

The port's own copy of `repro.graph.algorithms_ref`: the port imports
nothing of the JAX package, so the examples and `chip_smoke.py` verify
against these. They take the port's `CSRGraph` on any device: `_np_csr`
brings its arrays to the host once, and everything after that is the
reference's NumPy, line for line, so the same graph gives the same
answers, bitwise. Host code only: no kernel and no torch compute.

Semantics follow the paper's DSL programs exactly:
  - SSSP: Bellman-Ford variant, integer weights, unreachable = INF.
  - PR:   damped PageRank with double buffering, convergence on L1 diff,
          dangling nodes contribute nothing (paper's formulation divides by
          out-degree of in-neighbors only).
  - TC:   directed triangle count per the paper's Fig. 20 (u < v < w wedge
          with closing edge (u, w)).
  - BC:   Brandes' algorithm on the *unweighted* BFS DAG (paper's Fig. 18),
          accumulated over a source set.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, INF_I32


def _np_csr(g: CSRGraph):
    """The six CSR/CSC arrays as host numpy, one copy each."""
    return tuple(getattr(g, f).cpu().numpy() for f in
                 ("indptr", "indices", "weights", "rev_indptr", "rev_indices",
                  "rev_weights"))


def sssp_ref(g: CSRGraph, src: int) -> np.ndarray:
    indptr, indices, weights, *_ = _np_csr(g)
    n = g.num_nodes
    dist = np.full(n, int(INF_I32), np.int64)
    dist[src] = 0
    for _ in range(n):  # Bellman-Ford
        changed = False
        for v in range(n):
            if dist[v] >= INF_I32:
                continue
            s, e = indptr[v], indptr[v + 1]
            nd = dist[v] + weights[s:e]
            nbrs = indices[s:e]
            upd = nd < dist[nbrs]
            if upd.any():
                np.minimum.at(dist, nbrs, nd)
                changed = True
        if not changed:
            break
    return np.where(dist >= INF_I32, int(INF_I32), dist).astype(np.int64)


def pagerank_ref(g: CSRGraph, delta: float = 0.85, beta: float = 1e-4,
                 max_iter: int = 100) -> np.ndarray:
    """Paper Fig. 19: pull over nodes_to(v), val=(1-delta)/N + delta*sum,
    loop while (diff > beta) && (iter < maxIter); diff accumulates signed
    (val - pr) exactly as the DSL's `diff += val - v.pageRank`."""
    indptr, indices, _, rev_indptr, rev_indices, _ = _np_csr(g)
    n = g.num_nodes
    out_deg = np.diff(indptr).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        nxt = np.zeros(n)
        for v in range(n):
            s, e = rev_indptr[v], rev_indptr[v + 1]
            nbrs = rev_indices[s:e]
            d = out_deg[nbrs]
            contrib = np.where(d > 0, pr[nbrs] / np.maximum(d, 1), 0.0)
            nxt[v] = (1 - delta) / n + delta * contrib.sum()
        # The paper's Fig. 19 PDF shows `diff += val - v.pageRank`; the
        # Green-Marl original this is borrowed from uses |val - pr| (L1),
        # and signed diff telescopes to ~0 — we use L1 (see DESIGN.md).
        diff = np.sum(np.abs(nxt - pr))
        pr = nxt
        if not (diff > beta):
            break
    return pr


def ppr_matrix_ref(g: CSRGraph, sources, delta: float = 0.85,
                   beta: float = 1e-4, max_iter: int = 100) -> np.ndarray:
    """Per-source personalized PageRank rows, [B, N].  Mirrors ppr.sp: the
    restart vector is the indicator on the source, rank starts at restart,
    each sweep pulls rank/out_deg over in-neighbors, and the do-while runs
    per source while (L1 diff > beta) && (iter < maxIter)."""
    indptr, indices, _, rev_indptr, rev_indices, _ = _np_csr(g)
    n = g.num_nodes
    out_deg = np.diff(indptr).astype(np.float64)
    rows = np.zeros((len(sources), n))
    for i, src in enumerate(sources):
        restart = np.zeros(n)
        restart[int(src)] = 1.0
        rank = restart.copy()
        it = 0
        while True:   # do-while: always at least one sweep
            nxt = np.zeros(n)
            for v in range(n):
                s, e = rev_indptr[v], rev_indptr[v + 1]
                nbrs = rev_indices[s:e]
                contrib = rank[nbrs] / np.maximum(out_deg[nbrs], 1)
                nxt[v] = (1 - delta) * restart[v] + delta * contrib.sum()
            diff = np.sum(np.abs(nxt - rank))
            rank = nxt
            it += 1
            if not (diff > beta and it < max_iter):
                break
        rows[i] = rank
    return rows


def ppr_ref(g: CSRGraph, sources, delta: float = 0.85, beta: float = 1e-4,
            max_iter: int = 100) -> np.ndarray:
    """Aggregate PPR of a seed set — the sum of the per-source rows, which
    is exactly what ppr.sp's shared `ppr` property accumulates."""
    return ppr_matrix_ref(g, sources, delta, beta, max_iter).sum(axis=0)


def label_propagation_ref(g: CSRGraph) -> np.ndarray:
    """Min-label propagation along edge direction (lp.sp): every vertex
    converges to the smallest vertex id among its directed ancestors
    (itself included)."""
    indptr, indices, *_ = _np_csr(g)
    n = g.num_nodes
    label = np.arange(n, dtype=np.int64)
    changed = True
    while changed:
        changed = False
        for v in range(n):
            lv = label[v]
            for w in indices[indptr[v]:indptr[v + 1]]:
                if lv < label[w]:
                    label[w] = lv
                    changed = True
    return label


def kcore_ref(g: CSRGraph, k: int) -> np.ndarray:
    """Directed k-core by iterative peeling (kcore.sp): repeatedly drop
    every surviving vertex whose out-degree *within the survivors* is < k;
    the fixpoint is order-independent.  Returns 0/1 survivor flags."""
    indptr, indices, *_ = _np_csr(g)
    n = g.num_nodes
    core = np.ones(n, np.int64)
    while True:
        deg = np.zeros(n, np.int64)
        for v in range(n):
            if core[v]:
                nbrs = indices[indptr[v]:indptr[v + 1]]
                deg[v] = int(core[nbrs].sum())
        peel = (core == 1) & (deg < k)
        if not peel.any():
            return core
        core[peel] = 0


def triangle_count_ref(g: CSRGraph) -> int:
    """Paper Fig. 20: for v, for u in nbrs(v) u<v, for w in nbrs(v) w>v,
    count if (u, w) is an edge."""
    indptr, indices, *_ = _np_csr(g)
    n = g.num_nodes
    adj = [set(indices[indptr[v]:indptr[v + 1]].tolist()) for v in range(n)]
    count = 0
    for v in range(n):
        nbrs = indices[indptr[v]:indptr[v + 1]]
        us = nbrs[nbrs < v]
        ws = nbrs[nbrs > v]
        for u in us:
            au = adj[int(u)]
            count += sum(1 for w in ws if int(w) in au)
    return count


def bfs_levels_ref(g: CSRGraph, src: int) -> np.ndarray:
    indptr, indices, *_ = _np_csr(g)
    return _bfs_levels(indptr, indices, g.num_nodes, src)


def _bfs_levels(indptr, indices, n, src):
    level = np.full(n, -1, np.int64)
    level[src] = 0
    frontier = [src]
    cur = 0
    while frontier:
        nxt = []
        for v in frontier:
            for w in indices[indptr[v]:indptr[v + 1]]:
                if level[w] < 0:
                    level[w] = cur + 1
                    nxt.append(int(w))
        frontier, cur = nxt, cur + 1
    return level


def bc_ref(g: CSRGraph, sources) -> np.ndarray:
    """Brandes over the BFS DAG, per the paper's Fig. 18 semantics:
    delta(v) = sum_{w in succ_DAG(v)} sigma(v)/sigma(w) * (1 + delta(w)),
    BC(v) += delta(v) for v != src."""
    indptr, indices, *_ = _np_csr(g)
    n = g.num_nodes
    bc = np.zeros(n)
    for src in sources:
        level = _bfs_levels(indptr, indices, n, src)   # the host arrays, copied once
        sigma = np.zeros(n)
        sigma[src] = 1.0
        maxlev = int(level.max())
        # forward: accumulate path counts level by level
        for lev in range(maxlev):
            for v in np.nonzero(level == lev)[0]:
                for w in indices[indptr[v]:indptr[v + 1]]:
                    if level[w] == lev + 1:
                        sigma[w] += sigma[v]
        delta = np.zeros(n)
        for lev in range(maxlev - 1, -1, -1):
            for v in np.nonzero(level == lev)[0]:
                for w in indices[indptr[v]:indptr[v + 1]]:
                    if level[w] == lev + 1 and sigma[w] > 0:
                        delta[v] += sigma[v] / sigma[w] * (1 + delta[w])
        mask = level >= 0
        mask[src] = False
        bc[mask] += delta[mask]
    return bc
