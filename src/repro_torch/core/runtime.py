"""Runtime library for StarPlat-generated PyTorch code.

The port's counterpart of `repro.core.runtime`, for the single-device
subset the generated `local` and `cuda` programs of this slice call. Race
handling (the paper's atomics) stays structural: `scatter_min` is a
scatter-reduce with "amin" (min is order-independent, so it is
deterministic), pull reductions are segment reductions over the sorted
in-edge ids. Float sums by `segment_sum` / `scatter_add` run with atomics
on the card, so their order is not fixed: float32 sums there accumulate in
float64 and round once (`_index_add`), so the order moves the result by an
ulp at most, not by the float32 error of a hub row's thousands of terms.

Where the reference branches on the device (`lax.cond`, `while_loop`),
generated code branches on the host: the predicates below read one device
scalar and return a Python bool.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import ENGINE, INF_I32, CSRGraph
from ..trace import span   # generated code opens its spans as `rt.span`

INF = int(INF_I32)   # a Python int, so int32 tensors stay int32 in arithmetic


def _identity_max(dtype: torch.dtype):
    """The value an empty segment holds after a min (jax.ops.segment_min)."""
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")


def _identity_min(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min if not dtype.is_floating_point else float("-inf")


# --- scatter / segment combine (the Min/Max construct, reductions) -----------

def scatter_min(current: torch.Tensor, idx: torch.Tensor, cand) -> torch.Tensor:
    """min-combine `cand` into `current` at positions `idx` (push relax)."""
    cand = torch.as_tensor(cand, dtype=current.dtype, device=current.device)
    return current.scatter_reduce(0, idx.long(), cand.expand(idx.shape), "amin")


def scatter_max(current, idx, cand):
    cand = torch.as_tensor(cand, dtype=current.dtype, device=current.device)
    return current.scatter_reduce(0, idx.long(), cand.expand(idx.shape), "amax")


# float64 elements per chunk of a float32 sum on the card (1 GiB)
_F64_CHUNK = 1 << 27


def _index_add(out, idx, vals):
    """out[..., idx[k]] += vals[..., k] along the last axis, in place.
    A float32 `out` on the card accumulates in float64, a chunk of edges at
    a time, and is rounded once: atomics add in no fixed order, and in
    float32 that order moves an iterative program's answer (batched ppr
    carries it through every sweep) by ~1e-4 of a value from run to run."""
    dim = out.dim() - 1
    if not (out.is_cuda and out.dtype == torch.float32):
        return out.index_add_(dim, idx, vals)
    acc = out.double()
    step = max(1, _F64_CHUNK // max(1, out[..., :1].numel()))
    for lo in range(0, idx.shape[0], step):
        acc.index_add_(dim, idx[lo:lo + step], vals[..., lo:lo + step].double())
    return out.copy_(acc)


def scatter_add(current, idx, vals):
    vals = torch.as_tensor(vals, dtype=current.dtype, device=current.device)
    return _index_add(current.clone(), idx.long(), vals.expand(idx.shape))


def scatter_or(current, idx, vals):
    return scatter_max(current, idx, vals)   # bool max == or


def _segment(vals, seg_ids, num_segments, reduce, fill):
    out = torch.full((num_segments,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg_ids.long(), vals.expand(seg_ids.shape), reduce)


def segment_sum(vals, seg_ids, num_segments, sorted_ids=True):
    """`sorted_ids` is the reference's hint to XLA; the result never
    depends on it."""
    vals = torch.as_tensor(vals)
    out = torch.zeros((num_segments,), dtype=vals.dtype, device=vals.device)
    return _index_add(out, seg_ids.long(), vals.expand(seg_ids.shape))


def segment_min(vals, seg_ids, num_segments, sorted_ids=True):
    vals = torch.as_tensor(vals)
    return _segment(vals, seg_ids, num_segments, "amin", _identity_max(vals.dtype))


def segment_max(vals, seg_ids, num_segments, sorted_ids=True):
    vals = torch.as_tensor(vals)
    return _segment(vals, seg_ids, num_segments, "amax", _identity_min(vals.dtype))


# --- batched (multi-source) scatter / segment combines -----------------------
#
# The batched engine carries per-source properties as [B, N] tensors; the
# per-edge values they induce are [B, E]. Each op below reduces along the
# last axis with the [E] index shared by every row (a stride-0 expand, never
# a [B, E] index), so the lanes ride along without a transpose. The
# reference drops out-of-range ids (`mode="drop"`); here they land in a
# spare column N that is sliced off, as the batched kernel ops do.

def _spare_col(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ids with every id outside [0, n) sent to the spare column n."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _segment_rows(vals, seg_ids, num_segments, reduce, fill):
    b = vals.shape[0]
    out = torch.full((b, num_segments + 1), fill, dtype=vals.dtype, device=vals.device)
    idx = _spare_col(seg_ids, num_segments)[None, :].expand(vals.shape)
    out.scatter_reduce_(1, idx, vals, reduce)
    return out[:, :num_segments].contiguous()


def segment_sum_batch(vals, seg_ids, num_segments, sorted_ids=True):
    """vals [B, E], seg_ids [E] → [B, num_segments] (float32 on the card
    accumulated in float64, see `_index_add`)."""
    segment_sum_batch.calls += 1
    out = torch.zeros((vals.shape[0], num_segments + 1), dtype=vals.dtype,
                      device=vals.device)
    _index_add(out, _spare_col(seg_ids, num_segments), vals)
    return out[:, :num_segments].contiguous()


# [B, E] sums in this process (one per sweep of batched ppr, one per BFS
# level and pass of batched bc)
segment_sum_batch.calls = 0


def segment_min_batch(vals, seg_ids, num_segments, sorted_ids=True):
    return _segment_rows(vals, seg_ids, num_segments, "amin", _identity_max(vals.dtype))


def segment_max_batch(vals, seg_ids, num_segments, sorted_ids=True):
    return _segment_rows(vals, seg_ids, num_segments, "amax", _identity_min(vals.dtype))


def _with_spare(current: torch.Tensor) -> torch.Tensor:
    """[B, N] → a fresh [B, N + 1] copy whose last column is spare."""
    out = torch.empty((current.shape[0], current.shape[1] + 1), dtype=current.dtype,
                      device=current.device)
    out[:, :-1] = current
    return out


def scatter_min_rows(current, idx, cand):
    """Row-wise scatter-min: current [B, N], idx [E], cand [B, E]."""
    n = current.shape[1]
    out = _with_spare(current)
    out.scatter_reduce_(1, _spare_col(idx, n)[None, :].expand(cand.shape), cand, "amin")
    return out[:, :n].contiguous()


def scatter_add_rows(current, idx, vals):
    n = current.shape[1]
    out = _with_spare(current)
    _index_add(out, _spare_col(idx, n), vals)
    return out[:, :n].contiguous()


def scatter_or_rows(current, idx, vals):
    """Row-wise scatter-or of bool `vals` [B, E] into bool `current`
    [B, N], as an int32 segment max (B·E·4 bytes, whatever the data)."""
    return current | (segment_max_batch(vals.to(torch.int32), idx, current.shape[1]) > 0)


# --- graph queries ------------------------------------------------------------

def _edge_key_fits_i32(n: int) -> bool:
    return n * n < 2**31


def _is_an_edge_keyed(g: CSRGraph, u, w):
    """Fast path: binary search over the cached sorted (src·N + dst) int32
    key, valid only while N² fits int32. The query stays int32, as the key
    is."""
    key = g.edge_key
    q = u.to(torch.int32) * g.num_nodes + w.to(torch.int32)
    pos = torch.searchsorted(key, q)
    pos = torch.clamp(pos, 0, key.shape[0] - 1)
    return key[pos] == q


def _is_an_edge_rowsearch(g: CSRGraph, u, w):
    """Large-graph path (N² ≥ 2³¹): per-query binary search of `w` inside
    CSR row `u`, a fixed number of lower_bound steps over
    indices[indptr[u] : indptr[u+1]], so no composite key (and no int64
    key) is ever formed."""
    e = g.num_edges
    n = g.num_nodes
    uc = torch.clamp(u, 0, n - 1).long()
    lo = g.indptr[uc].to(torch.int32)
    row_end = g.indptr[uc + 1].to(torch.int32)
    shape = torch.broadcast_shapes(lo.shape, w.shape)
    lo = lo.expand(shape)
    row_end = row_end.expand(shape)
    hi = row_end
    steps = max(int(g.max_out_degree), 1).bit_length() + 1
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = g.indices[torch.clamp(mid, 0, e - 1)] < w
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return ((lo < row_end) & (g.indices[torch.clamp(lo, 0, e - 1)] == w)
            & (u >= 0) & (u < n))   # match the keyed path on out-of-range u


def is_an_edge(g: CSRGraph, u, w) -> torch.Tensor:
    """Membership test, the paper's `is_an_edge` with sorted-CSR binary
    search (§5.1 TC). Graphs whose N² fits int32 search the cached
    composite key; larger ones search the row range. Broadcasts over u/w."""
    u = torch.as_tensor(u, device=g.device)
    w = torch.as_tensor(w, device=g.device)
    if g.num_edges == 0:
        return torch.zeros(torch.broadcast_shapes(u.shape, w.shape), dtype=torch.bool,
                           device=g.device)
    if _edge_key_fits_i32(g.num_nodes):
        return _is_an_edge_keyed(g, u, w)
    return _is_an_edge_rowsearch(g, u, w)


# --- host reads ----------------------------------------------------------------

def host_read(x):
    """A device scalar read on the host, as the Python bool or number it
    holds: the one device-to-host sync of a generated loop's condition or a
    push/pull choice, in a `host_read` span. A Python value passes
    through."""
    if not isinstance(x, torch.Tensor):
        return x
    with span("host_read"):
        return x.item()


# --- frontier engine (direction-optimizing traversal) --------------------------

def frontier_size(frontier: torch.Tensor) -> torch.Tensor:
    """On-device occupancy count of a dense bool frontier (int32, as in the
    reference; torch.sum of a bool gives int64)."""
    return torch.sum(frontier, dtype=torch.int32)


def frontier_should_push(frontier: torch.Tensor, n: int,
                         threshold_frac: float | None = None,
                         direction: str = "auto") -> bool:
    """True when the frontier is sparse enough that push (scatter from the
    few active sources) beats a pull sweep. The knob is
    `Schedule.push_threshold_frac` (fraction of N); `None` falls back to
    the deprecated `ENGINE` shim. A pinned `direction` short-circuits the
    test. Reads one device scalar."""
    if direction == "push":
        return True
    if direction == "pull":
        return False
    frac = ENGINE.push_threshold_frac if threshold_frac is None \
        else threshold_frac
    return host_read(frontier_size(frontier)) <= max(int(n * frac), 1)


def relax_minplus_hybrid(g: CSRGraph, dist: torch.Tensor,
                         frontier: torch.Tensor | None = None,
                         threshold_frac: float | None = None,
                         direction: str = "auto",
                         weighted: bool = True) -> torch.Tensor:
    """One SSSP/min-plus relaxation restricted to `frontier` sources, with
    push/pull direction chosen on the host from the frontier's occupancy.

      push: scatter-min dist[u]+w over out-edges of frontier vertices
      pull: per-vertex min over in-edges, sources masked to the frontier

    Both compute dist'[v] = min(dist[v], min_{(u,v)∈E, frontier[u]} dist[u]+w)
    exactly, so the switch never changes results. `frontier=None` is a dense
    sweep; `weighted=False` drops the `+ w` term.

    NOTE: this push/pull pair also exists in the kernel-backed ops
    (kernels/ell_spmv/ops.py `_relax_push`/`_relax_sliced_pull`) and inline
    in the local backend's generated source (local_torch.emit_relax_hybrid).
    A semantic change to any copy must be applied to all."""
    n = g.num_nodes

    def push(d):
        cand = d[g.edge_src] + g.weights if weighted else d[g.edge_src]
        if frontier is not None:
            cand = torch.where(frontier[g.edge_src], cand, INF)
        return scatter_min(d, g.indices, cand)

    def pull(d):
        cand = d[g.rev_indices] + g.rev_weights if weighted \
            else d[g.rev_indices]
        if frontier is not None:
            cand = torch.where(frontier[g.rev_indices], cand, INF)
        return torch.minimum(d, segment_min(cand, g.rev_edge_dst, n))

    if frontier is None:
        return pull(dist)
    if frontier_should_push(frontier, n, threshold_frac, direction):
        return push(dist)
    return pull(dist)


# --- delta-stepping (priority-bucketed) relaxation -----------------------------
#
# Schedule.priority == "delta" restricts each fixedPoint sweep to the
# vertices whose tentative value falls below the current bucket boundary
# (k + 1) * delta_bucket. Min relaxation is monotone, so any frontier
# restriction that eventually processes every modified vertex reaches the
# identical fixed point; the payoff is per-sweep work: a settled bucket's
# frontier is small, and the compact path below relaxes only its out-rows
# (O(cap * max_deg) through a padded ELL gather) instead of all E edges.

def relax_minplus_delta(g: CSRGraph, dist: torch.Tensor, frontier: torch.Tensor,
                        ell=None, cap: int | None = None,
                        threshold_frac: float | None = None,
                        direction: str = "auto",
                        weighted: bool = True) -> torch.Tensor:
    """One bucketed min relaxation over `frontier` sources (the caller has
    already restricted the frontier to the current delta bucket).

    With a padded forward ELL view and a `cap`, a frontier of at most
    `cap` vertices takes the compact path: its ids (ascending, as the
    reference's cumsum compaction orders them), their padded out-rows
    gathered, the candidates scatter-min'd. Pad cells (col == n) are
    masked to INF and land in a spare slot n that is sliced off. A larger
    frontier — and `ell=None` (hub-heavy graphs where the ELL view's
    padding is uneconomical) — takes the dense hybrid sweep, which
    computes the same relaxation. The reference's `lax.cond` on the
    frontier size is a host branch here: `nonzero` reads the size."""
    if ell is None or cap is None or cap <= 0:
        return relax_minplus_hybrid(g, dist, frontier, threshold_frac,
                                    direction, weighted)
    n = g.num_nodes
    ids = torch.nonzero(frontier).flatten()
    if ids.shape[0] > min(int(cap), n):
        return relax_minplus_hybrid(g, dist, frontier, threshold_frac,
                                    direction, weighted)
    cols = ell.cols[ids]                                   # [k, D]
    valid = cols < n
    src = dist[ids][:, None]
    cand = src + ell.wts[ids] if weighted else src.expand(cols.shape)
    cand = torch.where(valid, cand, INF)
    tgt = torch.where(valid, cols, n)                      # n → spare slot
    out = torch.cat([dist, dist.new_full((1,), INF)])
    out.scatter_reduce_(0, tgt.flatten().long(), cand.flatten(), "amin")
    return out[:n]


def frontier_rows_should_push(frontier: torch.Tensor, n: int,
                              threshold_frac: float | None = None) -> torch.Tensor:
    """Per-row push/pull choice for a [B, N] batched frontier → bool[B]
    (on the device). `None` falls back to the deprecated `ENGINE` shim."""
    frac = ENGINE.push_threshold_frac if threshold_frac is None \
        else threshold_frac
    occ = torch.sum(frontier, dim=1, dtype=torch.int32)
    return occ <= max(int(n * frac), 1)


def _cond_by_rows(rows_push, push_all, pull_all, mixed, arg):
    """Dispatch on the per-row direction vector: homogeneous batches take a
    single-direction branch; mixed batches evaluate both, each masked to its
    rows (the masks make the two halves disjoint, so combining is exact).
    Reads the vector's all/any on the host."""
    if host_read(torch.all(rows_push)):
        return push_all(arg)
    if host_read(torch.any(rows_push)):
        return mixed(arg)
    return pull_all(arg)


def relax_minplus_hybrid_batch(g: CSRGraph, dist: torch.Tensor,
                               frontier: torch.Tensor | None = None,
                               threshold_frac: float | None = None,
                               direction: str = "auto",
                               weighted: bool = True) -> torch.Tensor:
    """Batched SSSP/min-plus relaxation: dist [B, N], frontier [B, N] bool.

    Row-for-row identical to `relax_minplus_hybrid` on each dist row with
    its frontier row: push rows scatter-min over out-edges, pull rows
    segment-min over in-edges, and rows are routed independently. (One of
    the push/pull copies — see the NOTE on `relax_minplus_hybrid`.)"""
    n = g.num_nodes

    def push(d, fr):
        cand = d[:, g.edge_src] + g.weights[None, :] if weighted \
            else d[:, g.edge_src]
        if fr is not None:
            cand = torch.where(fr[:, g.edge_src], cand, INF)
        return scatter_min_rows(d, g.indices, cand)

    def pull(d, fr):
        cand = d[:, g.rev_indices] + g.rev_weights[None, :] if weighted \
            else d[:, g.rev_indices]
        if fr is not None:
            cand = torch.where(fr[:, g.rev_indices], cand, INF)
        return torch.minimum(d, segment_min_batch(cand, g.rev_edge_dst, n))

    if frontier is None:
        return pull(dist, None)
    if direction == "push":
        return push(dist, frontier)
    if direction == "pull":
        return pull(dist, frontier)
    rows_push = frontier_rows_should_push(frontier, n, threshold_frac)
    return _cond_by_rows(
        rows_push,
        lambda d: push(d, frontier),
        lambda d: pull(d, frontier),
        lambda d: pull(push(d, frontier & rows_push[:, None]),
                       frontier & ~rows_push[:, None]),
        dist)


def relax_minplus_delta_batch(g: CSRGraph, dist: torch.Tensor,
                              frontier: torch.Tensor,
                              threshold_frac: float | None = None,
                              direction: str = "auto",
                              weighted: bool = True) -> torch.Tensor:
    """Batched bucketed min relaxation: dist [B, N], frontier [B, N] already
    restricted per row to that row's current delta bucket. Each lane
    settles its own bucket sequence, so there is no whole-batch compact
    buffer: the restriction itself is the win, and the relaxation routes
    through the batched hybrid."""
    return relax_minplus_hybrid_batch(g, dist, frontier, threshold_frac,
                                      direction, weighted)


# --- BFS (iterateInBFS construct) ----------------------------------------------

def bfs_levels_batch(g: CSRGraph, roots: torch.Tensor,
                     threshold_frac: float | None = None,
                     direction: str = "auto"):
    """Batched level-synchronous BFS from roots[B] with per-row direction
    optimization. Dense frontier: level[v] = -1 until visited; frontier =
    (level == cur).

      push (small frontier): mark the out-neighbours of frontier vertices
      pull (large frontier): segment-or over in-edges from frontier sources

    Both mark exactly the unseen out-neighbourhood of the frontier, so the
    switch is result-invariant. The reference's `while_loop` is a host
    `while` that reads one device flag per level (and, under "auto", the
    rows' directions). Returns (level int32[B, N], depth): row b is the BFS
    from roots[b]; depth (a Python int) is the deepest row's count, so
    shallower rows see empty frontiers at the tail levels."""
    with span("bfs"):
        level, cur = _bfs_levels_batch(g, roots, threshold_frac, direction)
    bfs_levels_batch.calls += 1
    bfs_levels_batch.levels += cur
    return level, cur


def _bfs_levels_batch(g, roots, threshold_frac, direction):
    n = g.num_nodes
    b = roots.shape[0]
    lanes = torch.arange(b, device=g.device)
    level = torch.full((b, n), -1, dtype=torch.int32, device=g.device)
    level[lanes, roots.long()] = 0

    def push(fr):
        return scatter_or_rows(torch.zeros((b, n), dtype=torch.bool, device=g.device),
                               g.indices, fr[:, g.edge_src])

    def pull(fr):
        return segment_max_batch(fr[:, g.rev_indices].to(torch.int32),
                                 g.rev_edge_dst, n) > 0

    cur, changed = 0, True
    while changed:
        frontier = level == cur
        if direction == "push":
            reach = push(frontier)
        elif direction == "pull":
            reach = pull(frontier)
        else:
            rows_push = frontier_rows_should_push(frontier, n, threshold_frac)
            reach = _cond_by_rows(
                rows_push, push, pull,
                lambda fr: push(fr & rows_push[:, None]) | pull(fr & ~rows_push[:, None]),
                frontier)
        newly = reach & (level < 0)
        level = torch.where(newly, cur + 1, level)
        cur += 1
        changed = host_read(torch.any(newly))
    return level, cur


# BFS calls and expansions (levels) in this process, single-source ones
# included; a run's levels per BFS is their ratio
bfs_levels_batch.calls = 0
bfs_levels_batch.levels = 0


def bfs_levels(g: CSRGraph, root, *, threshold_frac: float | None = None,
               direction: str = "auto"):
    """Level-synchronous BFS from one root: `bfs_levels_batch` with one row
    (its per-row push/pull choice is the single-frontier one). Returns
    (level int32[N], depth), depth a Python int: the number of
    expansions, one more than the deepest level."""
    roots = torch.as_tensor(root, device=g.device).reshape(1)
    level, depth = bfs_levels_batch(g, roots, threshold_frac, direction)
    return level[0], depth


# --- multi-source queries -----------------------------------------------------

def sssp_multi(g: CSRGraph, sources, threshold_frac: float | None = None,
               direction: str = "auto", priority: str = "none",
               delta_bucket: int = 64) -> torch.Tensor:
    """Multi-query SSSP: one batched fixed point answering B source queries
    per sweep. Returns dist int32[B, N]; row b == SSSP from sources[b]. A
    host `while` reads one device flag per sweep.

    `priority="delta"` runs each lane's fixed point as delta-stepping: a
    sweep relaxes only the lane's vertices below its current bucket
    boundary, and a lane whose bucket settled jumps straight to the bucket
    of its smallest pending value. The fixed point is unchanged (Min is
    monotone); only the per-sweep work shrinks."""
    n = g.num_nodes
    sources = torch.as_tensor(sources, device=g.device).long()
    b = sources.shape[0]
    lanes = torch.arange(b, device=g.device)
    dist = torch.full((b, n), INF, dtype=torch.int32, device=g.device)
    dist[lanes, sources] = 0
    fr = torch.zeros((b, n), dtype=torch.bool, device=g.device)
    fr[lanes, sources] = True
    if priority != "delta":
        while host_read(torch.any(fr)):
            d2 = relax_minplus_hybrid_batch(g, dist, fr, threshold_frac, direction)
            fr = d2 < dist
            dist = d2
        return dist
    delta = int(delta_bucket)
    mod = fr
    bk = torch.zeros((b,), dtype=torch.int32, device=g.device)
    while host_read(torch.any(mod)):
        # fused bucket advance: a lane whose window emptied jumps to the
        # bucket of its smallest pending value (upper-bound-only window)
        pend_min = torch.amin(torch.where(mod, dist, INF), dim=1)
        in_win = torch.any(mod & (dist < ((bk + 1) * delta)[:, None]), dim=1)
        bk = torch.where(in_win, bk, pend_min // delta)
        fr = mod & (dist < ((bk + 1) * delta)[:, None])
        d2 = relax_minplus_delta_batch(g, dist, fr, threshold_frac, direction)
        mod = (d2 < dist) | (mod & ~fr)
        dist = d2
    return dist


def ppr_multi(g: CSRGraph, sources, delta: float = 0.85,
              beta: float = 1e-4, max_iter: int = 100) -> torch.Tensor:
    """Multi-query personalized PageRank: one batched sweep serving B
    personalization vectors. Returns float32[B, N]; row b is the PPR with
    the restart vector on sources[b], the per-source do-while ppr.sp
    lowers to: lanes converge independently (per-lane L1 diff vs `beta`)
    and converged lanes are frozen while the rest sweep."""
    n = g.num_nodes
    sources = torch.as_tensor(sources, device=g.device).long()
    b = sources.shape[0]
    lanes = torch.arange(b, device=g.device)
    restart = torch.zeros((b, n), dtype=torch.float32, device=g.device)
    restart[lanes, sources] = 1.0
    inv_deg = 1.0 / torch.clamp(g.out_degree, min=1).to(torch.float32)
    rank = restart
    act = torch.ones((b,), dtype=torch.bool, device=g.device)
    it = 0
    while host_read(torch.any(act)):
        contrib = (rank * inv_deg[None, :])[:, g.rev_indices]     # [B, E]
        pulled = segment_sum_batch(contrib, g.rev_edge_dst, n)
        del contrib
        nxt = (1.0 - delta) * restart + delta * pulled
        diff = torch.sum(torch.abs(nxt - rank), dim=1)
        rank = torch.where(act[:, None], nxt, rank)
        act = act & (diff > beta) & (it + 1 < max_iter)
        it += 1
    return rank


# --- triangle counting (the paper's Fig. 20 wedge pattern) ----------------------

WEDGE_BUDGET_BYTES = 1 << 30
_WEDGE_CELL_BYTES = 24    # live bytes per (v, u, w) cell: int32 query,
#                           int64 position, int32 key, bool masks


def wedge_count(g: CSRGraph, chunk: int = 512,
                budget_bytes: int = WEDGE_BUDGET_BYTES) -> torch.Tensor:
    """Vectorized node-iterator TC: for v, u in N(v) with u<v, w in N(v) with
    w>v, count (u, w) ∈ E. Wedges are enumerated on padded [C, D, D] blocks
    of C vertices. Where the reference pads every row to the graph's
    max_out_degree in chunks of `chunk` rows, the vertices here go in
    ascending out-degree order (those of degree < 2 have no wedge), each
    chunk is padded to its own largest degree D, and C ≤ `chunk` shrinks
    until the block fits `budget_bytes`: the count does not depend on
    either. Returns an int32 count; `wedge_count.last` holds the last
    call's largest D, its C there and the number of chunks."""
    n = g.num_nodes
    dev = g.device
    if g.num_edges == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    deg = g.out_degree.cpu().numpy()
    order = np.argsort(deg, kind="stable")
    order = order[deg[order] >= 2]
    deg_sorted = deg[order]
    order_t = torch.from_numpy(order.astype(np.int64)).to(dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    start, chunks, top = 0, 0, (0, 0)
    while start < order.shape[0]:
        c = min(chunk, order.shape[0] - start)
        while c > 1 and c * int(deg_sorted[start + c - 1]) ** 2 * _WEDGE_CELL_BYTES \
                > budget_bytes:
            c //= 2
        d = int(deg_sorted[start + c - 1])
        vs = order_t[start:start + c]
        ar = torch.arange(d, device=dev)
        offs = g.indptr[vs].long()[:, None] + ar[None, :]
        valid = ar[None, :] < g.out_degree[vs][:, None]
        cols = torch.where(valid, g.indices[torch.clamp(offs, 0, g.num_edges - 1)], n)
        vv = vs[:, None, None]
        u = cols[:, :, None]                      # [C, D, 1]
        w = cols[:, None, :]                      # [C, 1, D]
        mask = (valid[:, :, None] & valid[:, None, :] & (u < vv) & (w > vv))
        total += torch.sum(mask & is_an_edge(g, u, w))
        top = max(top, (d, c))
        start += c
        chunks += 1
    out = total.to(torch.int32)
    wedge_count.last = dict(max_degree=top[0], chunk_at_max_degree=top[1], chunks=chunks,
                            vertices=int(order.shape[0]))
    return out


wedge_count.last = None


# --- property helpers ------------------------------------------------------------

def init_prop(n, dtype, value=None, *, device):
    """[n] property of `dtype` on `device`, zero or filled with `value` (a
    Python scalar or a 0-d tensor)."""
    if value is None:
        return torch.zeros((n,), dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device).expand(n).clone()


def set_at(prop: torch.Tensor, idx, value) -> torch.Tensor:
    """Out-of-place single-node write: a copy of `prop` with prop[idx] =
    value (the reference's `prop.at[idx].set(value)`)."""
    out = prop.clone()
    out[idx] = value
    return out


def warm_start(init, warm, reset=None):
    """Per-property warm start of an incremental refresh (`__refresh`
    variants call this right before the iterative construct).

    `init` is the property AFTER the program's own init statements ran, so
    source writes (e.g. `dist[src] = 0`) survive for reset vertices. With
    no previous value the cold init stands; with one, `reset` marks the
    vertices whose previous value may be stale (the deletion cone) and
    falls back to the cold init there."""
    if warm is None:
        return init
    warm = torch.as_tensor(warm, dtype=init.dtype, device=init.device)
    if reset is None:
        return warm
    return torch.where(torch.as_tensor(reset, device=init.device), init, warm)


def init_prop_batch(b, n, dtype, value=None, *, device):
    """[B, N] per-source property block (batched set-loop chunk). `value`
    may be a scalar or an [N] vector (broadcast across the batch rows)."""
    if value is None:
        return torch.zeros((b, n), dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device).expand(b, n).clone()


def inf_for(dtype):
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return INF


def reduce_identity(op: str, dtype, device=None):
    if op == "+":
        return torch.zeros((), dtype=dtype, device=device)
    if op == "*":
        return torch.ones((), dtype=dtype, device=device)
    if op == "&&":
        return torch.tensor(True, device=device)
    if op == "||":
        return torch.tensor(False, device=device)
    raise ValueError(op)
