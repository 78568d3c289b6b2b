"""Dynamic graphs: edge write batches over immutable CSR snapshots.

The port of `repro.graph.dynamic`. `CSRGraph` stays immutable:
`g.update(adds, dels)` builds the NEXT version of the graph on the host and
returns a `GraphDelta` tying the two versions together with the *effective*
edge changes (what actually appeared / disappeared, with weight
replacements showing up as a remove + an add of the same endpoint pair).
The new version lives on the old one's device.

The delta is what makes incrementality possible downstream:

* `repro_torch.core.context.adopt_patched_views` uses the touched
  endpoints to delta-patch the old graph's sliced-ELL views into the new
  graph's `GraphContext` (in-place bucket row rewrites where the degree
  still fits the bucket; the COO hub tail absorbs degree-class
  migrations) instead of rebuilding them — `apply_update` does this
  eagerly. The patched hub tail stays sorted by row, which the cuda
  backend's one-launch sweep needs (`kernels.ell_spmv.plan`);
* `GraphDelta.plan()` derives the refresh seeding `BoundProgram.refresh`
  warm-starts iterative programs with: inserted edges seed their source
  endpoints, deletions reset the forward-reachable *cone* of the deleted
  heads and seed the cone plus its in-edge boundary.

The number of nodes never changes across an update; only edges do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .csr import (INF_I32, CSRGraph, SlicedEllGraph, _fill_rows,
                  _row_positions, from_edges)


def _normalize_pairs(pairs, n: int, what: str):
    """(src, dst) int64 arrays from a [K, 2] array / pair of arrays / list
    of (u, v) tuples; validates the vertex range."""
    if pairs is None:
        z = np.zeros(0, np.int64)
        return z, z
    if isinstance(pairs, tuple) and len(pairs) == 2 and \
            not np.isscalar(pairs[0]):
        src = np.asarray(pairs[0], np.int64).reshape(-1)
        dst = np.asarray(pairs[1], np.int64).reshape(-1)
        if src.shape != dst.shape:
            raise ValueError(
                f"{what}: src/dst arrays differ in length "
                f"({src.shape[0]} vs {dst.shape[0]})")
    else:
        arr = np.asarray(pairs, np.int64)
        if arr.size == 0:
            z = np.zeros(0, np.int64)
            return z, z
        arr = arr.reshape(-1, 2)
        src, dst = arr[:, 0], arr[:, 1]
    if src.size and (src.min() < 0 or src.max() >= n or
                     dst.min() < 0 or dst.max() >= n):
        raise ValueError(
            f"{what}: endpoints must be vertex ids in [0, {n}), got range "
            f"[{min(src.min(), dst.min())}, {max(src.max(), dst.max())}]")
    return src, dst


def _missing_from(keys_a, w_a, keys_b, w_b):
    """Mask over a's edges that are NOT present in b with the same weight
    (both key arrays sorted — CSR order is (src, dst)-lexicographic)."""
    out = np.ones(keys_a.shape[0], bool)
    if keys_b.shape[0] == 0:
        return out
    idx = np.searchsorted(keys_b, keys_a)
    valid = idx < keys_b.shape[0]
    iv = idx[valid]
    out[valid] = ~((keys_b[iv] == keys_a[valid]) & (w_b[iv] == w_a[valid]))
    return out


@dataclasses.dataclass(frozen=True)
class RefreshPlan:
    """Host-side seeding of one incremental refresh (see module docstring).

    ``reset`` marks the deletion cone: vertices whose previous converged
    value may be stale and must restart from the cold init. ``seed`` ⊇
    ``reset`` adds the cone's in-edge boundary and the source endpoints of
    inserted edges — the vertices the first warm sweep relaxes from.
    ``affected_frac`` is ``|seed| / N``, the quantity
    `Schedule.refresh_threshold_frac` gates."""

    reset: np.ndarray        # bool[N]
    seed: np.ndarray         # bool[N]
    affected_frac: float
    cone_size: int


@dataclasses.dataclass(eq=False)
class GraphDelta:
    """One applied update batch: ``old`` → ``graph`` (= ``old.version + 1``).

    The add/del arrays hold the EFFECTIVE changes (CSR-order sorted, host
    numpy): adding an already-present edge with its existing weight is
    dropped; replacing a weight appears as a removal of the old (src, dst,
    w) plus an addition of the new one; deleting an absent edge is a
    no-op."""

    old: CSRGraph
    graph: CSRGraph
    add_src: np.ndarray
    add_dst: np.ndarray
    add_wts: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    del_wts: np.ndarray
    _plan: Optional[RefreshPlan] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_added(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_removed(self) -> int:
        return int(self.del_src.shape[0])

    def touched_rows(self, *, reverse: bool) -> np.ndarray:
        """Rows whose adjacency changed in the given orientation: dst
        endpoints for the reverse (in-edge) view, src for the forward."""
        if reverse:
            return np.unique(np.concatenate([self.add_dst, self.del_dst]))
        return np.unique(np.concatenate([self.add_src, self.del_src]))

    def plan(self) -> RefreshPlan:
        """The refresh seeding for this delta (memoized)."""
        if self._plan is None:
            object.__setattr__(self, "_plan", _refresh_plan(self))
        return self._plan


def apply_update(g: CSRGraph, adds=None, dels=None, weights=None) -> GraphDelta:
    """`CSRGraph.update` implementation (host-side numpy; the new graph is
    moved to `g`'s device).

    Deletions apply first, then additions (so delete-then-reinsert within
    one batch keeps the edge, and an add of an existing pair replaces its
    weight). The old graph's sliced-ELL views are eagerly delta-patched
    into the new graph's `GraphContext`."""
    n = g.num_nodes
    src = g.edge_src.cpu().numpy().astype(np.int64)
    dst = g.indices.cpu().numpy().astype(np.int64)
    w = g.weights.cpu().numpy().astype(np.int64)
    key = src * n + dst          # sorted: CSR order is (src, dst)-lex

    a_src, a_dst = _normalize_pairs(adds, n, "adds")
    d_src, d_dst = _normalize_pairs(dels, n, "dels")
    if weights is None:
        a_w = np.ones_like(a_src)
    else:
        a_w = np.asarray(weights, np.int64).reshape(-1)
        if a_w.shape != a_src.shape:
            raise ValueError(
                f"weights must parallel adds ({a_src.shape[0]} edges), got "
                f"{a_w.shape[0]} values")
    if a_src.size:   # within-batch dedup: the LAST write to a pair wins
        a_key = a_src * n + a_dst
        _, first_rev = np.unique(a_key[::-1], return_index=True)
        sel = a_src.shape[0] - 1 - first_rev
        a_src, a_dst, a_w = a_src[sel], a_dst[sel], a_w[sel]

    drop = np.concatenate([d_src * n + d_dst, a_src * n + a_dst])
    keep = ~np.isin(key, drop) if drop.size else np.ones(key.shape[0], bool)
    new_src = np.concatenate([src[keep], a_src])
    new_dst = np.concatenate([dst[keep], a_dst])
    new_w = np.concatenate([w[keep], a_w])
    new_g = from_edges(n, new_src, new_dst, new_w, device=g.device)
    new_g = dataclasses.replace(new_g, version=g.version + 1)

    # effective changes: compare the (key, weight) sets of the two versions
    nk = new_g.edge_src.cpu().numpy().astype(np.int64) * n \
        + new_g.indices.cpu().numpy().astype(np.int64)
    nw = new_g.weights.cpu().numpy().astype(np.int64)
    removed = _missing_from(key, w, nk, nw)
    added = _missing_from(nk, nw, key, w)
    delta = GraphDelta(
        old=g, graph=new_g,
        add_src=(nk[added] // n).astype(np.int32),
        add_dst=(nk[added] % n).astype(np.int32),
        add_wts=nw[added].astype(np.int32),
        del_src=(key[removed] // n).astype(np.int32),
        del_dst=(key[removed] % n).astype(np.int32),
        del_wts=w[removed].astype(np.int32),
    )
    from ..core.context import adopt_patched_views
    adopt_patched_views(delta)
    return delta


def _refresh_plan(delta: GraphDelta) -> RefreshPlan:
    """The reference's host sweeps, run as tensor ops on the new graph's
    device (one host read per level); the plan itself is host numpy."""
    g = delta.graph
    n = g.num_nodes
    dev = g.device
    indices, edge_src = g.indices.long(), g.edge_src.long()
    reset = torch.zeros(n, dtype=torch.bool, device=dev)
    roots = torch.from_numpy(np.unique(delta.del_dst).astype(np.int64)).to(dev)
    has_edges = g.num_edges > 0
    if roots.numel():
        # forward closure from the deleted heads over the NEW graph,
        # edge-parallel level sweeps
        reset[roots] = True
        front = reset.clone()
        while has_edges:
            hit = torch.zeros(n, dtype=torch.bool, device=dev)
            hit[indices[front[edge_src]]] = True
            newly = hit & ~reset
            if not bool(newly.any()):
                break
            reset |= newly
            front = newly
    seed = reset.clone()
    if delta.add_src.size:
        seed[torch.from_numpy(delta.add_src.astype(np.int64)).to(dev)] = True
    if roots.numel() and has_edges:
        # the cone's in-edge boundary: still-exact values that re-supply it
        seed[edge_src[reset[indices]]] = True
    reset_np, seed_np = reset.cpu().numpy(), seed.cpu().numpy()
    frac = float(seed_np.sum() / n) if n else 0.0
    return RefreshPlan(reset=reset_np, seed=seed_np, affected_frac=frac,
                       cone_size=int(reset_np.sum()))


def patch_sliced_ell(view: SlicedEllGraph, delta: GraphDelta, *,
                     reverse: bool) -> SlicedEllGraph:
    """Delta-patch one sliced-ELL view of ``delta.old`` into a view of
    ``delta.graph`` without a full rebuild, on the view's device.

    A touched row whose new degree still fits its bucket's width is
    rewritten in place (its slot may carry more padding than the bucket's
    degree class implies — padding is semiring identity). Any
    degree-class migration — bucket overflow, an emptied row, an ex-hub
    row shrinking, a formerly degree-0 row appearing — evacuates the old
    slot (sentinel row N) and moves the row's full new adjacency to the
    COO hub tail, which handles arbitrary degrees. Bucket shapes and
    ``widths`` are preserved, so the patched view stays layout-compatible
    with the schedule that built it.

    Where the reference appends the moved rows to the end of the tail,
    the tail here is re-sorted by row with a stable sort, so each row's
    entries stay in CSR column order and the tail stays a list of row
    segments (the sweep plan requires it). The edge multiset is the
    reference's."""
    g = delta.graph
    n = g.num_nodes
    touched = delta.touched_rows(reverse=reverse)
    if touched.size == 0:
        return view      # empty delta: the old view is already exact
    dev = view.hub_rows.device
    csr = (g.rev_indptr, g.rev_indices, g.rev_weights) if reverse \
        else (g.indptr, g.indices, g.weights)
    indptr, indices, wts = (a.cpu().numpy() for a in csr)
    deg = (indptr[touched + 1] - indptr[touched]).astype(np.int64)

    # where each touched row lives in the old view: (bucket, slot) or -1
    where_b = np.full(touched.shape[0], -1, np.int64)
    where_slot = np.zeros(touched.shape[0], np.int64)
    for b, rows in enumerate(view.rows):
        slot_of = np.full(n + 1, -1, np.int64)      # slot n: the row padding
        slot_of[rows.cpu().numpy()] = np.arange(int(rows.shape[0]))
        slot = slot_of[touched]
        hit = slot >= 0
        where_b[hit] = b
        where_slot[hit] = slot[hit]
    in_hub = np.isin(touched, view.hub_rows.cpu().numpy())

    cols_out, wts_out, rows_out = list(view.cols), list(view.wts), list(view.rows)
    to_hub = np.zeros(touched.shape[0], bool)
    for b in np.unique(where_b[where_b >= 0]).tolist():
        width = int(view.cols[b].shape[1])
        mine = np.flatnonzero(where_b == b)
        fits = (deg[mine] > 0) & (deg[mine] <= width)
        cols_b, wts_b, rows_b = view.cols[b].clone(), view.wts[b].clone(), \
            view.rows[b].clone()
        slots = torch.from_numpy(where_slot[mine]).to(dev)
        cols_b[slots] = n
        wts_b[slots] = int(INF_I32)
        rewrite = mine[fits]
        if rewrite.size:
            c = np.full((rewrite.size, width), n, np.int32)
            v = np.full((rewrite.size, width), int(INF_I32), np.int32)
            _fill_rows(indptr, indices, wts, touched[rewrite], c, v)
            at = torch.from_numpy(where_slot[rewrite]).to(dev)
            cols_b[at] = torch.from_numpy(c).to(dev)
            wts_b[at] = torch.from_numpy(v).to(dev)
        # degree left the bucket: the slot becomes a padding row and the
        # hub tail absorbs the migration
        moved = mine[~fits]
        rows_b[torch.from_numpy(where_slot[moved]).to(dev)] = n
        to_hub[moved] = True
        cols_out[b], wts_out[b], rows_out[b] = cols_b, wts_b, rows_b
    to_hub |= (where_b < 0)
    to_hub &= deg > 0

    hub_rows, hub_cols, hub_wts = view.hub_rows, view.hub_cols, view.hub_wts
    evict = touched[in_hub]
    if evict.size or to_hub.any():
        keep = ~torch.isin(hub_rows, torch.from_numpy(evict.astype(np.int32)).to(dev))
        add = touched[to_hub]
        k, _, pos = _row_positions(indptr, add)
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
        rows_all = torch.cat([hub_rows[keep], as_dev(add[k])])
        order = torch.sort(rows_all, stable=True).indices
        hub_rows = rows_all[order]
        hub_cols = torch.cat([hub_cols[keep], as_dev(indices[pos])])[order]
        hub_wts = torch.cat([hub_wts[keep], as_dev(wts[pos])])[order]
    return SlicedEllGraph(
        cols=tuple(cols_out), wts=tuple(wts_out), rows=tuple(rows_out),
        hub_rows=hub_rows, hub_cols=hub_cols, hub_wts=hub_wts,
        num_nodes=n, widths=view.widths)


def sliced_ell_edges(view: SlicedEllGraph):
    """The (row, col, weight) multiset a sliced-ELL view encodes, as a
    sorted list of tuples (host-side; tests compare a patched view against
    a rebuilt one through this)."""
    n = view.num_nodes
    rs, cs, ws = [], [], []
    for cols, wts, rows in zip(view.cols, view.wts, view.rows):
        cols, wts, rows = cols.cpu().numpy(), wts.cpu().numpy(), rows.cpu().numpy()
        real = (rows < n)[:, None] & (cols < n)
        rs.append(np.broadcast_to(rows[:, None], cols.shape)[real])
        cs.append(cols[real])
        ws.append(wts[real])
    rs.append(view.hub_rows.cpu().numpy())
    cs.append(view.hub_cols.cpu().numpy())
    ws.append(view.hub_wts.cpu().numpy())
    r, c, w = (np.concatenate(x).astype(np.int64).tolist() for x in (rs, cs, ws))
    return sorted(zip(r, c, w))
