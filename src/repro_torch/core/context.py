"""GraphContext: the per-graph registry of derived execution structures.

The port's counterpart of `repro.core.context`. Every backend wants
something built from a `CSRGraph` once and reused across calls — the cuda
backend its degree-bucketed sliced-ELL view (reverse orientation, with the
COO hub tail) and that view's sweep plan, tests and benchmarks the dense
padded ELL view. All derived state for a graph lives in ONE
`GraphContext`, found through a weakref-keyed module registry:

    ctx = get_context(g)                 # registered on first touch
    ell = ctx.sliced_ell(schedule)       # built once per (layout, reverse)

Entries hold a WEAK reference to the graph: `id(g)` alone is unsafe (ids
are reused after GC) and a strong reference would leak every graph ever
run. `prepare(g, schedule)` is the explicit warm-up entry point.
`fingerprint()` is a stable content digest of the graph and `stats()`
summarizes its degree distribution and frontier growth. Across a
`g.update()`, `adopt_patched_views` carries the sliced views to the new
version by patching them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Optional

import numpy as np
import torch

from ..graph.csr import (CSRGraph, pad_nodes, resolve_schedule, to_ell,
                         to_sliced_ell)
from ..kernels.ell_spmv.plan import sweep_plan
from ..schedule import Schedule


class GraphContext:
    """Owns every derived structure of one graph, keyed by (kind, layout).

    Views are built lazily and memoized; two schedules that share a
    `layout_key()` share the same sliced view, and all programs compiled
    against the graph share this one context."""

    __slots__ = ("_graph_ref", "_views")

    def __init__(self, graph: CSRGraph):
        self._graph_ref = weakref.ref(graph)
        self._views: dict = {}

    @property
    def graph(self) -> CSRGraph:
        g = self._graph_ref()
        if g is None:
            raise ReferenceError(
                "the graph behind this GraphContext was garbage-collected")
        return g

    def view(self, key, build):
        """Memoized derived structure: `build(graph)` runs at most once."""
        v = self._views.get(key)
        if v is None:
            v = self._views[key] = build(self.graph)
        return v

    def view_keys(self) -> list:
        """The (kind, ...) keys of every view built so far (introspection)."""
        return sorted(self._views, key=repr)

    # ---- memory accounting + eviction ------------------------------------
    # views that are metadata (a digest string, a stats dict), not device
    # memory: never worth evicting, and they key persisted tuning records
    _META_VIEWS = ("fingerprint", "stats")

    def view_nbytes(self) -> dict:
        """Bytes of tensor storage held by each built view, keyed like
        `_views` (a storage shared between tensors is counted once per
        view; metadata views count zero). The sweep plan is a view of its
        own, so it is counted."""
        return {k: _storage_nbytes(v) for k, v in self._views.items()}

    def total_view_nbytes(self) -> int:
        """Bytes held by every derived view."""
        return sum(self.view_nbytes().values())

    def drop_view(self, key) -> bool:
        """Forget one memoized view (it rebuilds lazily on next request).
        Returns True when the key was present."""
        return self._views.pop(key, None) is not None

    def drop_derived_views(self) -> int:
        """Evict every *derived* view (sliced-ELL and its sweep plan,
        delta-ELL, padded ELL), keeping the metadata views (`fingerprint`,
        `stats`) that key tuning records. Returns the bytes freed.
        Consumers resolve views through the context per call, so the next
        query transparently re-prepares."""
        freed = 0
        for key in list(self._views):
            if key[0] in self._META_VIEWS:
                continue
            freed += _storage_nbytes(self._views.pop(key))
        return freed

    # ---- the derived structures ------------------------------------------
    def sliced_ell(self, schedule: Optional[Schedule] = None, *,
                   reverse: bool = True):
        """Degree-bucketed sliced-ELL view (+ COO hub tail). `reverse=True`
        is the pull orientation the engine relaxes/gathers over."""
        sched = resolve_schedule(schedule)
        key = ("sliced_ell", bool(reverse), sched.layout_key())
        return self.view(key, lambda g: to_sliced_ell(
            g, reverse=reverse, schedule=sched))

    def sweep_plan(self, schedule: Optional[Schedule] = None):
        """The launch plan of the reverse sliced view's one-launch pull
        sweep (`kernels.ell_spmv.plan`): the same object the ops find for
        that view, held here so `view_nbytes` counts it."""
        sched = resolve_schedule(schedule)
        key = ("sweep_plan", True, sched.layout_key())
        return self.view(key, lambda g: sweep_plan(self.sliced_ell(sched)))

    def ell(self, *, reverse: bool = False):
        """Dense padded `[N, max_deg]` ELL view (baseline)."""
        return self.view(("ell", bool(reverse)),
                         lambda g: to_ell(g, reverse=reverse))

    # a padded forward ELL costs N * round8(max_deg) cells; past this many
    # multiples of E (hub-heavy degree distributions) the compact bucket
    # relax would gather mostly padding, so delta-stepping falls back dense
    DELTA_ELL_MAX_BLOWUP = 8

    def delta_ell(self):
        """Forward padded ELL view for the delta-stepping compact relax
        (`rt.relax_minplus_delta` gathers frontier out-rows from it), or
        None when the padding blowup makes it uneconomical — the relax then
        takes its dense fallback, which computes the same fixed point."""
        def build(g):
            cells = g.num_nodes * max(-(-max(int(g.max_out_degree), 1) // 8) * 8, 8)
            if cells > self.DELTA_ELL_MAX_BLOWUP * max(g.num_edges, 1):
                return None
            return to_ell(g, reverse=False)
        return self.view(("delta_ell",), build)

    def padded(self, multiple: int) -> CSRGraph:
        """Node-count-padded copy of the graph (shard alignment)."""
        return self.view(("padded", int(multiple)),
                         lambda g: pad_nodes(g, multiple))

    def dist_arrays(self, num_shards: int, *, ell: bool = False, rank: int = 0,
                    device=None) -> dict:
        """Rank `rank`'s arrays of the 1-D block partition over `num_shards`
        shards, on `device` (default: the graph's). The host builds every
        shard and keeps only this rank's row; the view is keyed by rank
        and device, so two ranks of one process never share it."""
        from . import runtime_dist as rtd
        dev = torch.device(device) if device is not None else self.graph.device
        key = ("dist_1d", int(num_shards), bool(ell), int(rank), str(dev))
        return self.view(key, lambda g: rtd.shard_arrays(
            rtd.prepare_graph_1d(g, num_shards, ell=ell), rank, dev))

    def fingerprint(self) -> str:
        """Stable content digest of the graph (structure + weights)."""
        return self.view(("fingerprint",), _graph_fingerprint)

    def stats(self) -> dict:
        """Degree-distribution + frontier-growth summary (host-side, memoized)."""
        return self.view(("stats",), _graph_stats)


def _storage_nbytes(v, _seen=None) -> int:
    """Bytes of tensor storage reachable from a derived view: walks
    dataclass fields, dicts and sequences; each storage counts once."""
    if _seen is None:
        _seen = set()
    if isinstance(v, torch.Tensor):
        st = v.untyped_storage()
        if st.data_ptr() in _seen:
            return 0
        _seen.add(st.data_ptr())
        return int(st.nbytes())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return sum(_storage_nbytes(getattr(v, f.name), _seen)
                   for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return sum(_storage_nbytes(x, _seen) for x in v.values())
    if isinstance(v, (list, tuple)):
        return sum(_storage_nbytes(x, _seen) for x in v)
    return 0


# --------------------------------------------------------------------------
# graph identity + statistics
# --------------------------------------------------------------------------

PROBE_MAX_LEVELS = 64   # frontier probe cap: deep graphs saturate the signal


def _graph_fingerprint(g: CSRGraph) -> str:
    """sha256 over (N, E, version, indptr, indices, weights), truncated to
    16 hex chars — the reference's digest of the same graph."""
    h = hashlib.sha256()
    h.update(f"{g.num_nodes}:{g.num_edges}:{g.version}:".encode())
    for arr in (g.indptr, g.indices, g.weights):
        h.update(np.ascontiguousarray(arr.cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def _graph_stats(g: CSRGraph) -> dict:
    """Host-side numpy summary of the degree distribution plus a capped
    level-synchronous BFS probe from the highest-out-degree vertex."""
    n, e = g.num_nodes, g.num_edges
    out_deg = g.out_degree.cpu().numpy()
    avg = e / n if n else 0.0
    std = float(out_deg.std()) if n else 0.0
    weights = g.weights.cpu().numpy()
    avg_w = float(weights.mean()) if e else 0.0
    stats = {
        "num_nodes": n,
        "num_edges": e,
        "avg_degree": round(avg, 3),
        "max_out_degree": int(g.max_out_degree),
        "max_in_degree": int(g.max_in_degree),
        "skew": round(g.max_out_degree / avg, 3) if avg else 1.0,
        "deg_cv": round(std / avg, 3) if avg else 0.0,
        "avg_weight": round(avg_w, 3),
        "max_weight": int(weights.max()) if e else 0,
    }
    if e == 0:
        stats.update(probe_depth=0, probe_max_frontier_frac=0.0,
                     probe_growth=1.0, probe_reach_frac=0.0)
        return stats
    edge_src = g.edge_src.cpu().numpy()
    indices = g.indices.cpu().numpy()
    root = int(out_deg.argmax())
    level = np.full(n, -1, np.int32)
    level[root] = 0
    front = np.zeros(n, bool)
    front[root] = True
    sizes = [1]
    for lvl in range(PROBE_MAX_LEVELS):
        hit = np.zeros(n, bool)
        hit[indices[front[edge_src]]] = True
        newly = hit & (level < 0)
        if not newly.any():
            break
        level[newly] = lvl + 1
        front = newly
        sizes.append(int(newly.sum()))
    growth = max((b / a for a, b in zip(sizes, sizes[1:])), default=1.0)
    stats.update(
        probe_depth=len(sizes) - 1,
        probe_max_frontier_frac=round(max(sizes) / n, 4),
        probe_growth=round(growth, 2),
        probe_reach_frac=round(sum(sizes) / n, 4),
    )
    return stats


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict = {}   # id(graph) -> (weakref(graph), GraphContext)


def get_context(g: CSRGraph) -> GraphContext:
    """The graph's `GraphContext`, creating (and registering) it on first
    touch."""
    key = id(g)
    entry = _REGISTRY.get(key)
    if entry is None or entry[0]() is not g:
        ref = weakref.ref(g, lambda _r, _k=key: _REGISTRY.pop(_k, None))
        _REGISTRY[key] = entry = (ref, GraphContext(g))
    return entry[1]


def contains(g: CSRGraph) -> bool:
    """True if `g` currently has a live registered context."""
    entry = _REGISTRY.get(id(g))
    return entry is not None and entry[0]() is g


def registry_size() -> int:
    return len(_REGISTRY)


def clear() -> None:
    """Drop every registered context (tests / memory pressure)."""
    _REGISTRY.clear()


def prepare(g: CSRGraph, schedule: Optional[Schedule] = None, *,
            backend: str = "cuda", program=None) -> GraphContext:
    """Explicit warm-up: build the derived structures `backend` needs so the
    first query against `g` pays no host-side view construction.

    * ``cuda`` — the reverse sliced-ELL view for `schedule`'s layout and
      its sweep plan;
    * ``local`` — nothing derived (the CSR tensors ARE the layout); the
      context is still registered so `bind` is uniform.

    `program=` supplies the schedule/backend defaults. Returns the graph's
    `GraphContext`. Idempotent and cheap when already warm."""
    if program is not None:
        if schedule is None:
            schedule = getattr(program, "schedule", None)
        backend = getattr(program, "backend", backend)
    sched = resolve_schedule(schedule)
    ctx = get_context(g)
    if backend == "cuda":
        ctx.sweep_plan(sched)
    elif backend != "local":
        raise ValueError(
            f"unknown backend {backend!r}; expected 'local' or 'cuda'")
    return ctx


def adopt_patched_views(delta) -> GraphContext:
    """Carry the old graph's sliced-ELL views across a `g.update()`.

    `apply_update` calls this eagerly with the `GraphDelta` it built: every
    `("sliced_ell", reverse, layout)` view the OLD graph's context holds is
    delta-patched (`repro_torch.graph.dynamic.patch_sliced_ell`) and
    installed into the NEW graph's context, so post-update queries skip
    the O(N + E) view rebuild. Other derived views are left to rebuild
    lazily — the sweep plan among them: it belongs to one view object, and
    the patched view is a new one.

    Returns the new graph's context (registered even when the old graph
    never had one, so the fingerprint/bind machinery sees the new
    `version` immediately)."""
    from ..graph.dynamic import patch_sliced_ell
    new_ctx = get_context(delta.graph)
    if contains(delta.old):
        old_ctx = get_context(delta.old)
        for key in old_ctx.view_keys():
            if key[0] != "sliced_ell" or key in new_ctx._views:
                continue
            _, rev, _layout = key
            new_ctx._views[key] = patch_sliced_ell(
                old_ctx._views[key], delta, reverse=rev)
    return new_ctx
