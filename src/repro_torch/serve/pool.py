"""GraphPool: the multi-graph GraphContext pool behind `GraphService`.

The port of `repro.serve.pool`. A long-lived server holds many registered
graphs, each with derived execution views (sliced-ELL buckets and their
sweep plans, delta-ELL, padded ELL) living in its `GraphContext`. Those
views are pure caches — every consumer resolves them through the context
per call — so under memory pressure the pool can drop the
least-recently-used graph's views and let the next query transparently
re-prepare them. What the pool never does:

* drop the *graph* itself (a registered graph stays resident until
  `remove()`; only derived views are evicted);
* drop the metadata views (`fingerprint`, `stats`) that key persisted
  tuning records (`GraphContext.drop_derived_views` keeps them);
* evict a graph that is **pinned** — `GraphService` pins a graph for the
  duration of every sweep over it, so eviction can never race a running
  computation's view resolution.

Accounting uses `GraphContext.total_view_nbytes()` (the bytes of tensor
storage reachable from each view, sweep plans included).
`enforce_budget()` walks graphs in LRU order and drops views until the
pool fits `view_budget_bytes`.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from ..core.context import GraphContext, get_context


class _Entry:
    __slots__ = ("name", "graph", "ctx", "seq", "pins", "deferred")

    def __init__(self, name: str, graph, ctx: GraphContext, seq: int):
        self.name = name
        self.graph = graph     # strong: a registered graph stays resident
        self.ctx = ctx
        self.seq = seq         # LRU clock: larger = more recently used
        self.pins = 0          # >0 while a sweep over this graph runs
        self.deferred = []     # mutations queued while pinned (see defer())


class GraphPool:
    """Named registry of (graph, GraphContext) pairs with memory-bounded
    LRU eviction of derived views."""

    def __init__(self, view_budget_bytes: Optional[int] = None):
        if view_budget_bytes is not None and view_budget_bytes <= 0:
            raise ValueError(
                f"view_budget_bytes must be positive (or None for "
                f"unbounded), got {view_budget_bytes}")
        self.view_budget_bytes = view_budget_bytes
        self._entries: dict = {}
        self._clock = 0
        self.evictions: list = []      # (name, freed_bytes) log, oldest first

    # ---- registry --------------------------------------------------------
    def add(self, name: str, graph) -> GraphContext:
        if name in self._entries:
            raise ValueError(f"graph {name!r} is already registered")
        self._clock += 1
        self._entries[name] = _Entry(name, graph, get_context(graph),
                                     self._clock)
        return self._entries[name].ctx

    def remove(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str, *, touch: bool = True) -> _Entry:
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"no graph named {name!r} in the pool "
                           f"(registered: {sorted(self._entries) or '<none>'})")
        if touch:
            self._clock += 1
            entry.seq = self._clock
        return entry

    def names(self) -> list:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # ---- pinning (sweep-in-progress protection) --------------------------
    @contextlib.contextmanager
    def pin(self, name: str):
        """Hold the graph un-evictable for the duration of a sweep. Pins
        nest (two lanes of the same graph may sweep concurrently). When the
        last pin drops, mutations deferred while pinned run (in order) —
        this is how a write batch waits out in-flight sweeps."""
        entry = self.get(name)
        entry.pins += 1
        try:
            yield entry
        finally:
            entry.pins -= 1
            if entry.pins == 0 and entry.deferred:
                pending, entry.deferred = entry.deferred, []
                for fn in pending:
                    fn(entry)

    def defer(self, name: str, fn) -> bool:
        """Run `fn(entry)` now if the graph is unpinned, else queue it to
        run when the last pin drops. Pin/unpin and defer all happen on the
        service's event-loop thread, so no locking is needed; a sweep that
        pins after the mutation ran sees the new state, one already pinned
        finishes against the old. Returns True when `fn` ran immediately."""
        entry = self.get(name, touch=False)
        if entry.pins == 0:
            fn(entry)
            return True
        entry.deferred.append(fn)
        return False

    # ---- memory accounting + eviction ------------------------------------
    def view_nbytes(self) -> int:
        return sum(e.ctx.total_view_nbytes() for e in self._entries.values())

    def enforce_budget(self) -> list:
        """Evict LRU graphs' derived views until the pool fits the budget.
        Pinned graphs are skipped (never drop views mid-sweep); with no
        budget this is a no-op. Returns the names evicted this call."""
        if self.view_budget_bytes is None:
            return []
        evicted = []
        over = self.view_nbytes() - self.view_budget_bytes
        if over <= 0:
            return evicted
        for entry in sorted(self._entries.values(), key=lambda e: e.seq):
            if over <= 0:
                break
            if entry.pins > 0:
                continue
            freed = entry.ctx.drop_derived_views()
            if freed:
                over -= freed
                evicted.append(entry.name)
                self.evictions.append((entry.name, freed))
        return evicted
