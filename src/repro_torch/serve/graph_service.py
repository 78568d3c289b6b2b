"""GraphService: the async multi-tenant graph-analytics serving layer.

The port of `repro.serve.graph_service`, the system's serving entry point,
over the port's `local` and `cuda` backends. The engine underneath
(Schedule / GraphContext / compile cache / batched [B, N] lanes) makes
one *sweep* cheap and lets one sweep answer ``Schedule.batch_sources``
source queries at once — this module *fills* those lanes from concurrent
traffic. Which requests share a sweep never changes any answer, only how
fast the answers arrive.

    service = GraphService(ServiceConfig(backend="cuda", max_wait_ms=5.0))
    service.register_graph("social", g)          # tuned + prepared + bound
    dist = await service.query("social", "sssp", src=17)

How a query is served:

1.  **Admission** — a request is accepted only while fewer than
    ``max_pending`` requests are in flight; past that the service sheds
    load with `ServiceOverloaded` instead of queueing unboundedly.
2.  **Coalescing** — accepted requests land in a lane keyed by
    (graph, query kind). The lane dispatcher dequeues up to the kind's
    lane width (``Schedule.batch_sources`` for per-source kinds) of
    compatible requests, waiting at most ``max_wait_ms`` for lane-mates so
    a lone query is never starved, then runs ONE batched sweep (in a
    worker thread, `asyncio.to_thread`) and scatters the per-source rows
    back to each awaiting future. A sweep's exception reaches its callers
    as `ServiceError`.
3.  **Deadlines** — each request carries a timeout (default
    ``default_timeout_s``); a request that times out while queued is
    dropped before the sweep forms, and one that times out mid-sweep
    simply never receives its (still computed) row.

Registration is where all the one-time cost goes: `register_graph`
fingerprints the graph, warm-reloads any persisted `TuningStore` record
for (program digest, backend, fingerprint), compiles the bundled programs
under the tuned (or configured) schedule, prepares the graph's derived
views (on `cuda`: the reverse sliced-ELL view and its sweep plan), and
binds the programs. A write batch (`update_graph`) swaps in the next
graph version, whose sliced views `g.update()` patched, once no sweep
over the graph is running.

Query kinds (`QueryKind`) define what a lane computes. Built-ins:

* ``sssp`` — per-source weighted distances; a lone query runs the bound
  program (on `cuda`: the `ell_sweep` kernel on its pull trips), a
  coalesced batch the multi-query engine `rt.sssp_multi` (delta-stepping
  under ``priority="delta"``); ``src=`` required.
* ``bfs``  — per-source hop levels (`rt.bfs_levels_batch`).
* ``bc``   — Brandes betweenness over the request's own ``sourceSet=``,
  one request per sweep (an aggregate is not separable across users).
* ``ppr``  — per-user personalized PageRank (`rt.ppr_multi`); a lone
  query runs the bound program on a one-source set.

Answers leave the device: each is a host numpy row, as in the reference.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..autotune import TuningStore, source_digest
from ..core import compile_bundled, load_program_source, prepare
from ..core import runtime as rt
from ..core.analysis import ERROR as ANALYSIS_ERROR
from ..core.analysis import check_schedule, program_analysis
from ..schedule import Schedule
from .pool import GraphPool


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------

class ServiceError(RuntimeError):
    """Base class for serving-layer failures."""


class ServiceOverloaded(ServiceError):
    """Admission control rejected the request (max_pending in flight)."""


class ServiceTimeout(ServiceError):
    """The request's deadline expired before its sweep completed."""


class ServiceClosed(ServiceError):
    """The service is shut down; no further queries are accepted."""


class UnknownGraph(ServiceError, LookupError):
    pass


class UnknownQueryKind(ServiceError, LookupError):
    pass


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Frozen serving knobs (the Schedule analogue one layer up), the
    reference's, with the backend `local` or `cuda`."""

    backend: str = "local"             # codegen backend: local | cuda
    schedule: Optional[Schedule] = None  # default Schedule (None = Schedule())
    coalesce: bool = True              # False: one query per sweep (baseline)
    max_wait_ms: float = 5.0           # lane-mate wait before a partial sweep
    max_pending: int = 1024            # admission bound on in-flight requests
    default_timeout_s: Optional[float] = 30.0   # per-request deadline
    max_concurrent_sweeps: int = 1     # sweeps running at once (threads)
    view_budget_bytes: Optional[int] = None     # GraphPool eviction bound

    def __post_init__(self):
        if self.backend not in ("local", "cuda"):
            raise ValueError(
                f"ServiceConfig.backend must be 'local' or 'cuda' (the "
                f"single-process serving backends), got {self.backend!r}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"ServiceConfig.max_wait_ms must be >= 0, got "
                f"{self.max_wait_ms}")
        if self.max_pending < 1:
            raise ValueError(
                f"ServiceConfig.max_pending must be >= 1, got "
                f"{self.max_pending}")
        if self.default_timeout_s is not None and self.default_timeout_s <= 0:
            raise ValueError(
                f"ServiceConfig.default_timeout_s must be positive or None "
                f"(no deadline), got {self.default_timeout_s}")
        if self.max_concurrent_sweeps < 1:
            raise ValueError(
                f"ServiceConfig.max_concurrent_sweeps must be >= 1, got "
                f"{self.max_concurrent_sweeps}")
        if self.view_budget_bytes is not None and self.view_budget_bytes <= 0:
            raise ValueError(
                f"ServiceConfig.view_budget_bytes must be positive or None "
                f"(unbounded), got {self.view_budget_bytes}")


# --------------------------------------------------------------------------
# query kinds
# --------------------------------------------------------------------------

def _pad_width(k: int, width: int) -> int:
    """Lane count a k-request batch runs at: the next power of two, capped
    at the lane width — as in the reference, so a lane runs at O(log
    width) distinct batch shapes."""
    b = 1
    while b < k:
        b *= 2
    return max(1, min(b, max(width, k)))


def _lanes(graph, srcs, width: int) -> torch.Tensor:
    """The batch's sources padded to `_pad_width` lanes (pads repeat the
    first source), as int32 on the graph's device."""
    arr = np.full(_pad_width(len(srcs), width), srcs[0], np.int32)
    arr[:len(srcs)] = srcs
    return torch.from_numpy(arr).to(graph.device)


class QueryKind:
    """One servable query type: how to validate a request's params and how
    to run a batch of them as one sweep.

    ``per_source=True`` kinds take ``src=<vertex>`` and are coalescable:
    many users' sources pack into one [B, N]-lane sweep whose row b is
    exactly request b's answer. ``per_source=False`` kinds (aggregates
    like BC) run one request per sweep."""

    name: str = ""
    per_source: bool = True
    program: Optional[str] = None    # bundled DSL program to compile + bind

    def check_params(self, params: dict) -> None:
        if self.per_source:
            if set(params) != {"src"}:
                raise ValueError(
                    f"{self.name!r} queries take exactly src=<vertex>, got "
                    f"{sorted(params) or 'nothing'}")
        elif "sourceSet" not in params:
            raise ValueError(f"{self.name!r} queries require sourceSet=")

    def make_runner(self, handle, sched: Schedule, width: int):
        """Return ``run(params_list) -> [result, ...]`` (called off-loop)."""
        raise NotImplementedError


class SsspKind(QueryKind):
    """Per-source weighted distances (int32[N] per request)."""

    name = "sssp"
    program = "sssp"

    def make_runner(self, handle, sched: Schedule, width: int):
        batched = functools.partial(
            rt.sssp_multi, threshold_frac=sched.push_threshold_frac,
            direction=sched.direction, priority=sched.priority,
            delta_bucket=sched.delta_bucket)
        bound = handle.bounds.get("sssp")

        def run(params_list):
            srcs = [int(p["src"]) for p in params_list]
            if len(srcs) == 1 and bound is not None:
                # the one-query-per-sweep path IS the compiled program
                return [bound(src=srcs[0])["dist"].cpu().numpy()]
            dist = batched(handle.graph, _lanes(handle.graph, srcs, width))
            dist = dist.cpu().numpy()
            return [dist[i] for i in range(len(srcs))]

        return run


class BfsKind(QueryKind):
    """Per-source hop levels (int32[N] per request; -1 = unreached)."""

    name = "bfs"

    def make_runner(self, handle, sched: Schedule, width: int):
        def run(params_list):
            srcs = [int(p["src"]) for p in params_list]
            level, _depth = rt.bfs_levels_batch(
                handle.graph, _lanes(handle.graph, srcs, width),
                threshold_frac=sched.push_threshold_frac,
                direction=sched.direction)
            level = level.cpu().numpy()
            return [level[i] for i in range(len(srcs))]

        return run


class BcKind(QueryKind):
    """Betweenness centrality over the request's own source set
    (float[N] per request — an aggregate, so never coalesced across
    requests; the set's sources still fill the program's internal lanes)."""

    name = "bc"
    per_source = False
    program = "bc"

    def make_runner(self, handle, sched: Schedule, width: int):
        bound = handle.bounds["bc"]

        def run(params_list):
            out = []
            for p in params_list:
                srcs = np.asarray(p["sourceSet"], np.int32)
                out.append(bound(sourceSet=srcs)["BC"].cpu().numpy())
            return out

        return run


class PprKind(QueryKind):
    """Per-user personalized PageRank (float32[N] per request): the user's
    restart vector is the indicator on their ``src=`` vertex, and B users'
    vectors pack into one batched sweep (`rt.ppr_multi`)."""

    name = "ppr"
    program = "ppr"

    def make_runner(self, handle, sched: Schedule, width: int):
        bound = handle.bounds.get("ppr")

        def run(params_list):
            srcs = [int(p["src"]) for p in params_list]
            if len(srcs) == 1 and bound is not None:
                # a singleton seed set's aggregate PPR IS the user's row
                out = bound(beta=1e-4, delta=0.85, maxIter=100,
                            sourceSet=np.asarray(srcs, np.int32))
                return [out["ppr"].float().cpu().numpy()]
            rank = rt.ppr_multi(handle.graph, _lanes(handle.graph, srcs, width))
            rank = rank.cpu().numpy()
            return [rank[i] for i in range(len(srcs))]

        return run


BUILTIN_KINDS = (SsspKind(), BfsKind(), BcKind(), PprKind())


# --------------------------------------------------------------------------
# the service
# --------------------------------------------------------------------------

class _Request:
    __slots__ = ("params", "future", "arrival")

    def __init__(self, params, future, arrival):
        self.params = params
        self.future = future
        self.arrival = arrival


class _Lane:
    """One coalescing queue: (graph, kind) → pending requests + dispatcher."""

    __slots__ = ("graph", "kind", "runner", "width", "items", "event", "task")

    def __init__(self, graph: str, kind: QueryKind, runner, width: int):
        self.graph = graph
        self.kind = kind
        self.runner = runner
        self.width = width
        self.items: collections.deque = collections.deque()
        self.event: Optional[asyncio.Event] = None   # created on the loop
        self.task: Optional[asyncio.Task] = None


class _GraphHandle:
    __slots__ = ("name", "graph", "ctx", "schedules", "programs", "bounds",
                 "tuned")

    def __init__(self, name, graph, ctx):
        self.name = name
        self.graph = graph
        self.ctx = ctx
        self.schedules: dict = {}   # kind name -> Schedule served under
        self.programs: dict = {}    # program name -> CompiledProgram
        self.bounds: dict = {}      # program name -> BoundProgram
        self.tuned: list = []       # kind names warm-loaded from the store


class GraphService:
    """Async multi-tenant serving front end over the batched graph engine.

    Construct, `register_graph` each graph (expensive: tune/compile/
    prepare/bind happen here), then `await query(...)` from any number of
    concurrent clients. `await close()` (or ``async with``) shuts down."""

    def __init__(self, config: Optional[ServiceConfig] = None, *,
                 tune_store=None):
        self.config = config or ServiceConfig()
        if isinstance(tune_store, str):
            tune_store = TuningStore(tune_store)
        self.tune_store: Optional[TuningStore] = tune_store
        self._pool = GraphPool(self.config.view_budget_bytes)
        self._kinds: dict = {k.name: k for k in BUILTIN_KINDS}
        self._graphs: dict = {}
        self._lanes: dict = {}
        self._pending = 0
        self._closed = False
        self._sweep_sem: Optional[asyncio.Semaphore] = None
        self._stats = collections.Counter()

    # ---- registration ----------------------------------------------------
    def register_kind(self, kind: QueryKind) -> None:
        """Add a custom `QueryKind` (PPR-style workloads); must happen
        before the graphs that should serve it are registered."""
        if not kind.name:
            raise ValueError("QueryKind needs a non-empty name")
        self._kinds[kind.name] = kind

    def register_graph(self, name: str, g, *, schedule: Optional[Schedule]
                       = None, kinds=None) -> _GraphHandle:
        """Register a graph for serving; all one-time cost happens here.

        Per query kind: resolve the schedule (explicit `schedule=` beats a
        warm-reloaded `TuningStore` record, which beats the config
        default), compile the kind's bundled program under it (compile-
        cache resident), prepare the graph's derived views, and memoize the
        bound runner — so the first query is pure execution."""
        if self._closed:
            raise ServiceClosed("service is closed")
        if name in self._graphs:
            raise ValueError(f"graph {name!r} is already registered")
        ctx = self._pool.add(name, g)
        handle = _GraphHandle(name, g, ctx)
        kind_names = list(kinds) if kinds is not None else list(self._kinds)
        for kname in kind_names:
            kind = self._kinds.get(kname)
            if kind is None:
                self._pool.remove(name)
                raise UnknownQueryKind(
                    f"no query kind named {kname!r} (registered: "
                    f"{sorted(self._kinds)})")
            sched = schedule or self._warm_schedule(kind, ctx, handle) \
                or self.config.schedule or Schedule()
            handle.schedules[kname] = sched
            if kind.program:
                prog = compile_bundled(kind.program,
                                       backend=self.config.backend,
                                       schedule=sched)
                prepare(g, program=prog)
                handle.programs[kind.program] = prog
                handle.bounds[kind.program] = prog.bind(g)   # memoized
            width = sched.batch_sources \
                if (self.config.coalesce and kind.per_source) else 1
            self._lanes[(name, kname)] = _Lane(
                name, kind, kind.make_runner(handle, sched, max(1, width)),
                max(1, width))
        self._graphs[name] = handle
        with self._pool.pin(name):      # never evict what we just warmed
            self._pool.enforce_budget()
        return handle

    def _warm_schedule(self, kind: QueryKind, ctx,
                       handle) -> Optional[Schedule]:
        """TuningStore warm-reload: a persisted record for (program digest,
        backend, graph fingerprint) supplies the serving schedule, so a
        registered graph's first query hits the tuned path without a
        measurement sweep."""
        if self.tune_store is None or not kind.program:
            return None
        digest = source_digest(load_program_source(kind.program))
        rec = self.tune_store.lookup(digest, self.config.backend,
                                     ctx.fingerprint())
        if rec is None:
            return None
        try:
            sched = rec.best_schedule()
        except ValueError:
            return None          # stored schedule not valid here -> default
        # legality gate on the reloaded schedule: a record tuned under an
        # older analysis (or hand-edited on disk) may combine knobs the
        # compile gate now rejects — fall back to the default rather than
        # fail registration with a DiagnosticError
        fx = program_analysis(
            load_program_source(kind.program)).functions.get(rec.fn_name)
        if fx is not None and any(
                d.severity == ANALYSIS_ERROR
                for d in check_schedule(fx, sched, self.config.backend)):
            return None
        handle.tuned.append(kind.name)
        return sched

    # ---- write batches ---------------------------------------------------
    async def update_graph(self, name: str, *, adds=None, dels=None,
                           weights=None):
        """Apply an edge write batch to a registered graph; returns the
        `GraphDelta` once applied.

        The swap is atomic with respect to sweeps: if the graph is pinned
        by an in-flight sweep the mutation defers until the last pin drops
        (`GraphPool.defer`), so a sweep always runs against one consistent
        version. Applying swaps the pool entry and handle to the new graph
        version (its sliced-ELL views delta-patched by `update()` itself),
        re-binds the handle's compiled programs, and rebuilds the kind
        runners — queued queries dispatched after the swap see the new
        version. Runs host-side on the event-loop thread: updates are
        assumed rare relative to queries (a write batch is an O(E) CSR
        rebuild, roughly one sweep's worth of work)."""
        if self._closed:
            raise ServiceClosed("service is closed")
        handle = self._graphs.get(name)
        if handle is None:
            raise UnknownGraph(
                f"no graph named {name!r} (registered: "
                f"{self._pool.names() or '<none>'})")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def apply(entry):
            try:
                delta = handle.graph.update(adds=adds, dels=dels,
                                            weights=weights)
                self._install_update(handle, entry, delta)
            except Exception as exc:
                if not fut.done():
                    fut.set_exception(exc)
                return
            if not fut.done():
                fut.set_result(delta)

        self._pool.defer(name, apply)
        return await fut

    def _install_update(self, handle, entry, delta) -> None:
        """Swap handle + pool entry to `delta.graph` and rebuild everything
        that closed over the old version (bound programs, kind runners)."""
        from ..core.context import get_context
        new_g = delta.graph
        ctx = get_context(new_g)       # registered (and patched) by update()
        entry.graph, entry.ctx = new_g, ctx
        handle.graph, handle.ctx = new_g, ctx
        for pname, prog in handle.programs.items():
            prepare(new_g, program=prog)
            handle.bounds[pname] = prog.bind(new_g)
        for (gname, kname), lane in self._lanes.items():
            if gname == handle.name:
                lane.runner = lane.kind.make_runner(
                    handle, handle.schedules[kname], lane.width)
        self._stats["updates"] += 1

    def unregister_graph(self, name: str) -> None:
        for key in [k for k in self._lanes if k[0] == name]:
            lane = self._lanes.pop(key)
            if lane.task is not None:
                lane.task.cancel()
            self._fail_lane(lane, ServiceClosed(f"graph {name!r} removed"))
        self._graphs.pop(name, None)
        self._pool.remove(name)

    # ---- the query path --------------------------------------------------
    async def query(self, graph: str, kind: str, *, timeout=-1.0, **params):
        """Serve one query; returns the kind's per-request result (e.g. the
        int32[N] distance row for ``sssp``). Raises `ServiceOverloaded`
        when admission sheds the request, `ServiceTimeout` past the
        deadline (``timeout=`` overrides the config default; None = no
        deadline)."""
        if self._closed:
            raise ServiceClosed("service is closed")
        lane = self._lanes.get((graph, kind))
        if lane is None:
            if graph not in self._graphs:
                raise UnknownGraph(
                    f"no graph named {graph!r} (registered: "
                    f"{self._pool.names() or '<none>'})")
            raise UnknownQueryKind(
                f"graph {graph!r} serves {sorted(k for g, k in self._lanes if g == graph)}, "
                f"not {kind!r}")
        lane.kind.check_params(params)
        if self._pending >= self.config.max_pending:
            self._stats["rejected"] += 1
            raise ServiceOverloaded(
                f"{self._pending} requests in flight >= max_pending="
                f"{self.config.max_pending}")

        loop = asyncio.get_running_loop()
        self._ensure_running(lane, loop)
        fut = loop.create_future()
        self._pending += 1
        fut.add_done_callback(self._on_done)
        lane.items.append(_Request(params, fut, loop.time()))
        lane.event.set()
        if timeout == -1.0:
            timeout = self.config.default_timeout_s
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._stats["timeouts"] += 1
            raise ServiceTimeout(
                f"{kind} query on {graph!r} missed its {timeout}s deadline "
                "(the service is overloaded or the sweep is large)") from None

    def _on_done(self, fut):
        self._pending -= 1

    def _ensure_running(self, lane: _Lane, loop) -> None:
        if lane.task is None or lane.task.done():
            if self._sweep_sem is None:
                self._sweep_sem = asyncio.Semaphore(
                    self.config.max_concurrent_sweeps)
            if lane.event is None:
                lane.event = asyncio.Event()
            lane.task = loop.create_task(
                self._lane_loop(lane),
                name=f"lane:{lane.graph}:{lane.kind.name}")

    # ---- coalescing dispatcher -------------------------------------------
    async def _gather(self, lane: _Lane) -> list:
        """Dequeue up to `lane.width` compatible requests: block for the
        first, then wait at most `max_wait_ms` for lane-mates (a partial
        lane flushes at the deadline — a lone query is never starved)."""
        loop = asyncio.get_running_loop()
        while not lane.items:
            lane.event.clear()
            await lane.event.wait()
        batch = [lane.items.popleft()]
        if lane.width > 1:
            deadline = loop.time() + self.config.max_wait_ms / 1e3
            while len(batch) < lane.width:
                if lane.items:
                    batch.append(lane.items.popleft())
                    continue
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                lane.event.clear()
                try:
                    await asyncio.wait_for(lane.event.wait(), remaining)
                except asyncio.TimeoutError:
                    break
        # a request whose deadline already fired (future cancelled) must
        # not occupy a lane
        return [r for r in batch if not r.future.done()]

    async def _lane_loop(self, lane: _Lane) -> None:
        while True:
            batch = await self._gather(lane)
            if not batch:
                continue
            async with self._sweep_sem:
                # pin: LRU eviction must never drop the views a running
                # sweep is resolving
                with self._pool.pin(lane.graph):
                    try:
                        results = await asyncio.to_thread(
                            lane.runner, [r.params for r in batch])
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:   # scatter the failure
                        err = ServiceError(
                            f"{lane.kind.name} sweep on {lane.graph!r} "
                            f"failed: {exc!r}")
                        for r in batch:
                            if not r.future.done():
                                r.future.set_exception(err)
                        continue
            self._stats["sweeps"] += 1
            self._stats["coalesced"] += len(batch)
            self._stats["max_batch"] = max(self._stats["max_batch"],
                                           len(batch))
            for r, res in zip(batch, results):
                if not r.future.done():
                    r.future.set_result(res)
                    self._stats["served"] += 1
            self._pool.enforce_budget()

    # ---- lifecycle + introspection ---------------------------------------
    def _fail_lane(self, lane: _Lane, exc: Exception) -> None:
        while lane.items:
            req = lane.items.popleft()
            if not req.future.done():
                req.future.set_exception(exc)

    async def close(self) -> None:
        """Stop dispatchers and fail queued requests with ServiceClosed."""
        self._closed = True
        tasks = [ln.task for ln in self._lanes.values() if ln.task is not None]
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        for lane in self._lanes.values():
            self._fail_lane(lane, ServiceClosed("service is closed"))

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    def graphs(self) -> list:
        return sorted(self._graphs)

    def handle(self, name: str) -> _GraphHandle:
        if name not in self._graphs:
            raise UnknownGraph(f"no graph named {name!r}")
        return self._graphs[name]

    def stats(self) -> dict:
        """Serving counters: queries served, sweeps run, mean/max coalesced
        lane occupancy, admission rejections, deadline misses, view-pool
        residency and evictions."""
        sweeps = self._stats["sweeps"]
        return {
            "served": self._stats["served"],
            "sweeps": sweeps,
            "mean_batch": (self._stats["coalesced"] / sweeps) if sweeps
            else 0.0,
            "max_batch": self._stats["max_batch"],
            "rejected": self._stats["rejected"],
            "timeouts": self._stats["timeouts"],
            "updates": self._stats["updates"],
            "pending": self._pending,
            "view_bytes": self._pool.view_nbytes(),
            "evictions": list(self._pool.evictions),
        }
