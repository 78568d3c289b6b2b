"""Public compiler API: StarPlat source → executable PyTorch program.

The port of `repro.core.api`, with the same algorithm/schedule split:

    sched = Schedule(direction="pull")               # the schedule
    prog  = compile_program(source, backend="cuda", schedule=sched)
    bound = prog.bind(g)                             # per-graph entry point
    out   = bound(src=0)                             # serve queries
    print(prog.source)                               # generated Python/PyTorch

Backends: ``"local"`` (plain torch, the reference's `local`),
``"cuda"`` (the reference's `pallas`: the relax and the PageRank gather go
through the hand-written `ell_spmv` kernel) and ``"distributed"`` (the
paper's MPI backend on `torch.distributed`, one process per shard; bind
with `mesh=dist.make_mesh_1d()` on every rank). A local or cuda program
runs on the device that holds the graph, a distributed one on each rank's
mesh device. `compile_program` is memoized on `(source digest,
backend, schedule, fn_name)` — the reference's key without its `jit`
slot, since PyTorch runs eagerly — and every compile, cache hits
included, passes the static analysis gate first.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import weakref
from typing import Callable, Optional

import torch

from ..graph.csr import resolve_schedule
from ..schedule import Schedule
from ..trace import span
from . import runtime as rt
from .analysis import (DiagnosticError, check_schedule, diag, entry_error,
                       program_analysis, split)
from .context import get_context
from .lowering import lower
from .parser import parse

_BACKENDS = ("local", "cuda", "distributed")

_PROGRAM_DIR = os.path.join(os.path.dirname(__file__), "programs")

_PRELUDE = (
    "import torch\n"
    "from repro_torch.core import runtime as rt\n\n"
)


@dataclasses.dataclass(eq=False)
class CompiledProgram:
    name: str
    backend: str
    source: str          # generated Python/PyTorch source text
    fn: Callable         # callable: fn(g, **params)
    ir: object
    schedule: Schedule   # the schedule baked into `source`
    dsl_source: str = ""  # the StarPlat source this was compiled from
    diagnostics: tuple = ()  # analysis findings that survived the gate
    # `<name>__refresh` wrapper (same calling convention as `fn`, plus
    # _warm/_reset/_seed), or None when the program has no top-level
    # iterative construct to warm-start. Call through
    # `BoundProgram.refresh`, which derives the seeding from a GraphDelta.
    refresh_fn: Optional[Callable] = None
    # distributed backend: which outputs are partitioned properties, which
    # replicated scalars, and whether ranks need the dense ELL rows
    dist_meta: Optional[dict] = None

    def recompile(self, schedule: Schedule) -> "CompiledProgram":
        """The same algorithm under a different schedule — a compile-cache
        probe."""
        return compile_program(self.dsl_source, backend=self.backend,
                               fn_name=self.name, schedule=schedule)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def bind(self, g, *, mesh=None) -> "BoundProgram":
        """Graph-bound callable — the uniform calling convention.

        A distributed program runs over `mesh` (default:
        `dist.make_mesh_1d()`, which needs the process group initialized);
        every rank binds and calls alike. Memoized per (program, graph)
        with weakref keying: repeated binds return the SAME `BoundProgram`
        as long as someone holds it. An explicit `mesh=` bypasses the
        cache (the mesh is caller state)."""
        if mesh is not None:
            return BoundProgram(self, g, mesh=mesh)
        key = (id(self), id(g))
        entry = _BIND_CACHE.get(key)
        if entry is not None:
            wp, wg, wb = entry
            bound = wb()
            if bound is not None and wp() is self and wg() is g:
                return bound
        bound = BoundProgram(self, g)

        def _evict(_r, _k=key):
            # only remove the entry this weakref belongs to: the key may
            # have been re-filled after an id() reuse
            cur = _BIND_CACHE.get(_k)
            if cur is not None and (cur[2]() is None or cur[0]() is None
                                    or cur[1]() is None):
                _BIND_CACHE.pop(_k, None)

        _BIND_CACHE[key] = (weakref.ref(self, _evict), weakref.ref(g, _evict),
                            weakref.ref(bound, _evict))
        return bound


class BoundProgram:
    """A `CompiledProgram` bound to one graph (`prog.bind(g)`).

    Holds the graph strongly and warms the per-graph structures once at
    construction (the cuda backend's reverse sliced-ELL view and its sweep
    plan; a local delta-stepping program's padded forward ELL; a
    distributed program's rank arrays of the partition), so every
    subsequent call is pure execution."""

    def __init__(self, program: CompiledProgram, graph, *, mesh=None):
        self.program = program
        self.graph = graph
        self.mesh = None
        ctx = get_context(graph)
        if program.backend == "distributed":
            from . import dist
            self.mesh = mesh if mesh is not None else dist.make_mesh_1d()
            self._gd = dist.prepare(graph, self.mesh,
                                    ell=program.dist_meta["needs_ell"])
            return
        if mesh is not None:
            raise ValueError(
                "mesh= applies to the distributed backend only (this "
                f"program's backend is {program.backend!r})")
        if program.backend == "cuda":
            ctx.sweep_plan(program.schedule)
        elif ", _dell" in program.source:
            ctx.delta_ell()   # warm the delta-stepping compact-relax view

    def __call__(self, **params):
        prog = self.program
        with span("call." + prog.name):
            if prog.backend != "distributed":
                return prog.fn(self.graph, **params)
            from . import dist
            return dist.run_prepared(prog, self._gd, self.mesh,
                                     num_nodes=self.graph.num_nodes, **params)

    def refresh(self, prev: dict, delta, /, **params):
        # prev/delta are positional-only: program params are free to reuse
        # the names (PR's damping factor is literally called `delta`)
        """Incremental recompute after `g.update()`: the previous result
        warm-starts the program's iterative construct instead of running it
        from the cold init.

        `prev` is a prior result dict of the SAME program (on the
        pre-update graph), `delta` the `GraphDelta` whose `.graph` this
        program is bound to. The delta's `plan()` supplies the seeding:
        previous per-node values are kept except in the deletion cone
        (reset to cold init), and the first sweep's frontier is the
        update-incident seed set. When the affected fraction of N exceeds
        `Schedule.refresh_threshold_frac`, this falls back to a plain call
        — either path returns the converged result a plain call would."""
        prog = self.program
        if prog.backend == "distributed":
            raise ValueError(
                "refresh is a local/cuda entry point; recompute "
                "distributed programs from scratch after an update")
        if prog.refresh_fn is None:
            raise ValueError(
                f"{prog.name!r} has no incremental refresh: the program "
                "has no top-level iterative construct (fixedPoint / while "
                "/ do-while) to warm-start")
        fx = program_analysis(prog.dsl_source).functions.get(prog.name)
        if fx is not None and fx.refresh_unsafe:
            raise DiagnosticError(
                [diag("SP209", fx.refresh_unsafe_reason, fn=prog.name,
                      line=fx.refresh_unsafe_line, src=prog.dsl_source)],
                header=f"refresh rejected for {prog.name!r}")
        if delta.graph is not self.graph:
            raise ValueError(
                "refresh must run on the post-update graph: bind the "
                "program to delta.graph and pass the matching delta")
        with span("call." + prog.name, refresh=True):
            plan = delta.plan()
            if plan.affected_frac > prog.schedule.refresh_threshold_frac:
                return self(**params)
            n = self.graph.num_nodes
            warm = {k: v for k, v in prev.items()
                    if getattr(v, "shape", None) == (n,)}
            dev = self.graph.device
            return prog.refresh_fn(self.graph, _warm=warm,
                                   _reset=torch.from_numpy(plan.reset).to(dev),
                                   _seed=torch.from_numpy(plan.seed).to(dev),
                                   **params)

    def __repr__(self):
        g = self.graph
        return (f"BoundProgram({self.program.name!r}, "
                f"backend={self.program.backend!r}, N={g.num_nodes}, "
                f"E={g.num_edges}, device={g.device})")


def _bind_sets(device, kw: dict, sets: tuple) -> dict:
    """`SetN` arguments (a tensor, a numpy array or a list of vertex ids)
    as int32 tensors on `device` (the graph's, or the rank's)."""
    for name in sets:
        if kw.get(name) is not None:
            kw[name] = torch.as_tensor(kw[name], dtype=torch.int32, device=device)
    return kw


def _exec_generated(src: str, fn_name: str, extra_env: Optional[dict] = None):
    """Exec the generated module source; returns its namespace."""
    env = {"torch": torch, "rt": rt}
    if extra_env:
        env.update(extra_env)
    code = compile(src, f"<starplat:{fn_name}>", "exec")
    exec(code, env)
    return env


# compile cache: (source digest, backend, schedule, fn_name) -> program
_COMPILE_CACHE: dict = {}

# bind cache: (id(program), id(graph)) -> (wr(program), wr(graph), wr(bound)).
# Everything is held WEAKLY: a BoundProgram keeps its graph alive, so the
# cache must not keep the bound program alive.
_BIND_CACHE: dict = {}


def compile_cache_clear() -> None:
    _COMPILE_CACHE.clear()


def compile_cache_size() -> int:
    return len(_COMPILE_CACHE)


def bind_cache_clear() -> None:
    _BIND_CACHE.clear()


def bind_cache_size() -> int:
    return len(_BIND_CACHE)


def compile_program(source: str, backend: str = "local",
                    fn_name: Optional[str] = None,
                    schedule: Optional[Schedule] = None,
                    strict: bool = False) -> CompiledProgram:
    """Compile a StarPlat program under an explicit `Schedule`.

    Every engine knob is baked into the generated source as a literal, so
    the same schedule yields byte-identical source. Results are memoized —
    repeated identical calls return the same `CompiledProgram` object.

    Every compile — cache hits included — passes the static analysis gate
    (`repro_torch.core.analysis`): errors raise `DiagnosticError` with
    stable SPxxx codes; `strict=True` promotes warnings to errors."""
    if backend not in _BACKENDS:
        raise entry_error(
            "SP301",
            f"unknown backend {backend!r}; backends: {', '.join(_BACKENDS)}")
    sched = resolve_schedule(schedule)

    # --- static analysis gate (runs before the cache: rejection must not
    # depend on whether an earlier permissive call already compiled) -------
    analysis = program_analysis(source)
    if fn_name is not None and fn_name not in analysis.functions:
        defined = ", ".join(analysis.functions) or "<none>"
        raise entry_error(
            "SP302",
            f"program defines no function named {fn_name!r}; it "
            f"defines: {defined}")
    gate_name = fn_name if fn_name is not None \
        else next(iter(analysis.functions))
    fx = analysis.functions[gate_name]
    diags = tuple(fx.diagnostics) + tuple(check_schedule(fx, sched, backend))
    errors, warnings = split(diags)
    if errors or (strict and warnings):
        raise DiagnosticError(
            diags, header=(f"analysis rejected {gate_name!r} "
                           f"(backend={backend!r})"))

    digest = hashlib.sha256(source.encode()).hexdigest()
    cache_key = (digest, backend, sched, fn_name)
    cached = _COMPILE_CACHE.get(cache_key)
    if cached is not None:
        return cached

    prog_ast = parse(source)
    irfns = lower(prog_ast)
    if fn_name is None:
        irfn = irfns[0]
    else:
        irfn = [f for f in irfns if f.name == fn_name][0]

    if backend == "local":
        from .codegen.local_torch import generate_local
        body, extra_env = generate_local(irfn, schedule=sched), None
    elif backend == "distributed":
        from .codegen.distributed import generate_distributed
        body, extra_env = generate_distributed(irfn, schedule=sched)
    else:
        from .codegen.cuda_backend import generate_cuda
        body, extra_env = generate_cuda(irfn, schedule=sched)

    src = _PRELUDE + body
    env = _exec_generated(src, irfn.name, extra_env)
    raw = env[irfn.name]
    raw_refresh = env.get(f"{irfn.name}__refresh")

    sets = tuple(p.name for p in irfn.params if p.kind == "set_n")
    takes_dell = f"def {irfn.name}({irfn.graph_param}, _dell" in body

    def _wrap(raw_fn):
        if backend == "cuda":
            def fn(g, *, _raw=raw_fn, _sched=sched, **kw):
                # degree-bucketed reverse (in-edge) view, owned by the
                # graph's shared GraphContext — built once per (graph, layout)
                return _raw(g, get_context(g).sliced_ell(_sched, reverse=True),
                            **_bind_sets(g.device, kw, sets))
            return fn
        if takes_dell:
            # delta-stepping program: the padded forward-ELL view the
            # compact bucket relax gathers frontier out-rows from (None on
            # hub-heavy graphs → dense fallback)
            def fn(g, *, _raw=raw_fn, **kw):
                return _raw(g, get_context(g).delta_ell(),
                            **_bind_sets(g.device, kw, sets))
            return fn
        if sets and backend == "distributed":
            # the rank arrays' device: set ids compare with `own_ids`
            def fn(gd, mesh, *, _raw=raw_fn, **kw):
                return _raw(gd, mesh, **_bind_sets(gd["own_ids"].device, kw, sets))
            return fn
        if sets:
            def fn(g, *, _raw=raw_fn, **kw):
                return _raw(g, **_bind_sets(g.device, kw, sets))
            return fn
        return raw_fn

    prog = CompiledProgram(
        name=irfn.name, backend=backend, source=src, fn=_wrap(raw),
        ir=irfn, schedule=sched, dsl_source=source, diagnostics=diags,
        refresh_fn=_wrap(raw_refresh) if raw_refresh is not None else None,
        dist_meta=(extra_env or {}).get("__dist_meta__"))
    _COMPILE_CACHE[cache_key] = prog
    if fn_name is None:
        # also file under the resolved name, so an explicit request for the
        # same function (e.g. CompiledProgram.recompile) hits the same object
        _COMPILE_CACHE[(digest, backend, sched, irfn.name)] = prog
    return prog


def bundled_programs() -> list:
    """Names of the bundled paper programs (`.sp` sources)."""
    return sorted(p[:-3] for p in os.listdir(_PROGRAM_DIR)
                  if p.endswith(".sp"))


def load_program_source(name: str) -> str:
    """Source text of a bundled paper program; raises `DiagnosticError`
    (a `ValueError`) naming the bundled programs otherwise."""
    path = os.path.join(_PROGRAM_DIR, f"{name}.sp")
    if not os.path.exists(path):
        raise entry_error(
            "SP303",
            f"no bundled program named {name!r}; bundled programs: "
            f"{', '.join(bundled_programs())}")
    with open(path) as f:
        return f.read()


def compile_bundled(name: str, backend: str = "local", **kw) -> CompiledProgram:
    return compile_program(load_program_source(name), backend=backend, **kw)
