"""Public compiler API: StarPlat source → executable PyTorch program.

The port of `repro.core.api`, with the same algorithm/schedule split:

    sched = Schedule(direction="pull")               # the schedule
    prog  = compile_program(source, backend="cuda", schedule=sched)
    bound = prog.bind(g)                             # per-graph entry point
    out   = bound(src=0)                             # serve queries
    print(prog.source)                               # generated Python/PyTorch

Backends: ``"local"`` (plain torch, the reference's `local`) and
``"cuda"`` (the reference's `pallas`: the relax and the PageRank gather go
through the hand-written `ell_spmv` kernel). A program runs on the device
that holds the graph. `compile_program` is memoized on `(source digest,
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
from . import runtime as rt
from .analysis import (DiagnosticError, check_schedule, entry_error,
                       program_analysis, split)
from .context import get_context
from .lowering import lower
from .parser import parse

_BACKENDS = ("local", "cuda")

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

    def recompile(self, schedule: Schedule) -> "CompiledProgram":
        """The same algorithm under a different schedule — a compile-cache
        probe."""
        return compile_program(self.dsl_source, backend=self.backend,
                               fn_name=self.name, schedule=schedule)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def bind(self, g) -> "BoundProgram":
        """Graph-bound callable — the uniform calling convention.

        Memoized per (program, graph) with weakref keying: repeated binds
        return the SAME `BoundProgram` as long as someone holds it."""
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
    plan), so every
    subsequent call is pure execution."""

    def __init__(self, program: CompiledProgram, graph):
        self.program = program
        self.graph = graph
        ctx = get_context(graph)
        if program.backend == "cuda":
            ctx.sweep_plan(program.schedule)

    def __call__(self, **params):
        return self.program.fn(self.graph, **params)

    def refresh(self, prev: dict, delta, /, **params):
        raise NotImplementedError(
            "incremental refresh after g.update() is not ported to "
            "repro_torch yet (ROADMAP.md queue 1, item 8)")

    def __repr__(self):
        g = self.graph
        return (f"BoundProgram({self.program.name!r}, "
                f"backend={self.program.backend!r}, N={g.num_nodes}, "
                f"E={g.num_edges}, device={g.device})")


def _bind_sets(g, kw: dict, sets: tuple) -> dict:
    """`SetN` arguments (a tensor, a numpy array or a list of vertex ids)
    as int32 tensors on the graph's device."""
    for name in sets:
        if kw.get(name) is not None:
            kw[name] = torch.as_tensor(kw[name], dtype=torch.int32, device=g.device)
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
    stable SPxxx codes; `strict=True` promotes warnings to errors.
    Constructs a later slice ports raise `NotImplementedError`."""
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
    else:
        from .codegen.cuda_backend import generate_cuda
        body, extra_env = generate_cuda(irfn, schedule=sched)

    src = _PRELUDE + body
    raw = _exec_generated(src, irfn.name, extra_env)[irfn.name]

    sets = tuple(p.name for p in irfn.params if p.kind == "set_n")
    if backend == "cuda":
        def fn(g, *, _raw=raw, _sched=sched, **kw):
            # degree-bucketed reverse (in-edge) view, owned by the graph's
            # shared GraphContext — built once per (graph, layout)
            return _raw(g, get_context(g).sliced_ell(_sched, reverse=True),
                        **_bind_sets(g, kw, sets))
    elif sets:
        def fn(g, *, _raw=raw, **kw):
            return _raw(g, **_bind_sets(g, kw, sets))
    else:
        fn = raw
    prog = CompiledProgram(
        name=irfn.name, backend=backend, source=src, fn=fn,
        ir=irfn, schedule=sched, dsl_source=source, diagnostics=diags)
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
