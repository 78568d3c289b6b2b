"""Schedule legality: reject unsound knob × program-structure combinations.

``check_schedule(effects, schedule, backend)`` is a pure function from the
effect/monotonicity analysis of one DSL function plus a ``Schedule`` to a
list of diagnostics.  It never inspects runtime data — everything here is
decidable at compile time, which is the point: an illegal combination fails
with an actionable SPxxx message instead of a runtime fallback, a cryptic
JAX error, or a silently wrong answer.

Knobs left at their dataclass defaults are treated as ambient rather than
intentional: e.g. the default ``batch_sources=32`` on a program with no
source-set loop is not worth a warning (every compile would emit it), but an
explicitly nonstandard value signals intent and gets SP204.
"""
from __future__ import annotations

from typing import List

from ...schedule import Schedule
from .diagnostics import Diagnostic, diag
from .effects import FunctionEffects

_DEFAULTS = Schedule()


def check_schedule(fx: FunctionEffects, schedule: Schedule,
                   backend: str = "local") -> List[Diagnostic]:
    out: List[Diagnostic] = []
    s = schedule
    fn = fx.name

    if s.priority == "delta":
        target = fx.delta_target()
        if target is None:
            out.append(diag(
                "SP201",
                f"priority=\"delta\" requires a unique monotone int-valued "
                f"Min-relax fixedPoint; {fn!r} has none — delta-stepping "
                f"priority buckets are only sound when re-relaxation can "
                f"only decrease the keyed property",
                fn=fn))
        elif not target.weighted:
            out.append(diag(
                "SP202",
                f"priority=\"delta\" keyed on unweighted relax of "
                f"{target.prop!r}: every relaxation lands in the current "
                f"bucket, so delta-stepping degenerates to plain sweeps",
                line=target.line, fn=fn))

    if (backend == "distributed" and s.dist_frontier in ("compact", "auto")
            and not fx.has_iter_loop):
        out.append(diag(
            "SP203",
            f"dist_frontier={s.dist_frontier!r} carries changed-entry views "
            f"across supersteps, but {fn!r} has no iterative construct "
            f"(fixedPoint / BFS / while); the exchange machinery has "
            f"nothing to carry",
            fn=fn))

    if (s.batch_sources != _DEFAULTS.batch_sources and s.batch_sources > 1
            and not fx.has_set_loop):
        out.append(diag(
            "SP204",
            f"batch_sources={s.batch_sources} set explicitly but {fn!r} has "
            f"no `forall(... in <SetN>)` loop to batch over",
            fn=fn))

    if s.direction in ("push", "pull") and not fx.has_relax:
        out.append(diag(
            "SP205",
            f"direction={s.direction!r} pinned but {fn!r} has no "
            f"direction-switchable neighbor relax or BFS traversal",
            fn=fn))

    if (backend == "distributed" and s.dist_frontier in ("compact", "auto")
            and s.dist_gather_frac >= 0.5):
        out.append(diag(
            "SP206",
            f"dist_gather_frac={s.dist_gather_frac} >= 0.5: the compact "
            f"exchange cap (2 slots per changed entry) never beats a dense "
            f"row, so the schedule statically degrades to dense",
            fn=fn))

    if s.delta_bucket != _DEFAULTS.delta_bucket and s.priority == "none":
        out.append(diag(
            "SP207",
            f"delta_bucket={s.delta_bucket} has no effect while "
            f"priority=\"none\"",
            fn=fn))

    if (s.refresh_threshold_frac != _DEFAULTS.refresh_threshold_frac
            and not fx.has_iter_loop):
        out.append(diag(
            "SP208",
            f"refresh_threshold_frac={s.refresh_threshold_frac} set "
            f"explicitly but {fn!r} has no iterative construct (fixedPoint "
            f"/ while / do-while / BFS) to warm-start — "
            f"`BoundProgram.refresh` raises on this program and the knob "
            f"does nothing",
            fn=fn))

    return out
