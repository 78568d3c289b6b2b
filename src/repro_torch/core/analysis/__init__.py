"""repro_torch.core.analysis — compile-time effect & legality analysis.

Public surface:

* :func:`program_analysis` — parse + semantic + effect/monotone analysis of
  a DSL source, memoized by source digest (the compile gate calls this on
  every ``compile_program``, including cache hits).
* :func:`check_schedule` — pure schedule-legality check per function.
* :class:`Diagnostic` / :class:`DiagnosticError` / ``REGISTRY`` — the stable
  SPxxx code registry and the one structured error shape the gate raises.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict

from ..parser import parse
from ..semantic import analyze as semantic_analyze
from .diagnostics import (ERROR, REGISTRY, SEVERITIES, WARNING, Diagnostic,
                          DiagnosticError, diag, entry_error, quote_line,
                          severity_of, split)
from .effects import (FixedPointInfo, FixedPointTarget, FunctionEffects,
                      PropAccess, Region, analyze_function)
from .legality import check_schedule
from .monotone import analyze_fixedpoint, conv_prop_of

__all__ = [
    "Diagnostic", "DiagnosticError", "REGISTRY", "SEVERITIES", "ERROR",
    "WARNING", "diag", "entry_error", "quote_line", "severity_of", "split",
    "FunctionEffects", "FixedPointInfo", "FixedPointTarget", "PropAccess",
    "Region", "analyze_function", "analyze_fixedpoint", "conv_prop_of",
    "check_schedule", "ProgramAnalysis", "program_analysis",
    "analysis_cache_clear",
]


@dataclass
class ProgramAnalysis:
    """Analysis of every function in one DSL source."""
    source: str
    functions: Dict[str, FunctionEffects] = field(default_factory=dict)

    def summary(self) -> dict:
        return {name: fx.summary()
                for name, fx in sorted(self.functions.items())}


_CACHE: Dict[str, ProgramAnalysis] = {}


def program_analysis(source: str) -> ProgramAnalysis:
    """Full compile-time analysis of ``source``, memoized by digest.

    Raises the frontend's own ``ParseError`` / ``SemanticError`` unchanged —
    the analysis layer only speaks for well-formed programs."""
    digest = hashlib.sha256(source.encode()).hexdigest()
    hit = _CACHE.get(digest)
    if hit is not None:
        return hit
    prog = parse(source)
    infos = semantic_analyze(prog)
    pa = ProgramAnalysis(source=source, functions={
        fn.name: analyze_function(fn, infos[fn.name], source)
        for fn in prog.functions})
    _CACHE[digest] = pa
    return pa


def analysis_cache_clear():
    _CACHE.clear()
