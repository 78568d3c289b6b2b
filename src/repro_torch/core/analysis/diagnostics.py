"""Diagnostics: stable ``SPxxx`` codes, severities, and a uniform error shape.

Every message the compile-time analysis layer can produce is registered here
with a stable code and a default severity.  A :class:`Diagnostic` is a frozen
value object carrying the code, the resolved severity, a human-readable
message, and (when known) the source position *plus the offending source
line itself* — tools should never have to re-open the ``.sp`` file to show
context.

``DiagnosticError`` is the one exception type the gate raises.  It subclasses
``ValueError`` on purpose: every pre-existing caller of ``compile_program`` /
``load_program_source`` that catches ``ValueError`` (the serving layer's
warm-schedule reload, the autotuner) keeps working, while new callers can
catch ``DiagnosticError`` and read ``.diagnostics`` for the structured list.

The registry below is lint-checked against ``docs/analysis.md`` by
``tests/test_docs.py`` — add a code here and the docs test fails until the
table documents it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"
SEVERITIES = (ERROR, WARNING)

#: code -> (default severity, one-line description).  Codes are grouped:
#:   SP1xx  effect analysis (races, parallel-write legality)
#:   SP15x  fixed-point / monotonicity analysis
#:   SP2xx  schedule legality (knob × program-structure combinations)
#:   SP3xx  compile-entry errors (unknown backend / function / program)
REGISTRY: Dict[str, Tuple[str, str]] = {
    "SP101": (ERROR,
              "cross-vertex plain property write under a parallel forall "
              "(write-write race); use a Min/Max/reduction update"),
    "SP102": (WARNING,
              "plain scalar assignment inside a parallel loop "
              "(last-writer-wins; use a reduction form such as `x = x + t`)"),
    "SP151": (ERROR,
              "fixedPoint convergence property is never written inside the "
              "loop body (the loop cannot terminate)"),
    "SP153": (WARNING,
              "fixedPoint property is updated non-monotonically (mixed "
              "Min/Max kinds or plain overwrites of a Min/Max-updated "
              "property); convergence is not provable"),
    "SP201": (ERROR,
              "priority=\"delta\" requires a monotone int-valued Min-relax "
              "fixedPoint; this program has none"),
    "SP202": (WARNING,
              "priority=\"delta\" on an unweighted Min relax: every "
              "relaxation lands in the current bucket, so delta-stepping "
              "degenerates to plain sweeps"),
    "SP203": (WARNING,
              "dist_frontier=\"compact\"/\"auto\" needs an iterative "
              "construct (fixedPoint / BFS / while) to carry frontier "
              "views across; this program has none"),
    "SP204": (WARNING,
              "batch_sources set explicitly but the program has no "
              "source-set forall to batch over"),
    "SP205": (WARNING,
              "direction pinned to push/pull but the program has no "
              "direction-switchable neighbor relax or BFS"),
    "SP206": (WARNING,
              "dist_gather_frac >= 0.5 makes the compact exchange "
              "statically degrade to dense (cap never beats the full row)"),
    "SP207": (WARNING,
              "delta_bucket set to a non-default value while "
              "priority=\"none\"; the knob has no effect"),
    "SP208": (WARNING,
              "refresh_threshold_frac set to a non-default value but the "
              "program has no iterative construct to warm-start"),
    "SP209": (ERROR,
              "incremental refresh on a self-gated peeling loop (a while "
              "body plain-writes a property its own visitation filter "
              "reads); the converged state cannot be warm-started soundly "
              "— recompute from scratch"),
    "SP301": (ERROR, "unknown backend"),
    "SP302": (ERROR, "program defines no function with the requested name"),
    "SP303": (ERROR, "no bundled program with the requested name"),
}


def severity_of(code: str) -> str:
    return REGISTRY[code][0]


@dataclass(frozen=True)
class Diagnostic:
    """One analysis finding.  ``line`` is 1-based; 0 means "no position"."""
    code: str
    message: str
    severity: str = ""
    line: int = 0
    source_line: str = ""
    fn: str = ""

    def __post_init__(self):
        if not self.severity:
            object.__setattr__(self, "severity", severity_of(self.code))
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")
        if self.code not in REGISTRY:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")

    def format(self) -> str:
        where = f"line {self.line}: " if self.line else ""
        fn = f"[{self.fn}] " if self.fn else ""
        out = f"{self.code} {self.severity}: {fn}{where}{self.message}"
        if self.source_line:
            out += f"\n    | {self.source_line.strip()}"
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Diagnostic":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def diag(code: str, message: str, *, line: int = 0, fn: str = "",
         src: Optional[str] = None, severity: str = "") -> Diagnostic:
    """Build a Diagnostic, quoting the offending source line from ``src``."""
    return Diagnostic(code=code, message=message, severity=severity,
                      line=line, source_line=quote_line(src, line), fn=fn)


def quote_line(src: Optional[str], line: int) -> str:
    """The 1-based ``line`` of ``src``, or "" when unavailable."""
    if not src or line <= 0:
        return ""
    lines = src.splitlines()
    if line > len(lines):
        return ""
    return lines[line - 1]


class DiagnosticError(ValueError):
    """Raised by the compile gate.  ``.diagnostics`` holds every finding of
    the failing run (errors first); ``str()`` formats them all."""

    def __init__(self, diagnostics: Sequence[Diagnostic], *,
                 header: str = "analysis failed"):
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(sorted(
            diagnostics, key=lambda d: (d.severity != ERROR, d.line, d.code)))
        body = "\n".join(d.format() for d in self.diagnostics)
        super().__init__(f"{header}:\n{body}" if body else header)

    @property
    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]


def entry_error(code: str, message: str) -> DiagnosticError:
    """A single-diagnostic DiagnosticError for SP3xx compile-entry failures.

    The header is the bare message so pre-existing ``pytest.raises(ValueError,
    match=...)`` call sites keep matching on the interesting names."""
    d = Diagnostic(code=code, message=message)
    err = DiagnosticError([d], header=f"{code}: {message}")
    return err


def split(diags: Sequence[Diagnostic]):
    """-> (errors, warnings), each in input order."""
    errs = [d for d in diags if d.severity == ERROR]
    warns = [d for d in diags if d.severity == WARNING]
    return errs, warns
