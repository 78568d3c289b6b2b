"""Monotonicity analysis for ``fixedPoint`` loops.

A fixed-point iteration converges when its value lattice is bounded and
every update moves one direction — the classic chaotic-iteration argument.
Concretely we prove, per property updated inside the loop body:

* it is only ever updated through ``Min`` (values only decrease) or only
  ever through ``Max`` (values only increase), and
* no plain assignment or ``+=``-style reduction to the same property can
  push it back the other way.

That proof is the legality precondition for every schedule feature that
reorders work inside the loop: delta-stepping priority buckets, push/pull
direction flips, and the priority-sliced distributed exchange all assume
re-relaxing a vertex later can only tighten its value, never corrupt it.

Two diagnostics originate here:

* **SP151** (error): the convergence property (the ``!modified``-style bool
  the loop tests) is never written in the body — the loop cannot terminate.
* **SP153** (warning): a Min/Max-updated property is also written through a
  conflicting kind or a plain overwrite — convergence is not provable.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .. import ast_nodes as A
from ..semantic import FunctionInfo
from .diagnostics import Diagnostic, diag
from .effects import FixedPointInfo, FixedPointTarget, Region


def conv_prop_of(conv_expr) -> Optional[str]:
    """The convergence property named by a fixedPoint header, mirroring the
    two shapes ``lowering.fixed_point`` accepts: ``!prop`` and
    ``prop == False``."""
    if (isinstance(conv_expr, A.UnaryOp) and conv_expr.op == "!"
            and isinstance(conv_expr.operand, A.Identifier)):
        return conv_expr.operand.name
    if (isinstance(conv_expr, A.BinaryOp) and conv_expr.op == "=="
            and isinstance(conv_expr.left, A.Identifier)
            and isinstance(conv_expr.right, A.Literal)
            and conv_expr.right.value is False):
        return conv_expr.left.name
    return None


def analyze_fixedpoint(
        fp: A.FixedPointStmt, region: Region, info: FunctionInfo,
        src: Optional[str], fn_name: str,
) -> Tuple[FixedPointInfo, List[Diagnostic]]:
    """Classify one fixedPoint loop given its effect region."""
    diags: List[Diagnostic] = []
    conv = conv_prop_of(fp.conv_expr)
    conv_written = False
    if conv is not None:
        pa = region.props.get(conv)
        conv_written = pa is not None and pa.written
        if not conv_written:
            diags.append(diag(
                "SP151",
                f"fixedPoint convergence property {conv!r} is never written "
                f"inside the loop body; the loop can never terminate",
                line=fp.line, fn=fn_name, src=src))

    targets: List[FixedPointTarget] = []
    for prop in sorted(region.props):
        pa = region.props[prop]
        if not pa.minmax:
            continue
        mixed = len(pa.minmax) > 1
        dirty = pa.plain_writes > 0 or bool(pa.reductions)
        monotone = not mixed and not dirty
        kind = "mixed" if mixed else next(iter(pa.minmax))
        if not monotone:
            if mixed:
                why = (f"it is updated through both "
                       f"{' and '.join(sorted(pa.minmax))}")
            else:
                forms = []
                if pa.plain_writes:
                    forms.append("plain assignments")
                if pa.reductions:
                    forms.append("reductions "
                                 + ", ".join(sorted(pa.reductions)))
                why = (f"besides the {kind} update it also receives "
                       f"{' and '.join(forms)}")
            line = min(pa.write_lines) if pa.write_lines else fp.line
            diags.append(diag(
                "SP153",
                f"property {prop!r} is not provably monotone under this "
                f"fixedPoint: {why}; convergence and priority scheduling "
                f"both assume one-directional updates",
                line=line, fn=fn_name, src=src))
        dtype = info.node_props.get(prop, info.edge_props.get(prop, ""))
        targets.append(FixedPointTarget(
            prop=prop, kind=kind, dtype=dtype,
            weighted=pa.minmax_weighted, monotone=monotone, line=fp.line))

    return (FixedPointInfo(line=fp.line, conv_prop=conv,
                           conv_written=conv_written, targets=targets),
            diags)
