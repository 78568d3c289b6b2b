"""``python -m repro_torch.analyze`` — the analysis layer as a standalone tool.

PyTorch port's counterpart of `repro.core.analysis.cli`; its ``--backend``
choices are the port's (``cuda`` in place of the reference's ``pallas``).

Targets are ``.sp`` file paths or bundled program names; ``--bundled`` adds
every bundled program, ``--scan-py`` extracts inline triple-quoted DSL
sources from a Python file (the examples embed their programs that way).
``--schedule k=v`` knobs and ``--backend`` feed the legality check;
``--strict`` promotes warnings to errors for the exit code; ``--json``
emits the machine-readable form (diagnostics + effect summaries).

Exit status: 0 clean, 1 when any target has an error (or, under
``--strict``, any warning); 2 for a frontend failure (parse/semantic).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
from typing import List, Optional, Tuple

from ...schedule import Schedule
from ..lexer import LexError
from ..parser import ParseError
from ..semantic import SemanticError
from . import check_schedule, program_analysis
from .diagnostics import ERROR, WARNING

_SRC_RE = re.compile(r'"""(.*?)"""', re.DOTALL)


def _bundled_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "programs")


def _bundled_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(_bundled_dir())
                  if f.endswith(".sp"))


def _load_target(t: str) -> Tuple[str, str]:
    """-> (display name, source)."""
    if os.path.exists(t):
        with open(t) as f:
            return t, f.read()
    path = os.path.join(_bundled_dir(), f"{t}.sp")
    if os.path.exists(path):
        with open(path) as f:
            return t, f.read()
    raise FileNotFoundError(
        f"no such file or bundled program: {t!r} "
        f"(bundled: {', '.join(_bundled_names())})")


def _scan_py(path: str) -> List[Tuple[str, str]]:
    """Inline DSL sources embedded as triple-quoted strings in a .py file."""
    with open(path) as f:
        text = f.read()
    out = []
    for i, m in enumerate(_SRC_RE.finditer(text)):
        body = m.group(1)
        if "function " in body and "{" in body:
            out.append((f"{path}#inline{i}", body))
    return out


def _parse_schedule(pairs: List[str]) -> Schedule:
    types = {f.name: f.type for f in dataclasses.fields(Schedule)}
    kwargs = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--schedule expects k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        if k not in types:
            raise SystemExit(
                f"unknown schedule knob {k!r}; knobs: {', '.join(sorted(types))}")
        ty = str(types[k])
        if "int" in ty:
            kwargs[k] = int(v)
        elif "float" in ty:
            kwargs[k] = float(v)
        else:
            kwargs[k] = v
    return Schedule(**kwargs)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="compile-time effect & schedule-legality analysis")
    ap.add_argument("targets", nargs="*",
                    help=".sp files or bundled program names")
    ap.add_argument("--bundled", action="store_true",
                    help="analyze every bundled program")
    ap.add_argument("--scan-py", action="append", default=[],
                    metavar="FILE.py",
                    help="also analyze inline triple-quoted DSL sources")
    ap.add_argument("--schedule", action="append", default=[], metavar="K=V",
                    help="schedule knob for the legality check (repeatable)")
    ap.add_argument("--backend", default="local",
                    choices=["local", "cuda", "distributed"])
    ap.add_argument("--strict", action="store_true",
                    help="warnings fail the exit code too")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    sched = _parse_schedule(args.schedule)
    work: List[Tuple[str, str]] = []
    for t in args.targets:
        work.append(_load_target(t))
    if args.bundled:
        for name in _bundled_names():
            work.append(_load_target(name))
    for py in args.scan_py:
        work.extend(_scan_py(py))
    if not work:
        ap.error("nothing to analyze (give targets, --bundled, or --scan-py)")

    report = []
    n_err = n_warn = 0
    for name, source in work:
        try:
            pa = program_analysis(source)
        except (LexError, ParseError, SemanticError) as e:
            print(f"{name}: frontend error: {e}", file=sys.stderr)
            return 2
        diags = []
        for fn_name, fx in sorted(pa.functions.items()):
            diags.extend(fx.diagnostics)
            diags.extend(check_schedule(fx, sched, args.backend))
        n_err += sum(1 for d in diags if d.severity == ERROR)
        n_warn += sum(1 for d in diags if d.severity == WARNING)
        report.append({
            "target": name,
            "diagnostics": [d.to_dict() for d in diags],
            "functions": pa.summary(),
        })
        if not args.as_json:
            status = ("ok" if not diags else
                      f"{sum(1 for d in diags if d.severity == ERROR)} "
                      f"error(s), "
                      f"{sum(1 for d in diags if d.severity == WARNING)} "
                      f"warning(s)")
            print(f"== {name}: {status}")
            for d in diags:
                print(f"  {d.format()}")

    if args.as_json:
        print(json.dumps({"schedule": dataclasses.asdict(sched),
                          "backend": args.backend,
                          "strict": args.strict,
                          "targets": report}, indent=2, sort_keys=True))
    else:
        print(f"-- {len(work)} target(s): {n_err} error(s), "
              f"{n_warn} warning(s)")
    if n_err or (args.strict and n_warn):
        return 1
    return 0
