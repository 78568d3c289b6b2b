"""The port's benchmark: `BENCHMARK.json` at the root of the checkout and
`portbench/run.py`.

A traced run (`python3 portbench/run.py ... --trace 1`) also turns on the
program's own tracing (`repro_torch.trace`) as this package is first
imported, which `run.py` does once it has read its arguments and before
anything of the cell runs: so the program's records hold the set-up's view
builds and the window's spans. A run with `--trace 0`, any other command
(`harness.run_cell(trace=True)` called elsewhere included: its caller
calls `trace.enable()` itself), and a program without that module (an
older commit) leave the program's tracing off.
"""
import sys
from pathlib import Path


def traced_run(argv) -> bool:
    """Whether `argv` (a `sys.argv`) runs this package's `run.py` with
    `--trace 1`."""
    if not argv or Path(argv[0]).resolve() != Path(__file__).resolve().parent / "run.py":
        return False
    import argparse
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_known_args(argv[1:])[0].trace == 1


if traced_run(sys.argv):
    try:
        from repro_torch import trace as _trace
    except ImportError:
        pass
    else:
        _trace.enable()
