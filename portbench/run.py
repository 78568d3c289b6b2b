"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload kron22-sssp --seed 7 --seconds 30 --trace 0

prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared with its
limit (also the last lines of standard error). Everything the cell needs is
found by name from `BENCHMARK.json` at the root of the checkout.

Two further modes, which print no result line:

    --control --seed A --seed B ...   the lower-precision control in the
                                      program's place, its readings per seed
    --sweep-rates 4,6,8               a service cell at each offered rate,
                                      whether the service sustained it

The command refuses to run without a CUDA card (exit 2), and fails (exit
3) if the JAX package or JAX is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache of the run stays inside the checkout, at a
# fixed path, so only the first run of a checkout compiles
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sweep-rates", default=None)
    return ap.parse_args(argv)


def card_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness
    spec = harness.load_cell(ROOT, args.workload)
    chips = int(spec["cell"]["chips"])
    have = card_count()
    if have < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), found {have}; "
              "no result", file=sys.stderr)
        return 2
    seconds = args.seconds if args.seconds is not None else spec["manifest"]["run_seconds"]

    if args.control:
        for seed in args.seed:
            readings = harness.run_control(spec, seed, seconds, "cuda")
            print(json.dumps(dict(control=args.workload, seed=seed, readings=readings)),
                  flush=True)
        return 0
    if args.sweep_rates:
        rates = [float(r) for r in args.sweep_rates.split(",")]
        for line in harness.run_sweep(spec, args.seed[0], seconds, rates, "cuda"):
            print(json.dumps(line), flush=True)
        return 0

    result, notes = harness.run_cell(spec, args.seed[0], seconds, bool(args.trace), "cuda",
                                     T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package loaded: {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(dict(notes=notes)), file=sys.stderr)
    print(json.dumps(result), flush=True)
    harness.print_checks(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
