"""One traced run of a cell, with the device's idle time named by the
program's own spans.

    python3 portbench/gaps.py --workload kron22-sssp --seed 7 --seconds 51

runs the cell as `run.py --trace 1` does (program tracing on from the
start) and prints its result line, then one JSON line: `gaps`, the ten
longest idle gaps of the traced window, each named `<benchmark span> /
<innermost program span> / <innermost host op>` open at its middle,
`idle_by_span`, every idle gap's seconds summed by `<benchmark span> /
<innermost program span>` at its middle, `clock`, how closely the
program's records sit on the profiler's clock, and `window`, the end-to-end
metrics of the traced window (under the profiler, so not comparable with
an untraced run's). Needs a CUDA card (exit 2 without one).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


class Innermost:
    """The shortest of a set of host ranges that holds a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [s for s, _, _ in self.ranges]
        # the longest range so far bounds how far back a holder can start
        self.reach = []
        longest = 0.0
        for s, e, _ in self.ranges:
            longest = max(longest, e - s)
            self.reach.append(longest)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        best, best_len = "none", None
        while i >= 0 and t - self.starts[i] <= self.reach[i]:
            s, e, name = self.ranges[i]
            if e >= t and (best_len is None or e - s < best_len):
                best, best_len = name, e - s
            i -= 1
        return best


def name_idle(prof, records=()) -> dict:
    """The idle gaps of a profiler trace named by the spans open at their
    middles: the benchmark's, the program's (its `records`, moved onto the
    profiler's clock) and the host op."""
    from torch.autograd import DeviceType

    from portbench import spans
    to_us = spans.profiler_clock(prof)
    t = spans.Traced(prof.events(), records if to_us else (), to_us)
    program = Innermost([(s, e, name) for name, v in t.spans.items() for s, e, _ in v])
    bench, ops = [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            tr = ev.time_range
            (bench if ev.name.startswith("portbench.") else ops).append(
                (tr.start, tr.end, ev.name))
    b, o = Innermost(bench), Innermost(ops)
    gaps = [(t.busy[i + 1][0] - t.busy[i][1], (t.busy[i][1] + t.busy[i + 1][0]) / 2)
            for i in range(len(t.busy) - 1)]
    by_span: dict = {}
    for length, mid in gaps:
        key = f"{b.at(mid)} / {program.at(mid)}"
        by_span[key] = by_span.get(key, 0.0) + length / 1e6
    top = sorted(gaps, reverse=True)[:10]
    return dict(gaps=[[f"{b.at(m)} / {program.at(m)} / {o.at(m)}", n / 1e6] for n, m in top],
                idle_by_span=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
                clock=clock_check(prof, t))


def clock_check(prof, t) -> dict | None:
    """How closely the records sit on the profiler's clock: each `host_read`
    span of the main thread holds one `.item()`, whose op
    (`aten::_local_scalar_dense`) the profiler saw. The share of those
    spans that hold an op's middle, and the median of span end minus the
    nearest op's end, in microseconds (a few, where the clocks agree)."""
    reads = [(s, e) for s, e, main in t.spans.get("host_read", ()) if main]
    items = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.name == "aten::_local_scalar_dense")
    if not reads or not items:
        return None
    mids = [(s + e) / 2 for s, e in items]
    ends = sorted(e for _, e in items)
    held, lags = 0, []
    for s, e in reads:
        i = bisect.bisect_left(mids, s)
        held += i < len(mids) and mids[i] <= e
        j = bisect.bisect_left(ends, e)
        near = min((ends[k] for k in (j - 1, j) if 0 <= k < len(ends)), key=lambda x: abs(e - x))
        lags.append(e - near)
    lags.sort()
    return dict(host_reads=len(reads), held_share=held / len(reads),
                end_lag_us_median=lags[len(lags) // 2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness, spans
    from repro_torch import trace
    if not torch.cuda.is_available():
        print("portbench: gaps.py needs a CUDA card; no result", file=sys.stderr)
        return 2
    trace.enable()
    spec = harness.load_cell(ROOT, args.workload)
    seconds = args.seconds if args.seconds is not None else spec["manifest"]["run_seconds"]
    runs = []
    result, _notes = harness.run_cell(spec, args.seed, seconds, True, "cuda", T_START,
                                      driver_hook=lambda d: runs.append(d.run))
    print(json.dumps(result), flush=True)
    run = runs[0]
    named = name_idle(run._traced_raw[0], spans.program_records(run) or ())
    print(json.dumps(dict(named, window=run.window.get("metrics"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
