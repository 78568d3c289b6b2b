"""The program's own spans (`repro_torch.trace`) in a traced run, for the
metric readers.

The program keeps a record of each span (host clock, `perf_counter_ns`,
the whole run, set-up included) and opens nothing in the profiler. So the
records are read two ways: against the window's start, and moved onto the
clock of the profiler's trace of the window through the wall clock, where
a span's idle time is the part of it in which no kernel ran, and a kernel
belongs to a span of the main thread when the runtime call that launched
it started inside that span. A program without the spans (an older
commit), or a run with its tracing off, keeps no record, and every
function here then returns None.
"""
from __future__ import annotations

import bisect
import threading
import time

from portbench.harness import _merge

# device events that are no work, as the harness's `reduce_trace` has them
NOT_WORK = ("nccl:", "portbench.")


# --------------------------------------------------------------------------
# the program's records
# --------------------------------------------------------------------------

def program_records(run):
    """Every record the program kept in this run, or None where it keeps
    none (no tracing module, tracing off, no record) or dropped some."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    if not trace.enabled() or trace.dropped():
        return None
    return trace.records() or None


def window_start_ns(run):
    """The window's start on the records' clock (`perf_counter_ns`): the
    profiler's start, right before the traffic driver's window opens."""
    t0 = getattr(run, "_trace_t0", None)
    return None if t0 is None else int(t0 * 1e9)


def window_records(run, name: str):
    """The records named `name` whose span started in the window (a
    reader runs before anything after the window), or None."""
    recs, t0 = program_records(run), window_start_ns(run)
    if recs is None or t0 is None:
        return None
    return [r for r in recs if r.name == name and r.start_ns >= t0]


# --------------------------------------------------------------------------
# the records on the profiler's clock
# --------------------------------------------------------------------------

class Traced:
    """The device's kernels of one profiler trace and the program's spans
    that lie inside it, times in microseconds on the profiler's clock.
    `to_us` moves a record's `perf_counter_ns` onto that clock; `main` is
    the thread whose spans launch work (by default the main thread: a
    closed-loop cell calls the program there)."""

    def __init__(self, events, records=(), to_us=None, main=None):
        from torch.autograd import DeviceType
        kernels = []             # (start, end, correlation id)
        calls = {}               # correlation id -> start of the runtime call
        self.end = 0.0
        for ev in events:
            tr = ev.time_range
            self.end = max(self.end, tr.end)
            if ev.device_type == DeviceType.CUDA:
                if not ev.name.startswith(NOT_WORK):
                    kernels.append((tr.start, tr.end, ev.id))
            elif ev.name.startswith("cu"):
                # a runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...)
                # shares its correlation id with the work it put on the device
                calls[ev.id] = tr.start
        self.busy = _merge((s, e) for s, e, _ in kernels)
        self._ends = [e for _, e in self.busy]
        # each kernel with the time of its launch
        self.launched = sorted((calls[c], s, e) for s, e, c in kernels if c in calls)
        main = threading.main_thread().ident if main is None else main
        self.spans: dict = {}    # name -> [(start, end, on the main thread)]
        for r in records:
            s, e = to_us(r.start_ns), to_us(r.end_ns)
            if 0.0 <= s and e <= self.end:
                self.spans.setdefault(r.name, []).append((s, e, r.thread == main))
        for v in self.spans.values():
            v.sort()

    def covered(self, s: float, e: float) -> float:
        """Microseconds of [s, e] in which some kernel ran."""
        out = 0.0
        i = bisect.bisect_right(self._ends, s)
        while i < len(self.busy) and self.busy[i][0] < e:
            out += min(e, self.busy[i][1]) - max(s, self.busy[i][0])
            i += 1
        return out

    def idle(self, name: str):
        """(idle µs, length µs, count) over the spans named `name`, or
        None where there is none."""
        spans = self.spans.get(name)
        if not spans:
            return None
        length = sum(e - s for s, e, _ in spans)
        return length - sum(self.covered(s, e) for s, e, _ in spans), length, len(spans)

    def launched_in(self, name: str):
        """Device microseconds (the union of their run times) of the
        kernels launched inside the main thread's spans named `name` (a
        name whose spans do not nest), or None where there is none."""
        spans = [(s, e) for s, e, main in self.spans.get(name, ()) if main]
        if not spans:
            return None
        starts = [s for s, _ in spans]
        inside = []
        for at, ks, ke in self.launched:
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                inside.append((ks, ke))
        return sum(e - s for s, e in _merge(inside))


def profiler_clock(prof):
    """`perf_counter_ns` → microseconds on the profiler's clock, which
    counts from the trace's start in wall-clock nanoseconds; or None where
    the profiler does not say when its trace started."""
    try:
        start = prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        return None
    offset = time.time_ns() - time.perf_counter_ns()
    return lambda ns: (ns + offset - start) / 1e3


def traced(run):
    """The `Traced` view of the run's profiler trace and the program's
    records (built once a run); or None where the run has no trace, keeps
    no record, or its trace holds no program span or no kernel (a CPU
    run)."""
    if not hasattr(run, "_program_traced"):
        raw = getattr(run, "_traced_raw", None)
        recs = program_records(run)
        to_us = profiler_clock(raw[0]) if raw else None
        t = Traced(raw[0].events(), recs, to_us) if recs and to_us else None
        run._program_traced = t if t is not None and t.spans and t.busy else None
    return run._program_traced


def idle_ms_per_span(run, name: str):
    """Device-idle milliseconds inside a span named `name`, on average."""
    t = traced(run)
    got = t.idle(name) if t is not None else None
    return None if got is None else got[0] / 1e3 / got[2]


def idle_share(run, name: str):
    """Share (%) of the spans named `name` in which the device idled."""
    t = traced(run)
    got = t.idle(name) if t is not None else None
    return None if got is None or got[1] <= 0 else 100.0 * got[0] / got[1]


def launched_ms(run, name: str):
    """Device milliseconds of the kernels launched inside the spans named
    `name`."""
    t = traced(run)
    us = t.launched_in(name) if t is not None else None
    return None if us is None else us / 1e3
