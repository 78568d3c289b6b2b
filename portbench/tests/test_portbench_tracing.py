"""The readers of the program's own spans (`portbench/spans.py`, the
metrics that read them, `gaps.py`) and when a run turns the program's
tracing on. On the CPU at small sizes: the device-trace readers find no
kernel here and read nothing, as they must."""
import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, tiny
import portbench
from portbench import gaps, harness, spans
from repro_torch import trace

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["host_reads_per_trip.sssp", "host_reads_per_trip.pr", "idle_ms_per_trip.sssp",
       "idle_ms_per_trip.pr", "bfs_ms_per_source.bc", "forward_ms_per_source.bc",
       "reverse_ms_per_source.bc", "view_build_s", "queue_wait_ms.serve",
       "slot_wait_ms.serve", "sweep_ms.serve", "sweep_idle_share.serve"]
ENTRY = {m["name"]: m for m in M["per_layer"]}
CELLS = ["kron22-bc32", "kron22-sssp", "kron22-service-mix", "kron22-pr"]
# what a CPU run can read: the program's records, and counters that move
# without a card (`ell_sweep.launches` counts launches on the card only)
ON_CPU = {"kron22-bc32": {"view_build_s"},
          "kron22-sssp": {"view_build_s", "host_reads_per_trip.sssp"},
          "kron22-service-mix": {"view_build_s", "queue_wait_ms.serve",
                                 "slot_wait_ms.serve", "sweep_ms.serve"},
          "kron22-pr": {"view_build_s"}}
RUN_PY = str(ROOT / "portbench" / "run.py")


@pytest.fixture
def program_tracing():
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.enable(False)
        trace.clear()


def run_of(name, trace_on):
    spec = tiny(harness.load_cell(ROOT, name))
    if "service" in name:
        spec["workload"]["rate_qps"] = 25.0
    runs = []
    res = harness.run_cell(spec, 2**31 + 11, 0.4, trace_on, "cpu", time.perf_counter(),
                           driver_hook=lambda d: runs.append(d.run))[0]
    return res, runs[0]


def test_the_twelve_metrics_are_declared_once_each_with_a_reader():
    assert set(NEW) <= set(ENTRY) and [m["name"] for m in M["per_layer"]][-12:] == NEW
    for name in NEW:
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()


@pytest.mark.parametrize("argv,on", [
    ([RUN_PY, "--workload", "kron22-pr", "--seed", "3", "--trace", "1"], True),
    ([RUN_PY, "--workload", "kron22-pr", "--seed", "3", "--trace=1"], True),
    ([RUN_PY, "--workload", "kron22-pr", "--seed", "3", "--trace", "0"], False),
    ([RUN_PY, "--workload", "kron22-pr", "--seed", "3"], False),
    (["pytest", "--trace", "1"], False),
    ([], False),
])
def test_only_a_traced_run_of_run_py_turns_program_tracing_on(argv, on):
    assert portbench.traced_run(argv) is on


def test_a_run_without_trace_leaves_no_program_records():
    trace.enable(False)
    trace.clear()
    res, _ = run_of("kron22-sssp", False)
    assert res["correct"] and trace.records() == []


@pytest.mark.parametrize("name", CELLS)
def test_the_new_readers_read_in_their_cells_only(name, program_tracing):
    res, run = run_of(name, True)
    assert res["correct"]
    got = {k for k in res["metrics"] if k in NEW}
    assert got == ON_CPU[name], got
    for metric in NEW:
        value = harness.load_module(ROOT / "portbench" / "metrics" / f"{metric}.py").read(run)
        if name not in ENTRY[metric]["workloads"]:
            assert value is None, metric
    m = res["metrics"]
    assert m["view_build_s"]["value"] > 0
    if name == "kron22-sssp":
        assert m["host_reads_per_trip.sssp"]["value"] == 2.0
    if name == "kron22-service-mix":
        assert m["queue_wait_ms.serve"]["value"] >= 0 and m["sweep_ms.serve"]["value"] > 0
        assert m["slot_wait_ms.serve"]["value"] >= 0


# ---- the readers' view of a profiler trace, on a synthetic one -------------

MAIN = threading.main_thread().ident


def event(name, start, end, cuda=False, id=0):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU, id=id)


def synthetic():
    """One call of the benchmark: kernels at [0, 10] (launched inside the
    program's `bfs` span) and [30, 40] (inside `trip`), the host reading
    a value in between, and an annotation of the benchmark's span on the
    device, which is no work. Its trace starts where `perf_counter_ns`
    reads 0, so a record's nanoseconds are the trace's microseconds
    times 1e3."""
    evs = [event("portbench.call", 0, 50, id=1),
           event("aten::item", 15, 25, id=2),
           event("aten::_local_scalar_dense", 16, 24, id=3),
           # an op's id may equal a runtime call's: they are counted apart
           event("aten::add", 1, 2, id=900), event("cudaLaunchKernel", 1, 1.5, id=900),
           event("aten::mul", 28, 29, id=6), event("cudaLaunchKernel", 28, 28.5, id=901),
           event("k1", 0, 10, cuda=True, id=900),
           event("k2", 30, 40, cuda=True, id=901),
           event("portbench.call", 0, 50, cuda=True, id=8)]
    kineto = SimpleNamespace(trace_start_ns=lambda: time.time_ns() - time.perf_counter_ns())
    return SimpleNamespace(events=lambda: evs, profiler=SimpleNamespace(kineto_results=kineto))


def record(name, id, start_us, end_us, thread=MAIN):
    return trace.Record(name, id, 0, thread, int(start_us * 1e3), int(end_us * 1e3), {})


RECORDS = [record("call.F", 1, 0.5, 45), record("bfs", 2, 0.8, 12), record("trip", 3, 13, 44),
           record("host_read", 4, 15.5, 24.5),
           # a worker thread's span launches nothing the readers give it
           record("serve.sweep", 5, 5, 35, thread=MAIN + 1),
           record("serve.sweep", 6, 45, 60, thread=MAIN + 1)]      # past the trace


def test_records_on_the_profilers_clock_split_device_time_and_name_a_gap_in_three_parts():
    prof = synthetic()
    t = spans.Traced(prof.events(), RECORDS, lambda ns: ns / 1e3)
    assert t.busy == [[0, 10], [30, 40]]
    idle, length, count = t.idle("trip")
    assert (idle, length, count) == (21, 31, 1)
    assert t.launched_in("bfs") == 10 and t.launched_in("trip") == 10
    assert t.launched_in("call.F") == 20 and t.launched_in("bfs.reverse") is None
    assert t.spans["serve.sweep"] == [(5.0, 35.0, False)]
    assert t.idle("serve.sweep") == (20.0, 30.0, 1) and t.launched_in("serve.sweep") is None
    named = gaps.name_idle(prof, RECORDS)
    (gap,) = named["gaps"]
    assert gap[0] == "portbench.call / host_read / aten::_local_scalar_dense"
    assert gap[1] == pytest.approx(20e-6)
    assert named["idle_by_span"] == pytest.approx({"portbench.call / host_read": 20e-6})
    assert named["clock"]["host_reads"] == 1
    clock = gaps.clock_check(prof, t)
    assert clock["held_share"] == 1.0 and clock["end_lag_us_median"] == pytest.approx(0.5)
    # the program adds no event to the trace, so the harness's busy time
    # is the kernels' alone
    assert harness.reduce_trace(prof, 1.0)["busy_s"] == pytest.approx(20e-6)


def test_a_record_lands_on_the_profilers_clock_around_its_op(program_tracing):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("bfs"):
            torch.ones(8).sum()
    to_us = spans.profiler_clock(prof)
    (rec,) = trace.records()
    (op,) = [ev for ev in prof.events() if ev.name == "aten::sum"]
    # within 20 µs: the two clocks are read apart
    assert to_us(rec.start_ns) - 20 <= op.time_range.start
    assert op.time_range.end <= to_us(rec.end_ns) + 20


def test_the_device_readers_read_nothing_without_a_kernel(program_tracing):
    with trace.span("trip"):
        pass
    run = SimpleNamespace(_traced_raw=(synthetic_without_kernels(), 1.0, 1))
    assert spans.traced(run) is None
    assert spans.idle_ms_per_span(run, "trip") is None


def synthetic_without_kernels():
    prof = synthetic()
    evs = [ev for ev in prof.events() if ev.name.startswith(("portbench.", "aten::"))
           and ev.device_type != torch.autograd.DeviceType.CUDA]
    return SimpleNamespace(events=lambda: evs, profiler=prof.profiler)


@pytest.mark.gpu
def test_a_card_gives_each_kernel_to_the_span_that_launched_it(card, program_tracing):
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("trip"):
            (x * 2).sum().item()
        torch.cuda.synchronize()
    evs = prof.events()
    assert not any(ev.name.startswith("repro_torch") for ev in evs)
    t = spans.Traced(evs, trace.records(), spans.profiler_clock(prof))
    assert t.busy and t.launched_in("trip") > 0
