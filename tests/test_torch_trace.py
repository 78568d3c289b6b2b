"""The port's tracing (`repro_torch.trace`) and the spans it opens
where the work happens: the generated loops' trips and host reads,
the batched engine's three passes, view builds, and the service's waits.
On the CPU, at small sizes; the JAX package is not involved."""
import asyncio
import collections
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch import trace
from repro_torch.core.context import get_context
from repro_torch.graph import preferential_attachment, rmat
from repro_torch.kernels.ell_spmv import ops
from repro_torch.serve import GraphService, QueryKind, ServiceConfig


@pytest.fixture
def traced():
    """Tracing on for one test, with no record before it; off after."""
    trace.clear()
    trace.enable()
    try:
        yield trace
    finally:
        trace.enable(False)
        trace.clear()


@pytest.fixture(scope="module")
def g():
    return rmat(9, 8, seed=3, device="cpu")


def names(recs):
    return collections.Counter(r.name for r in recs)


def test_tracing_off_keeps_no_records_and_returns_the_shared_null_context():
    trace.enable(False)
    trace.clear()
    a, b = trace.span("trip"), trace.span("view", key=1)
    assert a is b and not trace.enabled()
    with a, b:
        pass
    assert trace.records() == [] and trace.dropped() == 0


def test_spans_nest_under_the_innermost_open_span(traced):
    with trace.span("call.p") as outer:
        with trace.span("trip") as mid:
            with trace.span("host_read"):
                pass
        with trace.span("trip"):
            pass
    recs = {r.id: r for r in trace.records()}
    assert [r.name for r in trace.records()] == ["host_read", "trip", "trip", "call.p"]
    assert recs[outer.id].parent == 0 and recs[mid.id].parent == outer.id
    assert [r.parent for r in trace.records()[:3]] == [mid.id, outer.id, outer.id]
    assert all(r.start_ns <= r.end_ns for r in recs.values())
    assert len({r.thread for r in recs.values()}) == 1


def test_a_span_in_a_worker_thread_nests_under_that_threads_spans(traced):
    def work():
        with trace.span("serve.sweep", kind="k", batch=2):
            with trace.span("host_read"):
                return threading.get_ident()

    async def main():
        with trace.span("call.p"):
            return await asyncio.to_thread(work)

    worker = asyncio.run(main())
    recs = {r.name: r for r in trace.records()}
    assert recs["serve.sweep"].parent == 0 and recs["serve.sweep"].thread == worker
    assert recs["host_read"].parent == recs["serve.sweep"].id
    assert recs["call.p"].thread != worker
    assert recs["serve.sweep"].attrs == {"kind": "k", "batch": 2}


def test_records_past_the_cap_are_counted_as_dropped(traced, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    for _ in range(5):
        with trace.span("trip"):
            pass
    assert len(trace.records()) == 3 and trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_a_span_keeps_its_record_and_adds_no_event_under_the_profiler(traced):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("bfs"):
            torch.ones(8).sum()
    (rec,) = trace.records()
    assert rec.name == "bfs"
    names = {ev.name for ev in prof.events()}
    assert "aten::sum" in names
    assert not any("repro_torch" in n or n == "bfs" for n in names)


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_sssp_auto_reads_the_host_twice_a_trip_and_pr_once(backend, g, traced):
    sssp = tc.compile_bundled("sssp", backend=backend).bind(g)
    steps = ops.relax_minplus.push_steps + ops.relax_minplus.pull_steps
    sssp(src=0)
    count = names(trace.records())
    trips = count["trip"]
    assert trips > 1 and count["host_read"] == 2 * trips
    if backend == "cuda":
        assert ops.relax_minplus.push_steps + ops.relax_minplus.pull_steps - steps == trips

    trace.clear()
    pr = tc.compile_bundled("pr", backend=backend).bind(g)
    pr(beta=1e-4, delta=0.85, maxIter=100)
    count = names(trace.records())
    assert count["trip"] > 1 and count["host_read"] == count["trip"]


def test_tracing_changes_no_answer(g, traced):
    sssp = tc.compile_bundled("sssp", backend="cuda").bind(g)
    on = sssp(src=3)["dist"]
    trace.enable(False)
    assert torch.equal(on, sssp(src=3)["dist"])


def test_a_bc_batch_opens_one_bfs_and_one_pass_span_each_under_its_call(g, traced):
    bc = tc.compile_bundled("bc", backend="cuda").bind(g)
    bc(sourceSet=np.arange(8, dtype=np.int32))
    recs = trace.records()
    count = names(recs)
    assert count["bfs"] == count["bfs.forward"] == count["bfs.reverse"] == 1
    (call,) = [r for r in recs if r.name.startswith("call.")]
    assert call.name == "call.Compute_BC"
    passes = [r for r in recs if r.name in ("bfs", "bfs.forward", "bfs.reverse")]
    assert all(r.parent == call.id for r in passes)
    assert [r.name for r in sorted(passes, key=lambda r: r.start_ns)] == \
        ["bfs", "bfs.forward", "bfs.reverse"]
    # the BFS's level reads nest inside it
    bfs = next(r for r in recs if r.name == "bfs")
    assert any(r.name == "host_read" and r.parent == bfs.id for r in recs)


def test_a_view_span_opens_on_a_miss_only(traced):
    g = preferential_attachment(64, m=3, seed=1, device="cpu")
    ctx = get_context(g)
    ctx.sweep_plan()
    ctx.sweep_plan()
    views = [r for r in trace.records() if r.name == "view"]
    assert sorted(r.attrs["key"][0] for r in views) == ["sliced_ell", "sweep_plan"]
    plan = next(r for r in views if r.attrs["key"][0] == "sweep_plan")
    assert next(r for r in views if r.attrs["key"][0] == "sliced_ell").parent == plan.id


class SlowKind(QueryKind):
    program = None

    def __init__(self, name, delay):
        self.name = name
        self.delay = delay

    def make_runner(self, handle, sched, width):
        def run(params_list):
            time.sleep(self.delay)
            return [p["src"] for p in params_list]
        return run


def test_two_lanes_wait_for_the_one_sweep_slot(traced):
    g = preferential_attachment(32, m=2, seed=0, device="cpu")

    async def main():
        async with GraphService(ServiceConfig(max_wait_ms=1.0)) as svc:
            svc.register_kind(SlowKind("a", 0.1))
            svc.register_kind(SlowKind("b", 0.1))
            svc.register_graph("g", g, kinds=["a", "b"])
            out = await asyncio.gather(*(svc.query("g", k, src=s)
                                         for k in ("a", "b") for s in range(3)))
            return out, svc.stats()

    out, st = asyncio.run(main())
    assert out == [0, 1, 2, 0, 1, 2]
    assert st["sweeps"] == 2 and st["mean_batch"] == 3
    sweeps = [r for r in trace.records() if r.name == "serve.sweep"]
    assert sorted(r.attrs["kind"] for r in sweeps) == ["a", "b"]
    assert sum(r.attrs["batch"] for r in sweeps) == 6
    slot = sum(r.attrs["slot_wait_s"] for r in sweeps)
    assert slot > 0.05          # one lane waited out the other's sweep
    assert sum(r.attrs["queue_wait_s"] for r in sweeps) >= slot
    assert all(0.1 <= (r.end_ns - r.start_ns) / 1e9 < 5.0 for r in sweeps)
