"""The port's GraphService against the reference's: mirrors
tests/test_serve.py with `asyncio.run` (no plugin). The same graphs (built
with `repro.graph`, carried over with `from_arrays`) and the same query
mix go through both services; sssp/bfs answers must be equal, bc at the
reference's atol 1e-3, ppr at rtol 1e-4 / atol 1e-5 (the reference's
batch-engine tolerance). Sweeps run in worker threads as in production."""
import asyncio
import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest

import repro.graph as rg
import repro.serve as rs
import repro_torch.core as tc
import repro_torch.graph as tg
from repro.graph.algorithms_ref import bc_ref, ppr_matrix_ref, sssp_ref
from repro_torch.autotune import TuningRecord, TuningStore, schedule_to_dict, source_digest
from repro_torch.schedule import Schedule
from repro_torch.serve import (GraphPool, GraphService, QueryKind, ServiceConfig,
                               ServiceError, ServiceOverloaded, ServiceTimeout,
                               UnknownGraph, UnknownQueryKind)


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


@pytest.fixture(scope="module")
def pair_a():
    g = rg.preferential_attachment(300, m=4, seed=3)
    return g, carry(g)


@pytest.fixture(scope="module")
def pair_b():
    g = rg.preferential_attachment(200, m=3, seed=5)
    return g, carry(g)


class SlowKind(QueryKind):
    name = "slow"
    per_source = True
    program = None

    def __init__(self, delay=0.25):
        self.delay = delay

    def make_runner(self, handle, sched, width):
        def run(params_list):
            time.sleep(self.delay)
            return [np.int32(p["src"]) for p in params_list]
        return run


class FailKind(QueryKind):
    name = "fail"
    per_source = True
    program = None

    def make_runner(self, handle, sched, width):
        def run(params_list):
            raise ValueError("kaboom")
        return run


# --- the same traffic through both services ---------------------------------------

MIX = [("a", "sssp", s) for s in (0, 5, 9, 17, 42)] + \
      [("b", "sssp", s) for s in (0, 5, 9)] + \
      [("a", "bfs", s) for s in (0, 5, 9, 17)] + \
      [("b", "ppr", s) for s in (0, 7, 23)] + \
      [("a", "ppr", s) for s in (3,)]
BC_SET = np.array([0, 3, 7], np.int32)


def serve_mix(service_cls, cfg, graphs):
    async def main():
        async with service_cls(cfg) as svc:
            for name, g in graphs.items():
                svc.register_graph(name, g)
            jobs = [svc.query(gname, kind, src=s) for gname, kind, s in MIX]
            jobs.append(svc.query("b", "bc", sourceSet=BC_SET))
            return await asyncio.gather(*jobs), svc.stats()
    return asyncio.run(main())


@pytest.mark.parametrize("backend,ref_backend", [("local", "local"), ("cuda", "pallas")])
def test_answers_equal_the_reference_service(backend, ref_backend, pair_a, pair_b):
    want, _ = serve_mix(rs.GraphService, rs.ServiceConfig(backend=ref_backend, max_wait_ms=10.0),
                        {"a": pair_a[0], "b": pair_b[0]})
    got, st = serve_mix(GraphService, ServiceConfig(backend=backend, max_wait_ms=10.0),
                        {"a": pair_a[1], "b": pair_b[1]})
    for (gname, kind, s), w, x in zip(MIX, want, got):
        assert isinstance(x, np.ndarray) and x.shape == np.asarray(w).shape
        if kind == "ppr":
            np.testing.assert_allclose(x, np.asarray(w), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{gname} {kind} {s}")
        else:
            assert x.dtype == np.asarray(w).dtype and np.array_equal(x, np.asarray(w)), \
                (gname, kind, s)
    np.testing.assert_allclose(got[-1], np.asarray(want[-1]), atol=1e-3)
    np.testing.assert_allclose(got[-1], bc_ref(pair_b[0], BC_SET.tolist()), atol=1e-3)
    assert st["served"] == len(MIX) + 1 and st["sweeps"] < st["served"]
    assert st["max_batch"] > 1 and st["rejected"] == 0 and st["timeouts"] == 0


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_delta_schedule_serves_the_same_distances(backend, pair_a):
    g, tgr = pair_a
    sched = Schedule(priority="delta", delta_bucket=8, batch_sources=4)

    async def main():
        async with GraphService(ServiceConfig(backend=backend, schedule=sched,
                                              max_wait_ms=20.0)) as svc:
            svc.register_graph("a", tgr, kinds=["sssp"])
            res = await asyncio.gather(*(svc.query("a", "sssp", src=s) for s in range(6)))
            lone = await svc.query("a", "sssp", src=11)
            return res + [lone], svc.stats()

    res, st = asyncio.run(main())
    for s, out in zip(list(range(6)) + [11], res):
        assert np.array_equal(out, sssp_ref(g, s).astype(np.int32)), s
    assert st["max_batch"] > 1


def test_lone_query_flushes_at_deadline_not_full_lane(pair_a):
    g, tgr = pair_a

    async def main():
        cfg = ServiceConfig(max_wait_ms=5.0, schedule=Schedule(batch_sources=64))
        async with GraphService(cfg) as svc:
            svc.register_graph("a", tgr)
            out = await svc.query("a", "sssp", src=3)
            assert np.array_equal(out, sssp_ref(g, 3).astype(np.int32))
            return svc.stats()

    st = asyncio.run(main())
    assert st["sweeps"] == 1 and st["mean_batch"] == 1.0


def test_coalescing_packs_concurrent_queries(pair_a):
    g, tgr = pair_a

    async def main():
        cfg = ServiceConfig(schedule=Schedule(batch_sources=8), max_wait_ms=20.0)
        async with GraphService(cfg) as svc:
            svc.register_graph("a", tgr, kinds=["sssp"])
            res = await asyncio.gather(*(svc.query("a", "sssp", src=s % 11) for s in range(16)))
            for s, out in zip(range(16), res):
                assert np.array_equal(out, sssp_ref(g, s % 11).astype(np.int32))
            return svc.stats()

    st = asyncio.run(main())
    assert st["served"] == 16 and st["sweeps"] <= 8 and st["max_batch"] >= 2


def test_coalesce_false_serves_one_query_per_sweep(pair_a):
    async def main():
        cfg = ServiceConfig(coalesce=False, schedule=Schedule(batch_sources=8))
        async with GraphService(cfg) as svc:
            svc.register_graph("a", pair_a[1], kinds=["sssp"])
            await asyncio.gather(*(svc.query("a", "sssp", src=s) for s in range(6)))
            return svc.stats()

    st = asyncio.run(main())
    assert st["sweeps"] == st["served"] == 6 and st["max_batch"] == 1


@pytest.mark.parametrize("srcs", [[0, 7, 23, 42], [5]])
def test_ppr_kind_matches_oracle(srcs, pair_a):
    """Concurrent PPR queries pack into one `rt.ppr_multi` sweep; a lone
    one takes the compiled singleton-set path."""
    g, tgr = pair_a

    async def main():
        cfg = ServiceConfig(schedule=Schedule(batch_sources=4), max_wait_ms=20.0)
        async with GraphService(cfg) as svc:
            svc.register_graph("a", tgr, kinds=["ppr"])
            return await asyncio.gather(*(svc.query("a", "ppr", src=s) for s in srcs)), \
                svc.stats()

    res, st = asyncio.run(main())
    for row, out in zip(ppr_matrix_ref(g, srcs), res):
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, row, rtol=1e-4, atol=1e-5)
    assert st["max_batch"] == len(srcs)


def test_zero_wait_lone_request_flushes_immediately(pair_a):
    g, tgr = pair_a

    async def main():
        cfg = ServiceConfig(max_wait_ms=0.0, schedule=Schedule(batch_sources=64))
        async with GraphService(cfg) as svc:
            svc.register_graph("a", tgr, kinds=["sssp"])
            out = await svc.query("a", "sssp", src=2)
            assert np.array_equal(out, sssp_ref(g, 2).astype(np.int32))
            return svc.stats()

    st = asyncio.run(main())
    assert st["served"] == 1 and st["mean_batch"] == 1.0


# --- admission control, timeouts, failure scatter ------------------------------------

def test_admission_sheds_load_beyond_max_pending(pair_a):
    async def main():
        svc = GraphService(ServiceConfig(max_pending=2, max_wait_ms=0.0))
        svc.register_kind(SlowKind(delay=0.3))
        svc.register_graph("a", pair_a[1], kinds=["slow"])
        async with svc:
            t1 = asyncio.create_task(svc.query("a", "slow", src=1))
            t2 = asyncio.create_task(svc.query("a", "slow", src=2))
            await asyncio.sleep(0.05)
            with pytest.raises(ServiceOverloaded):
                await svc.query("a", "slow", src=3)
            assert svc.stats()["rejected"] == 1
            assert [int(await t) for t in (t1, t2)] == [1, 2]
            assert int(await svc.query("a", "slow", src=4)) == 4

    asyncio.run(main())


def test_request_timeout_raises_and_service_recovers(pair_a):
    async def main():
        svc = GraphService(ServiceConfig(max_wait_ms=0.0))
        svc.register_kind(SlowKind(delay=0.4))
        svc.register_graph("a", pair_a[1], kinds=["slow"])
        async with svc:
            with pytest.raises(ServiceTimeout):
                await svc.query("a", "slow", src=1, timeout=0.05)
            assert svc.stats()["timeouts"] == 1
            assert int(await svc.query("a", "slow", src=2)) == 2

    asyncio.run(main())


def test_sweep_failure_scatters_to_waiters_only(pair_a):
    g, tgr = pair_a

    async def main():
        svc = GraphService(ServiceConfig())
        svc.register_kind(FailKind())
        svc.register_graph("a", tgr, kinds=["fail", "sssp"])
        async with svc:
            with pytest.raises(ServiceError, match="kaboom"):
                await svc.query("a", "fail", src=0)
            out = await svc.query("a", "sssp", src=0)
            assert np.array_equal(out, sssp_ref(g, 0).astype(np.int32))

    asyncio.run(main())


def test_unknown_graph_and_kind_errors(pair_a):
    async def main():
        async with GraphService() as svc:
            svc.register_graph("a", pair_a[1], kinds=["sssp"])
            with pytest.raises(UnknownGraph, match="nope"):
                await svc.query("nope", "sssp", src=0)
            with pytest.raises(UnknownQueryKind, match="bc"):
                await svc.query("a", "bc", sourceSet=np.array([0]))
            with pytest.raises(ValueError, match="src"):
                await svc.query("a", "sssp", source=3)

    asyncio.run(main())


@pytest.mark.parametrize("bad,match", [
    (dict(backend="pallas"), "backend"),
    (dict(backend="distributed"), "backend"),
    (dict(max_wait_ms=-1.0), "max_wait_ms"),
    (dict(max_pending=0), "max_pending"),
    (dict(default_timeout_s=0.0), "default_timeout_s"),
    (dict(max_concurrent_sweeps=0), "max_concurrent_sweeps"),
    (dict(view_budget_bytes=0), "view_budget_bytes"),
])
def test_service_config_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        ServiceConfig(**bad)


def test_register_graph_rejects_duplicates_and_unknown_kind(pair_a):
    svc = GraphService()
    svc.register_graph("a", pair_a[1], kinds=["sssp"])
    with pytest.raises(ValueError, match="already registered"):
        svc.register_graph("a", pair_a[1])
    with pytest.raises(UnknownQueryKind, match="katz"):
        svc.register_graph("b", pair_a[1], kinds=["katz"])
    assert "b" not in svc.graphs()


# --- the pool: accounting, LRU eviction, pinning ------------------------------------

def fresh(n, m, seed):
    return tg.preferential_attachment(n, m=m, seed=seed, device="cpu")


def test_context_view_accounting_and_selective_drop():
    g = fresh(150, 3, 7)
    ctx = tc.get_context(g)
    ctx.fingerprint()
    ctx.stats()
    assert ctx.total_view_nbytes() == 0
    view = ctx.ell()
    plan = ctx.sweep_plan(Schedule())
    nb = ctx.view_nbytes()
    assert nb[("ell", False)] >= view.cols.numel() * 4
    assert nb[("sweep_plan", True, Schedule().layout_key())] > 0
    freed = ctx.drop_derived_views()
    assert freed == sum(nb.values()) and ctx.total_view_nbytes() == 0
    assert ("fingerprint",) in ctx.view_keys() and ("stats",) in ctx.view_keys()
    assert ctx.ell() is not view and ctx.sweep_plan(Schedule()) is not plan
    assert ctx.drop_view(("ell", False)) and not ctx.drop_view(("ell", False))


def test_pool_lru_eviction_frees_views_weakref_observed():
    g1, g2 = fresh(150, 3, 1), fresh(150, 3, 2)
    pool = GraphPool(view_budget_bytes=1)
    ctx1, ctx2 = pool.add("one", g1), pool.add("two", g2)
    wref = weakref.ref(ctx1.ell())
    ctx2.ell()
    pool.get("two")
    with pool.pin("two"):
        assert pool.enforce_budget() == ["one"]
    gc.collect()
    assert wref() is None
    assert ctx1.total_view_nbytes() == 0 and ctx2.total_view_nbytes() > 0


def test_pool_never_evicts_pinned_graph():
    pool = GraphPool(view_budget_bytes=1)
    ctx = pool.add("g", fresh(100, 3, 4))
    ctx.ell()
    with pool.pin("g"):
        assert pool.enforce_budget() == []
        assert ctx.total_view_nbytes() > 0
    assert pool.enforce_budget() == ["g"]


def test_eviction_then_query_transparently_reprepares(pair_a, pair_b):
    async def main():
        cfg = ServiceConfig(backend="cuda", view_budget_bytes=1)
        async with GraphService(cfg) as svc:
            svc.register_graph("a", pair_a[1], kinds=["sssp"])
            svc.register_graph("b", pair_b[1], kinds=["sssp"])
            wref = weakref.ref(svc.handle("a").ctx.sliced_ell(Schedule(), reverse=True))
            for name, (g, _) in (("a", pair_a), ("b", pair_b), ("a", pair_a)):
                out = await svc.query(name, "sssp", src=1)
                assert np.array_equal(out, sssp_ref(g, 1).astype(np.int32))
            return wref, svc.stats()

    wref, st = asyncio.run(main())
    assert st["evictions"]
    gc.collect()
    assert wref() is None


# --- tuning store warm-reload ---------------------------------------------------------

def record(digest, fingerprint, schedule, backend, fn_name="Compute_SSSP"):
    return TuningRecord(
        source_digest=digest, backend=backend, graph_fingerprint=fingerprint,
        fn_name=fn_name, schedule=schedule_to_dict(schedule), best_ms=1.0,
        default_ms=2.0, trials=[], budget=1, seed=0)


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_service_warm_reloads_tuned_schedule(tmp_path, pair_a, backend):
    g, tgr = pair_a
    tuned = Schedule(direction="pull", batch_sources=4)
    path = str(tmp_path / "t.json")
    store = TuningStore(path)
    digest = source_digest(tc.load_program_source("sssp"))
    fp = tc.get_context(tgr).fingerprint()
    store.put(record(digest, fp, tuned, backend))
    other = "cuda" if backend == "local" else "local"
    store.put(record(source_digest(tc.load_program_source("ppr")), fp,
                     Schedule(batch_sources=8), other))
    # a record whose schedule the analysis gate rejects is not reloaded
    store.put(record(source_digest(tc.load_program_source("bc")), fp,
                     Schedule(priority="delta"), backend, fn_name="Compute_BC"))
    store.save()

    async def main():
        async with GraphService(ServiceConfig(backend=backend), tune_store=path) as svc:
            h = svc.register_graph("a", tgr, kinds=["sssp", "bfs", "ppr", "bc"])
            assert h.tuned == ["sssp"]
            assert h.schedules["sssp"] == tuned
            assert h.schedules["bfs"] == h.schedules["ppr"] == h.schedules["bc"] == Schedule()
            out = await svc.query("a", "sssp", src=5)
            assert np.array_equal(out, sssp_ref(g, 5).astype(np.int32))

    asyncio.run(main())


# --- write batches through the service ---------------------------------------------

@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_update_after_eviction_reprepares_and_answers(backend, pair_a, pair_b):
    g_a = carry(pair_a[0])       # a private copy: the update swaps it out

    async def main():
        cfg = ServiceConfig(backend=backend, view_budget_bytes=1)
        async with GraphService(cfg) as svc:
            svc.register_graph("a", g_a, kinds=["sssp"])
            svc.register_graph("b", pair_b[1], kinds=["sssp"])
            delta = await svc.update_graph(
                "a", adds=[(1, 7), (3, 11)], weights=[2, 2],
                dels=[(int(g_a.edge_src[0]), int(g_a.indices[0]))])
            assert svc.handle("a").graph is delta.graph
            out = await svc.query("a", "sssp", src=1)
            return delta, out, svc.stats()

    delta, out, st = asyncio.run(main())
    rdelta = pair_a[0].update(adds=[(1, 7), (3, 11)], weights=[2, 2],
                              dels=[(int(g_a.edge_src[0]), int(g_a.indices[0]))])
    assert np.array_equal(out, sssp_ref(rdelta.graph, 1).astype(np.int32))
    assert st["updates"] == 1


class BlockingKind(QueryKind):
    """Sweep blocks until released; reports the graph version it ran on."""

    name = "block"
    per_source = True
    program = None

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def make_runner(self, handle, sched, width):
        g = handle.graph

        def run(params_list):
            self.entered.set()
            self.release.wait(10)
            return [np.int32(g.version) for _ in params_list]

        return run


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_update_defers_until_pinned_sweep_unpins(backend, pair_a):
    g_a = carry(pair_a[0])

    async def main():
        kind = BlockingKind()
        async with GraphService(ServiceConfig(backend=backend, max_wait_ms=0.0)) as svc:
            svc.register_kind(kind)
            svc.register_graph("a", g_a, kinds=["block", "sssp"])
            q = asyncio.create_task(svc.query("a", "block", src=0))
            await asyncio.to_thread(kind.entered.wait, 10)
            upd = asyncio.create_task(svc.update_graph("a", adds=[(0, 1)], weights=[2]))
            await asyncio.sleep(0.05)
            assert not upd.done() and svc.handle("a").graph.version == 0
            kind.release.set()
            assert int(await q) == 0
            delta = await upd
            assert delta.graph.version == 1 and svc.handle("a").graph is delta.graph
            # the cuda program was re-bound to the patched view's fresh plan
            if backend == "cuda":
                keys = tc.get_context(delta.graph).view_keys()
                assert ("sweep_plan", True, Schedule().layout_key()) in keys
            return delta, await svc.query("a", "sssp", src=0)

    delta, out = asyncio.run(main())
    rdelta = pair_a[0].update(adds=[(0, 1)], weights=[2])
    assert np.array_equal(out, sssp_ref(rdelta.graph, 0).astype(np.int32))
    assert delta.num_added == rdelta.num_added


def test_no_temp_files_left_by_the_store(tmp_path):
    path = str(tmp_path / "s.json")
    store = TuningStore(path)
    store.put(record("a" * 16, "f" * 16, Schedule(), "cuda"))
    store.save()
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


# --- property: interleaved write batches and queries (test_property.py) -------------

def _dijkstra(edges, n, src):
    import heapq
    dist = np.full(n, 2**30, np.int64)
    dist[src] = 0
    adj = {}
    for (u, v), w in edges.items():
        adj.setdefault(u, []).append((v, w))
    pq = [(0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for v, w in adj.get(u, ()):
            if d + w < dist[v]:
                dist[v] = d + w
                heapq.heappush(pq, (d + w, v))
    return dist


def test_service_interleaved_updates_match_oracle():
    """Random interleavings of write batches and queries against a
    GraphService graph, under random schedules (delta-stepping among
    them) and both backends: every answer equals the oracle's replay of
    the edge set at that instant."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @st.composite
    def graphs(draw, max_n=20, max_e=60):
        n = draw(st.integers(2, max_n))
        e = draw(st.integers(1, max_e))
        src = draw(st.lists(st.integers(0, n - 1), min_size=e, max_size=e))
        dst = draw(st.lists(st.integers(0, n - 1), min_size=e, max_size=e))
        w = draw(st.lists(st.integers(1, 50), min_size=e, max_size=e))
        return tg.from_edges(n, np.array(src), np.array(dst), np.array(w),
                             drop_self_loops=True, device="cpu")

    @hyp.settings(max_examples=8, deadline=None)
    @hyp.given(graphs(), st.data())
    def check(g, data):
        n = g.num_nodes
        backend = data.draw(st.sampled_from(["local", "cuda"]))
        sched = data.draw(st.builds(
            Schedule, refresh_threshold_frac=st.sampled_from([0.0, 0.25, 1.0]),
            num_buckets=st.sampled_from([1, 4]), batch_sources=st.sampled_from([0, 2, 32]),
            priority=st.sampled_from(["none", "delta"])))
        vertex = st.integers(0, n - 1)
        ops = data.draw(st.lists(st.one_of(
            st.tuples(st.just("query"), vertex),
            st.tuples(st.just("update"),
                      st.lists(st.tuples(vertex, vertex, st.integers(1, 9)), max_size=4),
                      st.lists(st.tuples(vertex, vertex), max_size=4)),
        ), min_size=1, max_size=6))
        edges = {(int(u), int(v)): int(w) for u, v, w in
                 zip(g.edge_src.tolist(), g.indices.tolist(), g.weights.tolist())}

        async def run():
            async with GraphService(ServiceConfig(backend=backend, max_wait_ms=0.0)) as svc:
                svc.register_graph("g", g, schedule=sched, kinds=["sssp"])
                for op in ops:
                    if op[0] == "query":
                        got = (await svc.query("g", "sssp", src=op[1])).astype(np.int64)
                        assert np.array_equal(got, _dijkstra(edges, n, op[1])), (sched, op)
                    else:
                        _, adds, dels = op
                        for u, v in dels:
                            edges.pop((u, v), None)
                        for u, v, w in adds:
                            edges[(u, v)] = w
                        delta = await svc.update_graph(
                            "g", adds=[(u, v) for u, v, _ in adds] or None,
                            dels=dels or None, weights=[w for _, _, w in adds] or None)
                        assert delta.graph.num_edges == len(edges)

        asyncio.run(run())

    check()
