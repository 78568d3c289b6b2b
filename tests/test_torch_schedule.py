"""The Schedule surface of the port against the reference's: mirrors
tests/test_schedule_api.py for the single-device backends and the
delta-stepping rows of tests/test_backends_agree.py. Every graph is built
once with `repro.graph` and carried over with `from_arrays`; int32
outputs must be equal (delta-stepping reorders the relaxation, never its
fixed point), bc at the reference's rtol 1e-4 / atol 1e-4."""
import gc
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.runtime as rrt
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.core.runtime as trt
import repro_torch.graph as tg
from repro.graph.algorithms_ref import sssp_ref
from repro_torch.core.analysis import DiagnosticError
from repro_torch.schedule import Schedule


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


@pytest.fixture(scope="module")
def graphs(graph_suite):
    ref = {"RD": graph_suite["RD"], "UR": graph_suite["UR"],
           "powerlaw": rg.preferential_attachment(400, m=5, seed=3),
           "grid": rg.road(24, seed=7)}
    return {k: (g, carry(g)) for k, g in ref.items()}


@pytest.fixture()
def engine_guard():
    """Snapshot/restore the deprecated ENGINE shim around mutation tests."""
    saved = tg.ENGINE.snapshot()
    yield
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for k in ("num_buckets", "min_width", "growth",
                  "push_threshold_frac", "batch_sources"):
            setattr(tg.ENGINE, k, getattr(saved, k))


def same(want, got, what):
    for key in want:
        a, b = np.asarray(want[key]), got[key].cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what}.{key}"


# --- delta-stepping against the reference -------------------------------------

PARAMS = {"sssp": dict(src=0), "cc": {}, "lp": {}}


@pytest.mark.parametrize("delta", [1, 8, 64])
@pytest.mark.parametrize("name", ["sssp", "cc", "lp"])
def test_delta_matches_reference(name, delta, graphs):
    """Port `local` and `cuda` (its CPU path) under priority="delta"
    against reference `local` and `pallas` under the same schedule; the
    road graph takes the compact `_dell` relax, the power-law graph its
    dense fallback (delta_ell is None past the blowup)."""
    kw = PARAMS[name]
    for gname in ("RD", "powerlaw"):
        g, tgr = graphs[gname]
        ref = {b: rc.compile_bundled(name, backend=b, schedule=rc.Schedule(
            priority="delta", delta_bucket=delta))(g, **kw) for b in ("local", "pallas")}
        for tb in ("local", "cuda"):
            prog = tc.compile_bundled(name, backend=tb, schedule=Schedule(
                priority="delta", delta_bucket=delta))
            got = prog.bind(tgr)(**kw)
            for rb, want in ref.items():
                same(want, got, f"{name}[{gname}] delta={delta} torch {tb} vs jax {rb}")


@pytest.mark.parametrize("delta", [1, 64, 100000])
@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
def test_sssp_delta_matches_oracle(direction, delta, graphs):
    g, tgr = graphs["grid"]
    want = sssp_ref(g, 0).astype(np.int32)
    sched = Schedule(priority="delta", delta_bucket=delta, direction=direction)
    for tb in ("local", "cuda"):
        out = tc.compile_bundled("sssp", backend=tb, schedule=sched).bind(tgr)(src=0)
        assert np.array_equal(out["dist"].numpy(), want), tb


@pytest.mark.parametrize("name", ["sssp", "sssp_pull", "cc"])
def test_delta_schedule_powerlaw_agrees_with_monotonic(name, graphs):
    _, tgr = graphs["powerlaw"]
    params = dict(src=0) if name.startswith("sssp") else {}
    for tb in ("local", "cuda"):
        base = tc.compile_bundled(name, backend=tb).bind(tgr)(**params)
        out = tc.compile_bundled(name, backend=tb, schedule=Schedule(
            priority="delta", delta_bucket=120)).bind(tgr)(**params)
        for key in base:
            assert torch.equal(out[key], base[key]), f"{name}.{key} {tb}"


def test_cuda_delta_goes_through_the_kernel_op_and_local_through_dell(graphs):
    sched = Schedule(priority="delta", delta_bucket=16)
    cuda = tc.compile_bundled("sssp", backend="cuda", schedule=sched)
    local = tc.compile_bundled("sssp", backend="local", schedule=sched)
    assert "kops.relax_minplus(_ell" in cuda.source and "_dell" not in cuda.source
    assert "rt.relax_minplus_delta(g, dist" in local.source
    assert "def Compute_SSSP(g, _dell=None" in local.source
    # the bound local program warms the compact relax's view
    _, tgr = graphs["RD"]
    local.bind(tgr)
    assert ("delta_ell",) in tc.get_context(tgr).view_keys()
    # the reference's pallas source takes the same route
    ref = rc.compile_bundled("sssp", backend="pallas",
                             schedule=rc.Schedule(priority="delta", delta_bucket=16))
    assert "kops.relax_minplus(_ell" in ref.source and "_dell" not in ref.source


@pytest.mark.parametrize("gname", ["RD", "powerlaw"])
def test_delta_ell_matches_reference_and_is_none_past_the_blowup(gname, graphs):
    g, tgr = graphs[gname]
    want = rc.get_context(g).delta_ell()
    got = tc.get_context(tgr).delta_ell()
    if want is None:
        assert got is None
    else:
        assert np.array_equal(got.cols.numpy(), np.asarray(want.cols))
        assert np.array_equal(got.wts.numpy(), np.asarray(want.wts))


def test_delta_ell_is_none_on_a_star():
    n = 600
    g = tg.from_edges(n, np.zeros(n - 1, np.int64), np.arange(1, n), device="cpu")
    assert tc.get_context(g).delta_ell() is None
    assert tc.get_context(g).DELTA_ELL_MAX_BLOWUP == rc.get_context(
        rg.from_edges(3, [0], [1])).DELTA_ELL_MAX_BLOWUP


@pytest.mark.parametrize("delta", [1, 8, 64])
@pytest.mark.parametrize("gname", ["powerlaw", "UR"])
def test_sssp_multi_delta_matches_reference(gname, delta, graphs):
    g, tgr = graphs[gname]
    srcs = np.arange(0, g.num_nodes, max(g.num_nodes // 7, 1), np.int32)
    want = np.asarray(rrt.sssp_multi(g, jnp.asarray(srcs), priority="delta",
                                     delta_bucket=delta))
    got = trt.sssp_multi(tgr, srcs, priority="delta", delta_bucket=delta)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, trt.sssp_multi(tgr, srcs))


def test_relax_minplus_delta_compact_and_dense_agree(graphs):
    g, tgr = graphs["RD"]
    ell = tc.get_context(tgr).delta_ell()
    rng = np.random.default_rng(0)
    dist = torch.from_numpy(rng.integers(0, 500, g.num_nodes).astype(np.int32))
    for k in (3, 40):
        fr = torch.zeros(g.num_nodes, dtype=torch.bool)
        fr[torch.from_numpy(rng.choice(g.num_nodes, k, replace=False))] = True
        want = np.asarray(rrt.relax_minplus_delta(
            g, jnp.asarray(dist.numpy()), jnp.asarray(fr.numpy()),
            rc.get_context(g).delta_ell(), 16))
        for weighted in (True, False):
            compact = trt.relax_minplus_delta(tgr, dist, fr, ell, 16, weighted=weighted)
            dense = trt.relax_minplus_hybrid(tgr, dist, fr, weighted=weighted)
            assert torch.equal(compact, dense), (k, weighted)
        assert np.array_equal(trt.relax_minplus_delta(tgr, dist, fr, ell, 16).numpy(), want)


def test_bc_under_delta_schedule_rejected_at_compile_time():
    sched = Schedule(priority="delta", delta_bucket=64, batch_sources=4)
    with pytest.raises(DiagnosticError) as ei:
        tc.compile_bundled("bc", backend="local", schedule=sched)
    assert "SP201" in ei.value.codes


def test_delta_schedules_differ_in_source_only_by_knobs():
    for tb in ("local", "cuda"):
        a = tc.compile_bundled("sssp", backend=tb, schedule=Schedule(
            priority="delta", delta_bucket=41)).source
        b = tc.compile_bundled("sssp", backend=tb, schedule=Schedule(
            priority="delta", delta_bucket=73)).source
        assert a != b and a.replace("41", "73") == b
        mono = tc.compile_bundled("sssp", backend=tb).source
        assert "_bk" in a and "_bk" not in mono


# --- compile cache, literals, coexistence ---------------------------------------

@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_compile_cache_returns_same_object(backend):
    assert tc.compile_bundled("sssp", backend=backend) is \
        tc.compile_bundled("sssp", backend=backend)


def test_compile_cache_keys_on_schedule_and_backend():
    base = tc.compile_bundled("sssp", backend="local")
    assert tc.compile_bundled("sssp", backend="cuda") is not base
    assert tc.compile_bundled("sssp", backend="local",
                              schedule=Schedule(direction="pull")) is not base
    assert tc.compile_bundled("sssp", backend="local",
                              schedule=Schedule(priority="delta")) is not base


@pytest.mark.parametrize("schedule", [Schedule(), Schedule(priority="delta")])
@pytest.mark.parametrize("name", ["bc", "sssp"])
def test_same_schedule_byte_identical_source(name, schedule):
    if name == "bc" and schedule.priority == "delta":
        schedule = Schedule(batch_sources=4)
    for backend in ("local", "cuda"):
        tc.compile_cache_clear()
        a = tc.compile_bundled(name, backend=backend, schedule=schedule)
        tc.compile_cache_clear()
        b = tc.compile_bundled(name, backend=backend, schedule=schedule)
        assert a is not b and a.source == b.source


def test_two_schedules_coexist_and_agree(graphs):
    g, tgr = graphs["powerlaw"]
    want = sssp_ref(g, 0).astype(np.int32)
    progs = {d: tc.compile_bundled("sssp", backend="local",
                                   schedule=Schedule(direction=d))
             for d in ("auto", "push", "pull")}
    assert len({id(p) for p in progs.values()}) == 3
    assert len({p.source for p in progs.values()}) == 3
    for d, p in progs.items():
        assert np.array_equal(p.bind(tgr)(src=0)["dist"].numpy(), want), d


def test_two_layouts_coexist_on_one_graph(graphs):
    g, tgr = graphs["powerlaw"]
    want = sssp_ref(g, 0).astype(np.int32)
    s1, s2 = Schedule(), Schedule(min_width=16, num_buckets=3)
    for s in (s1, s2):
        out = tc.compile_bundled("sssp", backend="cuda", schedule=s).bind(tgr)(src=0)
        assert np.array_equal(out["dist"].numpy(), want)
    ctx = tc.get_context(tgr)
    v1, v2 = ctx.sliced_ell(s1), ctx.sliced_ell(s2)
    assert v1 is not v2 and v1.widths != v2.widths
    assert ctx.sliced_ell(s1) is v1


def test_batch_width_is_per_program(graphs):
    _, tgr = graphs["powerlaw"]
    srcs = np.array([0, 7, 19, 31, 44], np.int32)
    seq = tc.compile_bundled("bc", backend="local", schedule=Schedule(batch_sources=0))
    bat = tc.compile_bundled("bc", backend="local", schedule=Schedule(batch_sources=4))
    assert "rt.bfs_levels_batch" in bat.source
    assert "rt.bfs_levels_batch" not in seq.source
    torch.testing.assert_close(bat.bind(tgr)(sourceSet=srcs)["BC"],
                               seq.bind(tgr)(sourceSet=srcs)["BC"], rtol=1e-4, atol=1e-4)


# --- the deprecated ENGINE shim ---------------------------------------------------

def test_engine_mutation_after_compile_is_inert(graphs, engine_guard):
    """The schedule is snapshotted at compile time: later ENGINE mutation
    changes neither the compiled source nor its results, but a NEW
    default-schedule compile snapshots the mutated shim — as in the
    reference."""
    _, tgr = graphs["powerlaw"]
    for backend in ("local", "cuda"):
        prog = tc.compile_bundled("sssp", backend=backend)
        before = prog.bind(tgr)(src=0)["dist"]
        src_before = prog.source
        with pytest.warns(DeprecationWarning):
            tg.ENGINE.push_threshold_frac = 1.0
        assert prog.source == src_before
        assert torch.equal(prog.bind(tgr)(src=0)["dist"], before)
        fresh = tc.compile_bundled("sssp", backend=backend)
        assert fresh is not prog
        assert "1.0" in fresh.source and "0.0625" not in fresh.source
        assert torch.equal(fresh.bind(tgr)(src=0)["dist"], before)
        with pytest.warns(DeprecationWarning):
            tg.ENGINE.push_threshold_frac = Schedule().push_threshold_frac
    with pytest.warns(DeprecationWarning):
        tg.ENGINE.num_buckets = 2
    assert tg.resolve_schedule(None) == Schedule(num_buckets=2)


def test_engine_shim_validates_before_committing(engine_guard):
    with pytest.raises(ValueError, match="growth"):
        tg.ENGINE.growth = 1
    assert tg.ENGINE.growth != 1
    with pytest.raises(AttributeError, match="no knob"):
        tg.ENGINE.bucket_count = 3


def test_engine_shim_snapshot_is_default_schedule():
    assert tg.ENGINE.snapshot() == Schedule()
    assert tg.resolve_schedule(None) == Schedule()
    with pytest.raises(TypeError, match="Schedule"):
        tg.resolve_schedule(rc.Schedule())


# --- Schedule validation ------------------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    (dict(num_buckets=0), "num_buckets"),
    (dict(min_width=0), "min_width"),
    (dict(min_width=7), "multiple of 8"),
    (dict(growth=1), "growth"),
    (dict(push_threshold_frac=1.5), "push_threshold_frac"),
    (dict(push_threshold_frac=-0.1), "push_threshold_frac"),
    (dict(batch_sources=-1), "batch_sources"),
    (dict(direction="sideways"), "direction"),
    (dict(dist_frontier="sparse"), "dist_frontier"),
    (dict(dist_gather_frac=1.5), "dist_gather_frac"),
    (dict(dist_gather_frac=-0.1), "dist_gather_frac"),
    (dict(priority="fifo"), "priority"),
    (dict(delta_bucket=0), "delta_bucket"),
    (dict(delta_bucket=-8), "delta_bucket"),
    (dict(refresh_threshold_frac=1.5), "refresh_threshold_frac"),
])
def test_schedule_validation_is_actionable(bad, match):
    with pytest.raises(ValueError, match=match):
        Schedule(**bad)
    with pytest.raises(ValueError, match=match):     # the reference agrees
        rc.Schedule(**bad)


def test_schedule_is_hashable_and_normalized():
    assert Schedule(push_threshold_frac=0) == Schedule(push_threshold_frac=0.0)
    assert hash(Schedule()) == hash(Schedule())
    assert Schedule().bucket_widths() == (8, 32, 128, 512)
    npsched = Schedule(batch_sources=np.int32(8), min_width=np.int64(16),
                       push_threshold_frac=np.float32(0.25))
    assert npsched == Schedule(batch_sources=8, min_width=16, push_threshold_frac=0.25)
    assert type(npsched.batch_sources) is int
    with pytest.raises(ValueError, match="integer"):
        Schedule(batch_sources=True)


def test_unknown_fn_name_and_program_name_the_known_ones():
    with pytest.raises(ValueError, match="Compute_SSSP"):
        tc.compile_program(tc.load_program_source("sssp"), fn_name="nope")
    with pytest.raises(ValueError, match="sssp_pull"):
        tc.load_program_source("dijkstra")


# --- bind and prepare -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_bind_uniform_across_backends(backend, graphs):
    g, tgr = graphs["powerlaw"]
    bound = tc.compile_bundled("sssp", backend=backend).bind(tgr)
    for s in (0, 7):
        assert np.array_equal(bound(src=s)["dist"].numpy(), sssp_ref(g, s).astype(np.int32))


def test_bind_is_memoized_per_program_and_graph(graphs):
    _, tgr = graphs["powerlaw"]
    tc.bind_cache_clear()
    local = tc.compile_bundled("sssp", backend="local")
    cuda = tc.compile_bundled("sssp", backend="cuda")
    bound = local.bind(tgr)
    assert local.bind(tgr) is bound
    other = cuda.bind(tgr)
    assert other is not bound and cuda.bind(tgr) is other
    assert tc.bind_cache_size() == 2
    del bound
    gc.collect()
    assert tc.bind_cache_size() == 1


def test_prepare_warms_the_views_bind_reuses(graphs):
    _, tgr = graphs["powerlaw"]
    sched = Schedule(min_width=24, num_buckets=2)
    ctx = tc.prepare(tgr, sched, backend="cuda")
    assert ctx is tc.get_context(tgr)
    view = ctx.sliced_ell(sched)
    tc.compile_bundled("sssp", backend="cuda", schedule=sched).bind(tgr)
    assert ctx.sliced_ell(sched) is view
    with pytest.raises(ValueError, match="backend"):
        tc.prepare(tgr, backend="pallas")
