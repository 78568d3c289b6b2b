"""Dynamic graphs in the port against the reference: mirrors
tests/test_dynamic.py. The same write batches (numpy, seeded) go through
`repro.graph` and `repro_torch.graph` on the same graph: the effective
changes, the new graph and the refresh plan must be equal; the patched
views must encode the rebuilt view's edges, with the hub tail sorted by
row where the reference leaves it in append order; `refresh` must equal a
cold call (ints equal, pageRank at the reference's atol 1e-3: warm and
cold runs both stop at diff <= beta)."""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro.graph.algorithms_ref import sssp_ref
from repro_torch.autotune import RECORD_VERSION, TuningRecord, TuningStore, source_digest
from repro_torch.core.analysis import DiagnosticError
from repro_torch.graph import patch_sliced_ell, sliced_ell_edges, to_sliced_ell
from repro_torch.kernels.ell_spmv.plan import build_sweep_plan
from repro_torch.kernels.ell_spmv.ref import ell_sweep_ref
from repro_torch.schedule import Schedule

PARAMS = {
    "sssp": dict(src=0),
    "sssp_pull": dict(src=0),
    "cc": dict(),
    "pr": dict(beta=1e-5, delta=0.85, maxIter=100),
    "lp": dict(),
}
VALUE_KEY = {"sssp": "dist", "sssp_pull": "dist", "cc": "comp",
             "pr": "pageRank", "lp": "label"}

GRAPHS = {
    "powerlaw": lambda: rg.powerlaw_social(150, avg_degree=8, seed=7),
    "grid": lambda: rg.road(9, seed=7),
}


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, version=g.version,
                          device="cpu")


def random_batch(rng, g, k_add=5, k_del=4):
    n = g.num_nodes
    adds = np.stack([rng.integers(0, n, k_add), rng.integers(0, n, k_add)], 1)
    weights = rng.integers(1, 10, k_add)
    idx = rng.choice(g.num_edges, min(k_del, g.num_edges), replace=False)
    dels = np.stack([g.edge_src.cpu().numpy()[idx], g.indices.cpu().numpy()[idx]], 1)
    return adds, dels, weights


def assert_same(name, ref, out):
    key = VALUE_KEY[name]
    a, b = ref[key], out[key]
    if name == "pr":
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)
    else:
        assert torch.equal(a, b)


def hub_sorted(view):
    r = view.hub_rows
    return bool((r[1:] >= r[:-1]).all())


# --- the update against the reference ------------------------------------------

@pytest.mark.parametrize("k_add,k_del", [(5, 4), (40, 0), (0, 30), (60, 60)])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_delta_and_plan_match_reference(gname, k_add, k_del):
    rng = np.random.default_rng(k_add * 100 + k_del)
    g = GRAPHS[gname]()
    tgr = carry(g)
    adds, dels, w = random_batch(rng, tgr, k_add, k_del)
    adds = np.concatenate([adds, adds[:2]]) if k_add else adds   # repeated pairs:
    w = np.concatenate([w, w[:2] + 1]) if k_add else w           # the last write wins
    want = g.update(adds, dels, weights=w)
    got = tgr.update(adds, dels, weights=w)
    for f in ("add_src", "add_dst", "add_wts", "del_src", "del_dst", "del_wts"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in tg.FIELDS:
        assert np.array_equal(getattr(got.graph, f).numpy(),
                              np.asarray(getattr(want.graph, f))), f
    assert (got.graph.version, got.graph.num_edges, got.graph.max_out_degree) == \
        (want.graph.version, want.graph.num_edges, want.graph.max_out_degree)
    pw, pg = want.plan(), got.plan()
    assert np.array_equal(pg.reset, pw.reset) and np.array_equal(pg.seed, pw.seed)
    assert (pg.affected_frac, pg.cone_size) == (pw.affected_frac, pw.cone_size)
    assert tc.get_context(got.graph).fingerprint() == rc.get_context(want.graph).fingerprint()


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("sched", [Schedule(num_buckets=3), Schedule(num_buckets=1, min_width=8),
                                   Schedule(num_buckets=2, min_width=8, growth=2)])
def test_patched_view_matches_rebuilt_and_reference(sched, rev):
    rng = np.random.default_rng(13)
    g = GRAPHS["powerlaw"]()
    tgr = carry(g)
    ref_sched = rc.Schedule(**{k: getattr(sched, k) for k in ("num_buckets", "min_width", "growth")})
    rview = rc.get_context(g).sliced_ell(ref_sched, reverse=rev)
    view = tc.get_context(tgr).sliced_ell(sched, reverse=rev)
    adds, dels, w = random_batch(rng, tgr, k_add=12, k_del=10)
    rdelta, delta = g.update(adds, dels, weights=w), tgr.update(adds, dels, weights=w)
    patched = patch_sliced_ell(view, delta, reverse=rev)
    fresh = to_sliced_ell(delta.graph, reverse=rev, schedule=sched)
    assert sliced_ell_edges(patched) == sliced_ell_edges(fresh)
    assert sliced_ell_edges(patched) == rg.sliced_ell_edges(
        rg.patch_sliced_ell(rview, rdelta, reverse=rev))
    assert hub_sorted(patched)
    assert patched.widths == view.widths
    assert [tuple(c.shape) for c in patched.cols] == [tuple(c.shape) for c in view.cols]
    # update() installed the same patch into the new graph's context
    adopted = tc.get_context(delta.graph).sliced_ell(sched, reverse=rev)
    assert sliced_ell_edges(adopted) == sliced_ell_edges(fresh) and hub_sorted(adopted)


def migrations_batch():
    """The reference's unsorted-tail case: 80 added edges on
    preferential_attachment(300, 4, seed=3) under a two-bucket layout
    (widths 8 and 16), so rows migrate into the hub tail."""
    g = rg.preferential_attachment(300, 4, seed=3)
    rng = np.random.default_rng(5)
    adds = np.stack([rng.integers(0, 300, 80), rng.integers(0, 300, 80)], 1)
    return g, adds, rng.integers(1, 100, 80), Schedule(num_buckets=2, min_width=8, growth=2)


def test_reference_style_unsorted_tail_still_refused_by_the_plan():
    g, adds, w, sched = migrations_batch()
    ref_sched = rc.Schedule(num_buckets=2, min_width=8, growth=2)
    rview = rc.get_context(g).sliced_ell(ref_sched, reverse=True)
    rpatched = rg.patch_sliced_ell(rview, g.update(adds, weights=w), reverse=True)
    hub = np.asarray(rpatched.hub_rows)
    assert (np.diff(hub) < 0).any(), "the reference's tail is in append order"
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32).copy())  # noqa: E731
    carried = tg.SlicedEllGraph(
        cols=tuple(as_t(c) for c in rpatched.cols), wts=tuple(as_t(c) for c in rpatched.wts),
        rows=tuple(as_t(c) for c in rpatched.rows), hub_rows=as_t(rpatched.hub_rows),
        hub_cols=as_t(rpatched.hub_cols), hub_wts=as_t(rpatched.hub_wts),
        num_nodes=rpatched.num_nodes, widths=rpatched.widths)
    with pytest.raises(ValueError, match="hub_rows must be sorted"):
        build_sweep_plan(carried)
    # the port's patch of the same batch is sorted and takes a plan
    tgr = carry(g)
    tc.get_context(tgr).sliced_ell(sched, reverse=True)
    view = tc.get_context(tgr.update(adds, weights=w).graph).sliced_ell(sched, reverse=True)
    assert hub_sorted(view) and sorted(view.hub_rows.tolist()) == sorted(hub.tolist())
    build_sweep_plan(view, chunk=7)


@pytest.mark.parametrize("chunk", [3, 7, 4096])
def test_sweep_on_the_patched_view_equals_the_rebuilt_view(chunk):
    """`ell_sweep_ref` walks the patched view's plan (padding rows inside
    buckets, a sorted tail cut into small chunks so segments span) and
    gives the rebuilt view's answer: min-plus equal, plus-times at rtol
    1e-5 (a hub row's sum may run in another order)."""
    g, adds, w, sched = migrations_batch()
    tgr = carry(g)
    old = tc.get_context(tgr).sliced_ell(sched, reverse=True)
    idx = np.random.default_rng(2).choice(g.num_edges, 60, replace=False)
    dels = np.stack([np.asarray(g.edge_src)[idx], np.asarray(g.indices)[idx]], 1)
    delta = tgr.update(adds, dels, weights=w)
    patched = tc.get_context(delta.graph).sliced_ell(sched, reverse=True)
    fresh = to_sliced_ell(delta.graph, reverse=True, schedule=sched)
    pads = lambda v: sum(int((r == g.num_nodes).sum()) for r in v.rows)  # noqa: E731
    assert pads(patched) > pads(old), "evacuated slots are padding rows mid-bucket"
    assert patched.hub_rows.numel() > old.hub_rows.numel()
    rng = np.random.default_rng(chunk)
    n = g.num_nodes
    dist = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32))
    x = torch.from_numpy(rng.random(n).astype(np.float32))
    pp, pf = build_sweep_plan(patched, chunk=chunk), build_sweep_plan(fresh, chunk=chunk)
    assert torch.equal(ell_sweep_ref(patched, pp, dist, "minplus", dist=dist),
                       ell_sweep_ref(fresh, pf, dist, "minplus", dist=dist))
    torch.testing.assert_close(ell_sweep_ref(patched, pp, x, "plustimes"),
                               ell_sweep_ref(fresh, pf, x, "plustimes"), rtol=1e-5, atol=1e-7)


# --- refresh --------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["local", "cuda"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_refresh_matches_scratch(name, gname, backend):
    """K chained random batches: refresh (forced incremental) == from
    scratch on every version, the refreshed result feeding the next."""
    rng = np.random.default_rng(11)
    g = carry(GRAPHS[gname]())
    prog = tc.compile_bundled(name, backend=backend,
                              schedule=Schedule(refresh_threshold_frac=1.0))
    assert prog.refresh_fn is not None
    prev = prog.bind(g)(**PARAMS[name])
    for _ in range(3):
        adds, dels, w = random_batch(rng, g)
        delta = g.update(adds, dels, weights=w)
        bound = prog.bind(delta.graph)
        scratch = bound(**PARAMS[name])
        refreshed = bound.refresh(prev, delta, **PARAMS[name])
        assert_same(name, scratch, refreshed)
        g, prev = delta.graph, refreshed


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_refresh_matches_the_reference_refresh(backend):
    rng = np.random.default_rng(3)
    g = GRAPHS["powerlaw"]()
    tgr = carry(g)
    ref = rc.compile_bundled("sssp", backend={"local": "local", "cuda": "pallas"}[backend],
                             schedule=rc.Schedule(refresh_threshold_frac=1.0))
    prog = tc.compile_bundled("sssp", backend=backend,
                              schedule=Schedule(refresh_threshold_frac=1.0))
    rprev, prev = ref.bind(g)(src=0), prog.bind(tgr)(src=0)
    adds, dels, w = random_batch(rng, tgr, 8, 8)
    rdelta, delta = g.update(adds, dels, weights=w), tgr.update(adds, dels, weights=w)
    want = ref.bind(rdelta.graph).refresh(rprev, rdelta, src=0)
    got = prog.bind(delta.graph).refresh(prev, delta, src=0)
    assert np.array_equal(got["dist"].numpy(), np.asarray(want["dist"]))
    assert prog.source.count("rt.warm_start(") == ref.source.count("rt.warm_start(")


def test_threshold_zero_falls_back_dense():
    rng = np.random.default_rng(5)
    g = carry(GRAPHS["powerlaw"]())
    prog = tc.compile_bundled("sssp", schedule=Schedule(refresh_threshold_frac=0.0))
    prev = prog.bind(g)(src=0)
    adds, dels, w = random_batch(rng, g)
    delta = g.update(adds, dels, weights=w)
    bound = prog.bind(delta.graph)
    assert delta.plan().affected_frac > 0.0
    assert_same("sssp", bound(src=0), bound.refresh(prev, delta, src=0))


@pytest.mark.parametrize("name", ["tc", "ppr", "bc"])
def test_refresh_without_loop_raises(name):
    bound = tc.compile_bundled(name).bind(carry(GRAPHS["grid"]()))
    assert bound.program.refresh_fn is None
    with pytest.raises(ValueError, match="no incremental refresh"):
        bound.refresh({}, None)


@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_refresh_kcore_rejected_as_self_gated_peeling(backend):
    rng = np.random.default_rng(8)
    g = carry(GRAPHS["grid"]())
    prog = tc.compile_bundled("kcore", backend=backend,
                              schedule=Schedule(refresh_threshold_frac=1.0))
    prev = prog.bind(g)(k=2)
    adds, dels, w = random_batch(rng, g)
    delta = g.update(adds, dels, weights=w)
    with pytest.raises(DiagnosticError) as ei:
        prog.bind(delta.graph).refresh(prev, delta, k=2)
    assert "SP209" in ei.value.codes


def test_refresh_requires_post_update_bind():
    rng = np.random.default_rng(6)
    g = carry(GRAPHS["grid"]())
    prog = tc.compile_bundled("sssp")
    prev = prog.bind(g)(src=0)
    adds, dels, w = random_batch(rng, g)
    delta = g.update(adds, dels, weights=w)
    with pytest.raises(ValueError, match="post-update graph"):
        prog.bind(g).refresh(prev, delta, src=0)


# --- update semantics + edge cases --------------------------------------------------

def test_update_is_immutable_and_versioned():
    g = carry(GRAPHS["grid"]())
    before = g.indices.clone()
    delta = g.update(adds=[(0, 5)], dels=[(0, 1)])
    assert g.version == 0 and delta.graph.version == 1
    assert torch.equal(g.indices, before) and delta.old is g
    assert delta.graph.device == g.device


def test_weight_replace_and_batch_dedup():
    g = tg.from_edges(4, [0, 1], [1, 2], [3, 3], device="cpu")
    delta = g.update(adds=[(0, 1), (0, 1)], weights=[7, 9])
    assert delta.num_added == 1 and delta.num_removed == 1
    assert (int(delta.add_wts[0]), int(delta.del_wts[0])) == (9, 3)
    assert delta.graph.num_edges == 2


def test_delete_absent_edge_is_noop():
    g = tg.from_edges(4, [0, 1], [1, 2], [3, 3], device="cpu")
    delta = g.update(dels=[(2, 3)])
    assert delta.num_added == 0 and delta.num_removed == 0
    assert delta.graph.num_edges == 2 and delta.plan().affected_frac == 0.0


@pytest.mark.parametrize("bad,match", [
    (dict(adds=[(0, 9)]), "adds"), (dict(dels=[(-1, 0)]), "dels"),
    (dict(adds=[(0, 1)], weights=[1, 2]), "weights"),
    (dict(adds=(np.array([0, 1]), np.array([1]))), "differ"),
])
def test_update_rejects_bad_batches(bad, match):
    g = tg.from_edges(4, [0, 1], [1, 2], [3, 3], device="cpu")
    with pytest.raises(ValueError, match=match):
        g.update(**bad)


def test_delete_then_reinsert_same_content_fresh_fingerprint():
    g = carry(GRAPHS["grid"]())
    e = (int(g.edge_src[0]), int(g.indices[0]))
    w = int(g.weights[0])
    d1 = g.update(dels=[e])
    d2 = d1.graph.update(adds=[e], weights=[w])
    g2 = d2.graph
    for arr in ("indptr", "indices", "weights"):
        assert torch.equal(getattr(g, arr), getattr(g2, arr))
    fps = {tc.get_context(x).fingerprint() for x in (g, d1.graph, g2)}
    assert len(fps) == 3, "every version fingerprints distinctly"
    prog = tc.compile_bundled("sssp")
    b_old, b_new = prog.bind(g), prog.bind(g2)
    assert b_old is not b_new and prog.bind(g) is b_old
    store = TuningStore()
    digest = source_digest(tc.load_program_source("sssp"))
    store.put(TuningRecord(
        source_digest=digest, backend="local",
        graph_fingerprint=tc.get_context(g).fingerprint(),
        fn_name="Compute_SSSP", schedule={}, best_ms=1.0, default_ms=1.0,
        trials=[], budget=1, seed=0, version=RECORD_VERSION))
    assert store.lookup(digest, "local", tc.get_context(g).fingerprint()) is not None
    assert store.lookup(digest, "local", tc.get_context(g2).fingerprint()) is None


def test_batch_emptying_a_vertex():
    g = carry(GRAPHS["powerlaw"]())
    sched = Schedule(refresh_threshold_frac=1.0)
    ctx = tc.get_context(g)
    ctx.sliced_ell(sched, reverse=False)
    ctx.sliced_ell(sched, reverse=True)
    out_deg = np.diff(g.indptr.numpy())
    v = int(np.argmax((out_deg > 0) & (out_deg <= 4)))
    s, e = int(g.indptr[v]), int(g.indptr[v + 1])
    dels = np.stack([np.full(e - s, v), g.indices.numpy()[s:e]], 1)
    prog = tc.compile_bundled("sssp", schedule=sched)
    prev = prog.bind(g)(src=0)
    delta = g.update(dels=dels)
    g2 = delta.graph
    assert int(g2.indptr[v + 1] - g2.indptr[v]) == 0
    for rev in (False, True):
        patched = tc.get_context(g2).sliced_ell(sched, reverse=rev)
        assert sliced_ell_edges(patched) == sliced_ell_edges(
            to_sliced_ell(g2, reverse=rev, schedule=sched))
    bound = prog.bind(g2)
    assert_same("sssp", bound(src=0), bound.refresh(prev, delta, src=0))


def test_hub_tail_absorbs_migrations():
    """Under a single narrow bucket the hub tail is populated; updates
    touching a hub and a row that overflows its bucket keep the patched
    view exact and sorted, and the cuda program answers through it."""
    rg_ = GRAPHS["powerlaw"]()
    g = carry(rg_)
    n = g.num_nodes
    sched = Schedule(num_buckets=1, min_width=8, refresh_threshold_frac=1.0)
    view = tc.get_context(g).sliced_ell(sched, reverse=True)
    assert view.hub_rows.numel() > 0
    hub = int(view.hub_rows[0])
    in_deg = np.bincount(g.indices.numpy(), minlength=n)
    small = int(np.argmax((in_deg > 0) & (in_deg <= 8)))
    rng = np.random.default_rng(2)
    adds = [(int(s), small) for s in rng.choice(n, 10, replace=False)] \
        + [(int(rng.integers(0, n)), hub)]
    idx = np.flatnonzero(g.indices.numpy() == hub)[:2]
    dels = np.stack([g.edge_src.numpy()[idx], g.indices.numpy()[idx]], 1)
    prog = tc.compile_bundled("sssp", backend="cuda", schedule=sched)
    prev = prog.bind(g)(src=0)
    delta = g.update(adds, dels, weights=np.arange(1, len(adds) + 1))
    g2 = delta.graph
    patched = tc.get_context(g2).sliced_ell(sched, reverse=True)
    assert sliced_ell_edges(patched) == sliced_ell_edges(
        to_sliced_ell(g2, reverse=True, schedule=sched))
    assert patched.hub_rows.numel() > view.hub_rows.numel() and hub_sorted(patched)
    assert [c.shape for c in patched.cols] == [c.shape for c in view.cols]
    bound = prog.bind(g2)
    assert ("sweep_plan", True, sched.layout_key()) in tc.get_context(g2).view_keys()
    out = bound(src=0)
    assert_same("sssp", out, bound.refresh(prev, delta, src=0))
    rdelta = rg_.update(adds, dels, weights=np.arange(1, len(adds) + 1))
    assert np.array_equal(out["dist"].numpy(), sssp_ref(rdelta.graph, 0).astype(np.int32))


def test_empty_delta_reuses_view():
    g = carry(GRAPHS["grid"]())
    view = tc.get_context(g).sliced_ell(Schedule(), reverse=True)
    delta = g.update()
    assert patch_sliced_ell(view, delta, reverse=True) is view


def test_patched_views_drop_with_the_context_and_carry_no_plan():
    g = carry(GRAPHS["powerlaw"]())
    sched = Schedule()
    ctx = tc.get_context(g)
    ctx.sweep_plan(sched)
    delta = g.update(adds=[(1, 2), (3, 4)])
    new_ctx = tc.get_context(delta.graph)
    assert ("sliced_ell", True, sched.layout_key()) in new_ctx.view_keys()
    assert ("sweep_plan", True, sched.layout_key()) not in new_ctx.view_keys()
    new_ctx.sweep_plan(sched)
    new_ctx.fingerprint()
    assert new_ctx.drop_derived_views() > 0
    assert new_ctx.view_keys() == [("fingerprint",)]
    assert tc.context.contains(delta.graph) and tc.context.registry_size() >= 2


# --- refresh plan semantics ------------------------------------------------------------

def test_plan_insert_only_seeds_sources():
    g = carry(GRAPHS["grid"]())
    delta = g.update(adds=[(3, 40), (10, 60)])
    assert delta.num_removed == 0
    plan = delta.plan()
    assert plan.cone_size == 0
    assert set(np.flatnonzero(plan.seed)) == {3, 10}


def test_plan_delete_cone_is_forward_closure():
    g = tg.from_edges(5, [0, 1, 2], [1, 2, 3], [1, 1, 1], device="cpu")
    plan = g.update(dels=[(0, 1)]).plan()
    assert set(np.flatnonzero(plan.reset)) == {1, 2, 3}
    assert plan.cone_size == 3
