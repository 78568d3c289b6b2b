"""The slice end to end: `sssp`, `sssp_pull` and `pr` compiled by the port
on both torch backends against the reference's `pallas` and `local`
results on the same graphs. int32 outputs must be equal; float outputs
agree at atol 1e-5, the reference's own cross-backend tolerance
(tests/test_backends_agree.py)."""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro_torch.core.analysis import DiagnosticError
from repro_torch.kernels.ell_spmv import ops as tops
from repro_torch.schedule import Schedule


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


PARAMS = {"sssp": dict(src=0), "sssp_pull": dict(src=0),
          "pr": dict(beta=1e-4, delta=0.85, maxIter=60)}


@pytest.fixture(scope="module")
def graphs(g_small, graph_suite):
    out = dict(graph_suite)
    out["small"] = g_small
    out["powerlaw"] = rg.preferential_attachment(600, m=6, seed=11)
    # a hub whose in- and out-degree exceed the widest bucket (512): the
    # relax and the gather go through the COO hub tail
    rng = np.random.default_rng(12)
    n = 700
    src = np.concatenate([np.arange(1, n), np.zeros(n - 1, np.int64), rng.integers(0, n, 600)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n), rng.integers(0, n, 600)])
    out["hub"] = rg.from_edges(n, src, dst, rng.integers(1, 101, len(src)))
    return out


def assert_agree(want, got, what):
    assert set(want) == set(got), what
    for key in want:
        a, b = np.asarray(want[key]), got[key].cpu().numpy()
        assert a.shape == b.shape, f"{what}.{key}"
        if a.dtype.kind == "f":
            assert b.dtype == np.float32, f"{what}.{key}"
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f"{what}.{key}")
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{what}.{key}"


@pytest.mark.parametrize("gname", ["UR", "RD", "SW", "small", "powerlaw", "hub"])
@pytest.mark.parametrize("name", ["sssp", "sssp_pull", "pr"])
def test_port_matches_reference(name, gname, graphs):
    g = graphs[gname]
    params = PARAMS[name]
    tgr = carry(g)
    ref = {b: rc.compile_bundled(name, backend=b)(g, **params)
           for b in ("local", "pallas")}
    for tb in ("local", "cuda"):
        got = tc.compile_bundled(name, backend=tb).bind(tgr)(**params)
        for rb, want in ref.items():
            assert_agree(want, got, f"{name}[{gname}] torch {tb} vs jax {rb}")


@pytest.mark.parametrize("gname", ["powerlaw", "hub"])
@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("name", ["sssp", "sssp_pull"])
def test_pinned_direction_matches_reference(name, direction, gname, graphs):
    g = graphs[gname]
    tgr = carry(g)
    want = rc.compile_bundled(name, backend="pallas",
                              schedule=rc.Schedule(direction=direction))(g, src=3)
    for tb in ("local", "cuda"):
        prog = tc.compile_bundled(name, backend=tb,
                                  schedule=Schedule(direction=direction))
        assert_agree(want, prog.bind(tgr)(src=3), f"{name} {direction} {tb}")


def test_cuda_backend_goes_through_the_kernel_ops(graphs):
    tgr = carry(graphs["powerlaw"])
    p0, q0 = tops.relax_minplus.push_steps, tops.relax_minplus.pull_steps
    tc.compile_bundled("sssp", backend="cuda").bind(tgr)(src=0)
    steps = (tops.relax_minplus.push_steps - p0, tops.relax_minplus.pull_steps - q0)
    assert steps[0] > 0 and steps[1] > 0     # the power-law run switches direction


def test_generated_sources():
    for name in ("sssp", "sssp_pull"):
        src = tc.compile_bundled(name, backend="cuda").source
        assert "kops.relax_minplus(_ell" in src and "jax" not in src
        assert "kops" not in tc.compile_bundled(name, backend="local").source
    src = tc.compile_bundled("pr", backend="cuda").source
    assert "kops.gather_plustimes(_ell" in src
    # the schedule's knobs are literals: same schedule, same source
    s = Schedule(push_threshold_frac=0.25, block_rows=(8, 16, 32, 64))
    a = tc.compile_bundled("sssp", backend="cuda", schedule=s).source
    assert "threshold_frac=0.25" in a and "{8: 8, 32: 16, 128: 32, 512: 64}" in a
    tc.compile_cache_clear()
    assert tc.compile_bundled("sssp", backend="cuda", schedule=s).source == a


def test_compile_and_bind_caches(graphs):
    p1 = tc.compile_bundled("sssp", backend="cuda")
    assert tc.compile_bundled("sssp", backend="cuda") is p1
    assert p1.recompile(p1.schedule) is p1
    assert tc.compile_bundled("sssp", backend="local") is not p1
    assert tc.compile_bundled("sssp", backend="cuda",
                              schedule=Schedule(direction="pull")) is not p1
    tgr = carry(graphs["small"])
    b1 = p1.bind(tgr)
    assert p1.bind(tgr) is b1
    n = tc.bind_cache_size()
    del b1
    import gc
    gc.collect()
    assert tc.bind_cache_size() < n
    # bind warmed the reverse sliced view in the graph's context
    key = ("sliced_ell", True, p1.schedule.layout_key())
    assert key in tc.get_context(tgr).view_keys()
    assert tc.get_context(tgr).view_nbytes()[key] > 0


@pytest.mark.parametrize("name,kw", [
    ("cc", dict(schedule=Schedule(priority="delta"))),
    ("lp", dict(schedule=Schedule(priority="delta", delta_bucket=8))),
    ("sssp", dict(schedule=Schedule(priority="delta"))),
])
@pytest.mark.parametrize("backend", ["local", "cuda"])
def test_later_slices_raise_not_implemented(name, kw, backend, graphs):
    # once the raise of a construct a later slice ports; delta-stepping is
    # ported now (queue 1, item 7), so the same six cases hold the port's
    # delta programs against the reference's `local` and `pallas` under the
    # same schedule (tests/test_torch_schedule.py has the full matrix)
    g = graphs["powerlaw"]
    params = dict(src=0) if name == "sssp" else {}
    rsched = rc.Schedule(priority="delta", delta_bucket=kw["schedule"].delta_bucket)
    got = tc.compile_bundled(name, backend=backend, **kw).bind(carry(g))(**params)
    for rb in ("local", "pallas"):
        want = rc.compile_bundled(name, backend=rb, schedule=rsched)(g, **params)
        assert_agree(want, got, f"{name} delta torch {backend} vs jax {rb}")


def test_refresh_is_not_ported(graphs):
    # once the raise of the unported refresh (queue 1, item 8); now the
    # port's refresh after one write batch equals the reference's refresh
    # and a cold call on the new graph
    g = graphs["small"]
    sched = Schedule(refresh_threshold_frac=1.0)
    rsched = rc.Schedule(refresh_threshold_frac=1.0)
    tgr = carry(g)
    adds, dels = [(0, 9), (3, 17), (5, 40)], [(int(g.edge_src[0]), int(g.indices[0]))]
    rdelta, delta = g.update(adds, dels, weights=[2, 3, 4]), tgr.update(adds, dels, weights=[2, 3, 4])
    for tb, rb in (("local", "local"), ("cuda", "pallas")):
        prog = tc.compile_bundled("sssp", backend=tb, schedule=sched)
        ref = rc.compile_bundled("sssp", backend=rb, schedule=rsched)
        got = prog.bind(delta.graph).refresh(prog.bind(tgr)(src=0), delta, src=0)
        want = ref.bind(rdelta.graph).refresh(ref.bind(g)(src=0), rdelta, src=0)
        assert torch.equal(got["dist"], prog.bind(delta.graph)(src=0)["dist"])
        assert np.array_equal(got["dist"].numpy(), np.asarray(want["dist"])), tb


def test_analysis_gate_and_entry_errors():
    with pytest.raises(DiagnosticError, match="SP301"):
        tc.compile_bundled("sssp", backend="pallas")
    with pytest.raises(DiagnosticError, match="SP303"):
        tc.compile_bundled("nope")
    with pytest.raises(DiagnosticError, match="SP201"):     # delta needs a Min relax
        tc.compile_bundled("pr", backend="cuda", schedule=Schedule(priority="delta"))
    assert tc.bundled_programs() == rc.bundled_programs()


def test_entry_points_default_to_the_card(monkeypatch):
    """No device= means cuda; without a card that raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.from_edges(3, np.array([0, 1]), np.array([1, 2]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.uniform_random(16, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.from_arrays({}, num_nodes=0, num_edges=0, max_out_degree=1,
                       max_in_degree=1)
    g = tg.from_edges(3, np.array([0, 1]), np.array([1, 2]), device="cpu")
    out = tc.compile_bundled("sssp", backend="cuda").bind(g)(src=0)
    assert out["dist"].device == torch.device("cpu")     # runs where the graph is
    assert out["dist"].tolist() == [0, 1, 2]


@pytest.mark.parametrize("gname", ["UR", "RD", "powerlaw"])
def test_context_identity_and_stats_match_reference(gname, graphs):
    g = graphs[gname]
    tgr = carry(g)
    rctx, tctx = rc.get_context(g), tc.get_context(tgr)
    assert tctx.fingerprint() == rctx.fingerprint()
    assert tctx.stats() == rctx.stats()
    assert tc.get_context(tgr) is tctx


def test_prepare_warms_what_bind_needs(graphs):
    tgr = carry(graphs["SW"])
    sched = Schedule(num_buckets=2, min_width=16)
    ctx = tc.prepare(tgr, sched, backend="cuda")
    assert ("sliced_ell", True, sched.layout_key()) in ctx.view_keys()
    prog = tc.compile_bundled("pr", backend="cuda", schedule=Schedule(min_width=32))
    tc.prepare(tgr, program=prog)
    assert ("sliced_ell", True, prog.schedule.layout_key()) in ctx.view_keys()
    assert tc.prepare(tgr, backend="local") is ctx
    with pytest.raises(ValueError, match="unknown backend"):
        tc.prepare(tgr, backend="pallas")
