"""The port's `ell_spmv`, its pull sweep and their ops against the JAX
reference.

On the CPU the wrappers run their plain versions; `ell_spmv` is held
against the reference's Pallas kernel in interpret mode on the same numpy
inputs, and the sweep (`ell_sweep_ref` following its `SweepPlan`) against
the reference's sliced pull ops, which run that kernel bucket by bucket.
int32 (min-plus) results must be equal; f32 (plus-times) results agree at
rtol 1e-5 because the sums run in another order. The card's kernel is
checked by tests/test_torch_gpu.py (and by chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro.graph.csr import INF_I32
from repro.kernels.ell_spmv import ops as rops
from repro.kernels.ell_spmv.kernel import ell_spmv as ref_ell_spmv
import repro_torch.core as tcore
from repro_torch.core import runtime as trt
from repro_torch.kernels.ell_spmv import ops as tops
from repro_torch.kernels.ell_spmv import plan as tplan
from repro_torch.kernels.ell_spmv.kernel import ell_spmv, ell_sweep

F32 = dict(rtol=1e-5, atol=1e-6)


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


def operands(n, d, semiring, b=None, seed=0):
    rng = np.random.default_rng(seed + n + d)
    cols = rng.integers(0, n + 1, size=(n, d)).astype(np.int32)
    xshape = (n + 1,) if b is None else (n + 1, b)
    if semiring == "minplus":
        vals = rng.integers(1, 100, size=(n, d)).astype(np.int32)
        x = rng.integers(0, 1000, size=xshape).astype(np.int32)
    else:
        vals = rng.random((n, d)).astype(np.float32)
        x = rng.random(xshape).astype(np.float32)
    return cols, vals, x


def check(got, want, semiring):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if semiring == "minplus":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


# --- the kernel's plain version vs the interpret-mode Pallas kernel ----------

@pytest.mark.parametrize("b", [None, 4])
@pytest.mark.parametrize("n,d,block", [(64, 8, 32), (128, 16, 64), (96, 24, 32)])
@pytest.mark.parametrize("semiring", ["minplus", "plustimes"])
def test_ell_spmv_matches_pallas_kernel(n, d, block, semiring, b):
    cols, vals, x = operands(n, d, semiring, b)
    want = ref_ell_spmv(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                        semiring=semiring, block_rows=block)
    got = ell_spmv(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(x), semiring=semiring, block_rows=block)
    check(got, want, semiring)


@pytest.mark.parametrize("semiring", ["minplus", "plustimes"])
def test_ell_spmm_columns_match_spmv(semiring):
    cols, vals, x = (torch.from_numpy(a) for a in operands(64, 8, semiring, b=5))
    mm = ell_spmv(cols, vals, x, semiring=semiring)
    assert mm.shape == (64, 5)
    for j in range(5):
        mv = ell_spmv(cols, vals, x[:, j].contiguous(), semiring=semiring)
        check(mm[:, j], mv, semiring)


def test_cpu_calls_are_not_kernel_launches():
    before = ell_spmv.launches
    ell_spmv(*(torch.from_numpy(a) for a in operands(16, 8, "minplus")))
    assert ell_spmv.launches == before


@pytest.mark.parametrize("bad,err", [
    (dict(cols=lambda c: c.long()), TypeError),
    (dict(vals=lambda v: v.float()), TypeError),
    (dict(vals=lambda v: v[:, :4]), ValueError),
    (dict(cols=lambda c: c[:, :0], vals=lambda v: v[:, :0]), ValueError),
    (dict(x=lambda x: x[:, None, None]), ValueError),
    (dict(semiring="maxplus"), ValueError),
    (dict(x=lambda x: x[:8]), IndexError),      # columns past the end of x
])
def test_ell_spmv_rejects_what_the_kernel_does_not_take(bad, err):
    cols, vals, x = (torch.from_numpy(a) for a in operands(16, 8, "minplus"))
    cols = bad.get("cols", lambda c: c)(cols)
    vals = bad.get("vals", lambda v: v)(vals)
    x = bad.get("x", lambda x: x)(x)
    with pytest.raises(err):
        ell_spmv(cols, vals, x, semiring=bad.get("semiring", "minplus"))


def test_ell_spmv_raises_on_other_devices():
    cols, vals, x = (torch.from_numpy(a).to("meta") for a in operands(16, 8, "minplus"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ell_spmv(cols, vals, x)


# --- graph-level ops vs the reference's ops -----------------------------------

@pytest.fixture(scope="module")
def g_skewed():
    return rg.preferential_attachment(400, m=5, seed=3)


def dist0(n, src=0):
    d = np.full(n, INF_I32, np.int32)
    d[src] = 0
    return d


@pytest.mark.parametrize("gname", ["g_medium", "g_social", "skewed"])
def test_dense_ops_match_reference(gname, request, g_skewed):
    g = g_skewed if gname == "skewed" else request.getfixturevalue(gname)
    tgr = carry(g)
    rc, rw, rb = rops.prepare_ell(g, reverse=True)
    tc, tw, tb = tops.prepare_ell(tgr, reverse=True)
    assert rb == tb
    assert np.array_equal(np.asarray(rc), tc.numpy())
    assert np.array_equal(np.asarray(rw), tw.numpy())
    d = dist0(g.num_nodes)
    for _ in range(3):   # a few Bellman-Ford sweeps
        want = rops.relax_minplus(rc, rw, jnp.asarray(d), block_rows=rb)
        got = tops.relax_minplus(tc, tw, torch.from_numpy(d), block_rows=tb)
        assert np.array_equal(np.asarray(want), got.numpy())
        d = got.numpy()
    contrib = np.random.default_rng(0).random(g.num_nodes).astype(np.float32)
    want = rops.gather_plustimes(rc, jnp.asarray(contrib), block_rows=rb)
    got = tops.gather_plustimes(tc, torch.from_numpy(contrib), block_rows=tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_sliced_relax_matches_dense_and_reference(g_skewed):
    g, tgr = g_skewed, carry(g_skewed)
    tc, tw, tb = tops.prepare_ell(tgr, reverse=True)
    r_ell = rops.prepare_sliced_ell(g, reverse=True)
    t_ell = tops.prepare_sliced_ell(tgr, reverse=True)
    d = dist0(g.num_nodes)
    for _ in range(3):
        dense = tops.relax_minplus(tc, tw, torch.from_numpy(d), block_rows=tb)
        sliced = tops.relax_minplus(t_ell, torch.from_numpy(d))
        want = rops.relax_minplus(r_ell, jnp.asarray(d))
        assert torch.equal(sliced, dense)
        assert np.array_equal(sliced.numpy(), np.asarray(want))
        d = dense.numpy()


@pytest.mark.parametrize("direction", ["push", "pull", "auto"])
def test_sliced_frontier_relax_push_pull_agree(g_skewed, direction):
    """push == pull bit-identically, and each equals the reference."""
    g, tgr = g_skewed, carry(g_skewed)
    r_ell = rops.prepare_sliced_ell(g, reverse=True)
    t_ell = tops.prepare_sliced_ell(tgr, reverse=True)
    d = dist0(g.num_nodes)
    for _ in range(4):
        fr = d < INF_I32
        td, tf = torch.from_numpy(d), torch.from_numpy(fr)
        push = tops.relax_minplus(t_ell, td, frontier=tf, csr=tgr, threshold_frac=1.0)
        pull = tops.relax_minplus(t_ell, td, frontier=tf, csr=tgr, threshold_frac=0.0)
        got = tops.relax_minplus(t_ell, td, frontier=tf, csr=tgr, direction=direction)
        want = rops.relax_minplus(r_ell, jnp.asarray(d), frontier=jnp.asarray(fr),
                                  csr=g, direction=direction)
        assert torch.equal(push, pull) and torch.equal(got, push)
        assert np.array_equal(got.numpy(), np.asarray(want))
        d = push.numpy()


def test_relax_step_counters(g_skewed):
    tgr = carry(g_skewed)
    ell = tops.prepare_sliced_ell(tgr, reverse=True)
    d = torch.from_numpy(dist0(tgr.num_nodes))
    fr = d == 0
    p0, q0 = tops.relax_minplus.push_steps, tops.relax_minplus.pull_steps
    tops.relax_minplus(ell, d, frontier=fr, csr=tgr)                 # 1 vertex: push
    tops.relax_minplus(ell, d, frontier=fr, csr=tgr, direction="pull")
    assert (tops.relax_minplus.push_steps - p0, tops.relax_minplus.pull_steps - q0) == (1, 1)


def test_sliced_gather_matches_segment_sum_and_reference(g_skewed):
    g, tgr = g_skewed, carry(g_skewed)
    contrib = np.random.default_rng(1).random(g.num_nodes).astype(np.float32)
    got = tops.gather_plustimes(tops.prepare_sliced_ell(tgr, reverse=True),
                                torch.from_numpy(contrib))
    seg = trt.segment_sum(torch.from_numpy(contrib)[tgr.rev_indices],
                          tgr.rev_edge_dst, g.num_nodes)
    want = rops.gather_plustimes(rops.prepare_sliced_ell(g, reverse=True),
                                 jnp.asarray(contrib))
    np.testing.assert_allclose(got.numpy(), seg.numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_hub_tail_ops_match_reference():
    """A star whose hub's in-degree exceeds the widest bucket: the relax and
    the gather go through the COO hub tail."""
    n = 700
    rng = np.random.default_rng(5)
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 300)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(0, n, 300)])
    g = rg.from_edges(n, src, dst, rng.integers(1, 101, len(src)))
    tgr = carry(g)
    t_ell = tops.prepare_sliced_ell(tgr, reverse=True)
    assert t_ell.hub_rows.shape[0] > 0
    d = rng.integers(0, 500, n).astype(np.int32)
    got = tops.relax_minplus(t_ell, torch.from_numpy(d))
    want = rops.relax_minplus(rops.prepare_sliced_ell(g, reverse=True), jnp.asarray(d))
    assert np.array_equal(got.numpy(), np.asarray(want))
    contrib = rng.random(n).astype(np.float32)
    got = tops.gather_plustimes(t_ell, torch.from_numpy(contrib))
    want = rops.gather_plustimes(rops.prepare_sliced_ell(g, reverse=True),
                                 jnp.asarray(contrib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("block_rows", [64, {8: 16, 32: 64, 128: 8, 512: 256}])
def test_block_rows_never_changes_a_result(g_skewed, block_rows):
    tgr = carry(g_skewed)
    ell = tops.prepare_sliced_ell(tgr, reverse=True)
    d = torch.from_numpy(dist0(tgr.num_nodes))
    assert torch.equal(tops.relax_minplus(ell, d, block_rows=block_rows),
                       tops.relax_minplus(ell, d))
    c = torch.from_numpy(np.random.default_rng(3).random(tgr.num_nodes).astype(np.float32))
    assert torch.equal(tops.gather_plustimes(ell, c, block_rows=block_rows),
                       tops.gather_plustimes(ell, c))


@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
def test_batched_sliced_relax_and_gather(g_skewed, direction):
    """The [B, N] forms: each row equals the [N] form, and the batch equals
    the reference's batched op."""
    g, tgr = g_skewed, carry(g_skewed)
    t_ell = tops.prepare_sliced_ell(tgr, reverse=True)
    r_ell = rops.prepare_sliced_ell(g, reverse=True)
    srcs = np.array([0, 9, 399])
    b, n = len(srcs), g.num_nodes
    d = np.full((b, n), INF_I32, np.int32)
    d[np.arange(b), srcs] = 0
    fr = d == 0
    fr[2] = True     # a dense row beside sparse ones: mixed push/pull rows
    for _ in range(3):
        td, tf = torch.from_numpy(d), torch.from_numpy(fr)
        got = tops.relax_minplus(t_ell, td, frontier=tf, csr=tgr, direction=direction)
        want = rops.relax_minplus(r_ell, jnp.asarray(d), frontier=jnp.asarray(fr),
                                  csr=g, direction=direction)
        assert np.array_equal(got.numpy(), np.asarray(want))
        for i in range(b):
            row = tops.relax_minplus(t_ell, td[i], frontier=tf[i], csr=tgr)
            assert torch.equal(got[i], row), f"row {i}"
        fr = (got < td).numpy()
        d = got.numpy()
    contrib = np.random.default_rng(1).random((b, n)).astype(np.float32)
    got = tops.gather_plustimes(t_ell, torch.from_numpy(contrib))
    want = rops.gather_plustimes(r_ell, jnp.asarray(contrib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for i in range(b):
        np.testing.assert_allclose(
            got[i].numpy(),
            tops.gather_plustimes(t_ell, torch.from_numpy(contrib[i])).numpy(), **F32)


# --- the one-launch pull sweep and its plan --------------------------------------

def star_graph():
    """The star of test_hub_tail_ops_match_reference: one hub row of
    in-degree 699 plus random edges."""
    n = 700
    rng = np.random.default_rng(5)
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 300)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(0, n, 300)])
    return rg.from_edges(n, src, dst, rng.integers(1, 101, len(src)))


def two_hub_graph():
    """Hub rows 3 (in-degree 600) and 5 (700), side by side in the hub
    tail at entries 0..599 and 600..1299, plus random edges among the
    vertices >= 10 (many of which keep in-degree 0)."""
    n = 1000
    rng = np.random.default_rng(9)
    src = np.concatenate([np.arange(10, 610), np.arange(10, 710), rng.integers(10, n, 400)])
    dst = np.concatenate([np.full(600, 3), np.full(700, 5), rng.integers(10, 400, 400)])
    return rg.from_edges(n, src, dst, rng.integers(1, 101, len(src)))


def all_hub_graph():
    """Every vertex has in-degree 519 > 512: all rows are hub rows, no bucket."""
    n = 520
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return rg.from_edges(n, src, dst, np.random.default_rng(2).integers(1, 101, len(src)))


SWEEP_GRAPHS = {"star": star_graph, "two_hubs": two_hub_graph, "all_hubs": all_hub_graph,
                "edgeless": lambda: rg.from_edges(6, np.zeros(0, np.int64),
                                                  np.zeros(0, np.int64))}


def sweep_graph(gname, request, g_skewed):
    if gname == "skewed":
        return g_skewed
    if gname in SWEEP_GRAPHS:
        return SWEEP_GRAPHS[gname]()
    return request.getfixturevalue(gname)


def sweep_operands(n, seed):
    """dist with unreached vertices (INF) and a frontier over part of it."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 500, n).astype(np.int32)
    d[rng.random(n) < 0.3] = INF_I32
    fr = (rng.random(n) < 0.5) & (d < INF_I32)
    return d, fr, rng.random(n).astype(np.float32)


@pytest.mark.parametrize("gname", ["g_small", "g_medium", "g_road", "g_social", "skewed",
                                   "star", "two_hubs", "all_hubs", "edgeless"])
def test_pull_sweep_ops_match_reference(gname, request, g_skewed):
    """The [N] sliced relax (pulled, with and without a frontier) and
    gather go through `ell_sweep`; each equals the reference's op."""
    g = sweep_graph(gname, request, g_skewed)
    tgr = carry(g)
    r_ell = rops.prepare_sliced_ell(g, reverse=True)
    t_ell = tops.prepare_sliced_ell(tgr, reverse=True)
    d, fr, contrib = sweep_operands(g.num_nodes, seed=g.num_nodes)
    for _ in range(3):
        td, tf = torch.from_numpy(d), torch.from_numpy(fr)
        got = tops.relax_minplus(t_ell, td, frontier=tf, csr=tgr, direction="pull")
        want = rops.relax_minplus(r_ell, jnp.asarray(d), frontier=jnp.asarray(fr), csr=g,
                                  direction="pull")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
        full = tops.relax_minplus(t_ell, td)
        assert np.array_equal(full.numpy(), np.asarray(rops.relax_minplus(r_ell, jnp.asarray(d))))
        fr = (got < td).numpy()
        d = got.numpy()
    got = tops.gather_plustimes(t_ell, torch.from_numpy(contrib))
    want = rops.gather_plustimes(r_ell, jnp.asarray(contrib))
    assert got.shape == (g.num_nodes,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("chunk", [7, 100, 128, 650, 4096])
def test_sweep_hub_chunks_match_reference(chunk):
    """The hub tail cut into chunks of every kind: at 100 entries row 3
    spans six chunks and row 5 starts on a chunk edge; at 128 and 650 row 5
    starts inside the chunk where row 3 ends (its partial takes the
    chunk's second slot); at 7 both span many chunks; at 4096 both lie in
    one chunk."""
    g = two_hub_graph()
    tgr = carry(g)
    t_ell = tops.prepare_sliced_ell(tgr, reverse=True)
    plan = tplan.build_sweep_plan(t_ell, chunk=chunk)
    assert plan.seg_rows.tolist() == [3, 5] and plan.seg_ptr.tolist() == [0, 600, 1300]
    spans = (plan.span_last_chunk - plan.span_first_slot // 2 + 1).tolist()
    if chunk == 100:
        assert spans == [6, 7] and plan.span_first_slot.tolist() == [0, 12]
    if chunk in (128, 650):
        assert plan.span_first_slot.tolist()[-1] == 2 * (600 // chunk) + 1
    if chunk == 4096:
        assert spans == []
    r_ell = rops.prepare_sliced_ell(g, reverse=True)
    d, fr, contrib = sweep_operands(g.num_nodes, seed=chunk)
    x = torch.where(torch.from_numpy(fr), torch.from_numpy(d), int(INF_I32))
    got = ell_sweep(t_ell, plan, x, semiring="minplus", dist=torch.from_numpy(d))
    want = rops.relax_minplus(r_ell, jnp.asarray(d), frontier=jnp.asarray(fr), csr=g,
                              direction="pull")
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = ell_sweep(t_ell, plan, torch.from_numpy(contrib), semiring="plustimes")
    want = rops.gather_plustimes(r_ell, jnp.asarray(contrib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("gname", ["g_medium", "skewed", "star", "two_hubs", "all_hubs",
                                   "edgeless"])
def test_sweep_plan_covers_every_row_once(gname, request, g_skewed):
    """Segment pointers and rows are the hub tail's runs; every row of the
    graph is in exactly one of: a bucket, a hub segment, the zero rows."""
    g = sweep_graph(gname, request, g_skewed)
    t_ell = tops.prepare_sliced_ell(carry(g), reverse=True)
    plan = tplan.build_sweep_plan(t_ell)
    hub = t_ell.hub_rows.numpy()
    rows, counts = np.unique(hub, return_counts=True)
    assert plan.seg_rows.numpy().tolist() == rows.tolist()
    assert plan.seg_ptr.numpy().tolist() == [0] + np.cumsum(counts).tolist()
    n = g.num_nodes
    owner = np.concatenate([r.numpy()[r.numpy() < n] for r in t_ell.rows]
                           + [rows, plan.zero_rows.numpy()]).astype(np.int64)
    assert np.array_equal(np.sort(owner), np.arange(n))
    in_deg = np.diff(np.asarray(g.rev_indptr))
    assert np.array_equal(plan.zero_rows.numpy(), np.nonzero(in_deg == 0)[0])
    assert plan.num_chunks == -(-len(hub) // plan.chunk)
    nb = [b[4] for b in plan.buckets]
    assert plan.num_blocks == plan.num_chunks + sum(nb) + -(-len(plan.zero_rows) // tplan.THREADS)
    assert [b[2] for b in plan.buckets] == [tplan.lanes_for(int(c.shape[1])) for c in t_ell.cols]


def test_lanes_per_bucket_row():
    assert [tplan.lanes_for(d) for d in (8, 16, 24, 32, 72, 128, 216, 512)] == \
        [2, 4, 8, 8, 32, 32, 32, 32]


def test_sweep_plan_rejects_an_unsorted_hub_tail():
    import dataclasses
    t_ell = tops.prepare_sliced_ell(carry(two_hub_graph()), reverse=True)
    flipped = dataclasses.replace(t_ell, hub_rows=t_ell.hub_rows.flip(0).contiguous())
    with pytest.raises(ValueError, match="sorted"):
        tplan.build_sweep_plan(flipped)


def test_sweep_plan_built_once_per_graph_and_layout(g_skewed, monkeypatch):
    """Two programs bound to one graph share one plan, held by the graph's
    context (so view_nbytes counts it) and found by the ops."""
    builds = []
    real = tplan.build_sweep_plan
    monkeypatch.setattr(tplan, "build_sweep_plan",
                        lambda ell, **kw: builds.append(ell) or real(ell, **kw))
    tgr = carry(g_skewed)
    sched = tcore.Schedule(direction="pull")
    for name in ("sssp", "sssp_pull"):
        tcore.compile_bundled(name, backend="cuda", schedule=sched).bind(tgr)(src=0)
    assert len(builds) == 1
    ctx = tcore.get_context(tgr)
    key = ("sweep_plan", True, sched.layout_key())
    assert key in ctx.view_keys() and ctx.view_nbytes()[key] > 0
    assert ctx.sweep_plan(sched) is tplan.sweep_plan(ctx.sliced_ell(sched))
    assert len(builds) == 1


def test_sweep_cpu_calls_are_not_kernel_launches(g_skewed):
    t_ell = tops.prepare_sliced_ell(carry(g_skewed), reverse=True)
    before = ell_sweep.launches
    tops.gather_plustimes(t_ell, torch.ones(g_skewed.num_nodes))
    assert ell_sweep.launches == before


@pytest.mark.parametrize("bad,err", [
    (dict(x=lambda x: x.float()), TypeError),
    (dict(x=lambda x: x[:-1]), TypeError),
    (dict(dist=lambda d: None), TypeError),
    (dict(dist=lambda d: d.long()), TypeError),
    (dict(semiring="maxplus"), ValueError),
    (dict(plan="other"), ValueError),
    (dict(x=lambda x: x.to("meta"), dist=lambda d: d.to("meta")), ValueError),
])
def test_ell_sweep_rejects_what_the_kernel_does_not_take(g_skewed, bad, err):
    t_ell = tops.prepare_sliced_ell(carry(g_skewed), reverse=True)
    plan = tplan.sweep_plan(t_ell)
    if bad.get("plan") == "other":
        plan = tplan.build_sweep_plan(tops.prepare_sliced_ell(carry(two_hub_graph()),
                                                              reverse=True))
    d = torch.from_numpy(dist0(g_skewed.num_nodes))
    x = bad.get("x", lambda x: x)(d)
    dist = bad.get("dist", lambda d: d)(d)
    with pytest.raises(err):
        ell_sweep(t_ell, plan, x, semiring=bad.get("semiring", "minplus"), dist=dist)


# --- runtime helpers the ops and the generated code share ----------------------

def test_runtime_combines_match_reference(g_medium):
    from repro.core import runtime as rrt
    g, tgr = g_medium, carry(g_medium)
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1000, g.num_edges).astype(np.int32)
    for name in ("segment_min", "segment_max", "segment_sum"):
        want = getattr(rrt, name)(jnp.asarray(vals), g.rev_edge_dst, g.num_nodes)
        got = getattr(trt, name)(torch.from_numpy(vals), tgr.rev_edge_dst, g.num_nodes)
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    cur = rng.integers(0, 1000, g.num_nodes).astype(np.int32)
    for name in ("scatter_min", "scatter_max", "scatter_add"):
        want = getattr(rrt, name)(jnp.asarray(cur), g.indices, jnp.asarray(vals))
        got = getattr(trt, name)(torch.from_numpy(cur), tgr.indices,
                                 torch.from_numpy(vals))
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    hit = rng.random(g.num_edges) < 0.1
    want = rrt.scatter_or(jnp.zeros(g.num_nodes, bool), g.indices, jnp.asarray(hit))
    got = trt.scatter_or(torch.zeros(g.num_nodes, dtype=torch.bool), tgr.indices,
                         torch.from_numpy(hit))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for op in ("+", "*", "&&", "||"):
        for rdt, tdt in ((jnp.int32, torch.int32), (jnp.float32, torch.float32)):
            want = np.asarray(rrt.reduce_identity(op, rdt))
            got = trt.reduce_identity(op, tdt).numpy()
            assert got == want and (op in ("&&", "||") or got.dtype == want.dtype)
    d = dist0(g.num_nodes)
    for _ in range(3):
        fr = d < INF_I32
        want = rrt.relax_minplus_hybrid(g, jnp.asarray(d), jnp.asarray(fr))
        got = trt.relax_minplus_hybrid(tgr, torch.from_numpy(d), torch.from_numpy(fr))
        assert np.array_equal(got.numpy(), np.asarray(want))
        d = got.numpy()
    for k in (0, 1, 6, 7, 50):
        fr = np.zeros(g.num_nodes, bool)
        fr[:k] = True
        assert trt.frontier_should_push(torch.from_numpy(fr), g.num_nodes, 0.0625) \
            == bool(rrt.frontier_should_push(jnp.asarray(fr), g.num_nodes, 0.0625))
