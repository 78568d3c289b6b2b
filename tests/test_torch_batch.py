"""The port's batched multi-source engine and triangle pieces
(`repro_torch.core.runtime`) against the reference's
(`repro.core.runtime`) on the same graphs, built once with `repro.graph`
and carried over with `from_arrays`. Mirrors tests/test_batch_engine.py:
integer outputs equal, PPR at the reference's rtol 1e-4 / atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.runtime as rrt
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.core.runtime as trt
import repro_torch.graph as tg
from repro.graph.csr import INF_I32


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    src = np.array([0, 1, 2, 8, 9, 10])
    dst = np.array([1, 2, 3, 9, 10, 11])
    ref = {"powerlaw": rg.preferential_attachment(500, m=5, seed=7),
           "disconnected": rg.from_edges(16, src, dst, np.ones(6, np.int64),
                                         undirected=True),
           "UR": rg.uniform_random(100, 5, seed=2)}
    return {k: (g, carry(g)) for k, g in ref.items()}


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# --- batched combines -----------------------------------------------------------

@pytest.mark.parametrize("op", ["segment_sum_batch", "segment_min_batch",
                                "segment_max_batch"])
def test_segment_batch_matches_reference(op):
    rng = np.random.default_rng(0)
    b, e, n = 3, 200, 40
    ids = rng.integers(0, n + 3, e).astype(np.int32)    # ids >= n are dropped
    for vals in (rng.integers(-50, 50, (b, e)).astype(np.int32),
                 rng.random((b, e)).astype(np.float32)):
        want = np.asarray(getattr(rrt, op)(jnp.asarray(vals), jnp.asarray(ids), n))
        got = getattr(trt, op)(t(vals), t(ids), n).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("op", ["scatter_min_rows", "scatter_add_rows", "scatter_or_rows"])
def test_scatter_rows_matches_reference(op):
    rng = np.random.default_rng(1)
    b, e, n = 4, 150, 30
    idx = rng.integers(0, n + 2, e).astype(np.int32)    # ids >= n are dropped
    if op == "scatter_or_rows":
        cur = rng.random((b, n)) < 0.2
        vals = rng.random((b, e)) < 0.1
    else:
        cur = rng.integers(0, 100, (b, n)).astype(np.int32)
        vals = rng.integers(0, 100, (b, e)).astype(np.int32)
    want = np.asarray(getattr(rrt, op)(jnp.asarray(cur), jnp.asarray(idx), jnp.asarray(vals)))
    got = getattr(trt, op)(t(cur), t(idx), t(vals)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --- BFS and the batched relax -----------------------------------------------------

@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
@pytest.mark.parametrize("gname", ["powerlaw", "disconnected"])
def test_bfs_levels_matches_reference(gname, direction, graphs):
    g, tgr = graphs[gname]
    for root in (0, 3, g.num_nodes - 1):
        lv, depth = rrt.bfs_levels(g, root, direction=direction)
        got, got_depth = trt.bfs_levels(tgr, root, direction=direction)
        assert np.array_equal(got.numpy(), np.asarray(lv)) and got_depth == int(depth)


@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
@pytest.mark.parametrize("gname", ["powerlaw", "disconnected"])
def test_bfs_levels_batch_rows_match_single(gname, direction, graphs):
    g, tgr = graphs[gname]
    roots = np.array([0, 3, g.num_nodes // 2, g.num_nodes - 1], np.int32)
    lv_ref, depth_ref = rrt.bfs_levels_batch(g, jnp.asarray(roots), direction=direction)
    lv, depth = trt.bfs_levels_batch(tgr, t(roots), direction=direction)
    assert np.array_equal(lv.numpy(), np.asarray(lv_ref)) and depth == int(depth_ref)
    for i, r in enumerate(roots):
        row, _ = trt.bfs_levels(tgr, int(r), direction=direction)
        assert torch.equal(lv[i], row), f"row {i}"


@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
@pytest.mark.parametrize("weighted", [True, False])
def test_relax_hybrid_batch_rows_match_sequential(direction, weighted, graphs):
    g, tgr = graphs["powerlaw"]
    srcs = np.array([0, 17, 499], np.int32)
    b, n = len(srcs), g.num_nodes
    dist = np.full((b, n), INF_I32, np.int32)
    dist[np.arange(b), srcs] = 0
    fr = dist == 0
    for _ in range(4):   # a few steps so push AND pull rows both occur
        want = np.asarray(rrt.relax_minplus_hybrid_batch(
            g, jnp.asarray(dist), jnp.asarray(fr), direction=direction, weighted=weighted))
        got = trt.relax_minplus_hybrid_batch(tgr, t(dist), t(fr), direction=direction,
                                             weighted=weighted)
        assert np.array_equal(got.numpy(), want)
        for i in range(b):
            row = trt.relax_minplus_hybrid(tgr, t(dist[i]), t(fr[i]), direction=direction,
                                           weighted=weighted)
            assert torch.equal(got[i], row), f"row {i}"
        fr = want < dist
        dist = want


def test_dense_batch_relax_matches_reference(graphs):
    g, tgr = graphs["UR"]
    dist = np.random.default_rng(2).integers(0, 500, (3, g.num_nodes)).astype(np.int32)
    want = np.asarray(rrt.relax_minplus_hybrid_batch(g, jnp.asarray(dist)))
    assert np.array_equal(trt.relax_minplus_hybrid_batch(tgr, t(dist)).numpy(), want)


# --- multi-source queries ----------------------------------------------------------

@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
@pytest.mark.parametrize("gname", ["powerlaw", "disconnected"])
def test_sssp_multi_rows_match_reference_and_single_source(gname, direction, graphs):
    g, tgr = graphs[gname]
    srcs = np.arange(0, g.num_nodes, max(g.num_nodes // 7, 1), np.int32)
    want = np.asarray(rrt.sssp_multi(g, jnp.asarray(srcs), direction=direction))
    dist = trt.sssp_multi(tgr, srcs, direction=direction)
    assert dist.dtype == torch.int32 and np.array_equal(dist.numpy(), want)
    prog = tc.compile_bundled("sssp", backend="local").bind(tgr)
    for i, s in enumerate(srcs):
        assert torch.equal(dist[i], prog(src=int(s))["dist"]), f"src {s}"


def test_sssp_multi_delta_names_its_item(graphs):
    with pytest.raises(NotImplementedError, match="item 7"):
        trt.sssp_multi(graphs["UR"][1], [0, 1], priority="delta")


@pytest.mark.parametrize("gname", ["UR", "powerlaw"])
def test_ppr_multi_matches_reference_and_singleton_sets(gname, graphs):
    g, tgr = graphs[gname]
    srcs = np.array([2, 9, 31], np.int32)
    want = np.asarray(rrt.ppr_multi(g, jnp.asarray(srcs)))
    rows = trt.ppr_multi(tgr, srcs)
    assert rows.dtype == torch.float32
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-4, atol=1e-5)
    prog = tc.compile_bundled("ppr", backend="local").bind(tgr)
    for i, s in enumerate(srcs):
        out = prog(beta=1e-4, delta=0.85, maxIter=100, sourceSet=[int(s)])
        np.testing.assert_allclose(rows[i].numpy(), out["ppr"].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=f"src {s}")


# --- triangle pieces ---------------------------------------------------------------

def test_edge_membership_paths_agree(graphs):
    g, tgr = graphs["powerlaw"]
    rng = np.random.default_rng(3)
    u = rng.integers(-2, g.num_nodes + 2, 400).astype(np.int32)
    w = rng.integers(0, g.num_nodes, 400).astype(np.int32)
    real = rng.integers(0, g.num_edges, 100)
    u[:100], w[:100] = np.asarray(g.edge_src)[real], np.asarray(g.indices)[real]
    want = np.asarray(rrt._is_an_edge_keyed(g, jnp.asarray(u), jnp.asarray(w)))
    keyed = trt._is_an_edge_keyed(tgr, t(u), t(w)).numpy()
    searched = trt._is_an_edge_rowsearch(tgr, t(u), t(w)).numpy()
    assert np.array_equal(keyed, want) and np.array_equal(searched, want)
    assert want.any(), "queries should hit at least one real edge"


def test_is_an_edge_and_tc_beyond_46k_nodes():
    """N = 47000 > 46341 ⇒ N² overflows int32: the composite-key path is
    invalid and is_an_edge / TC must take the row-range binary search."""
    n = 47_000
    ring_src = np.arange(n, dtype=np.int64)
    ring_dst = (ring_src + 1) % n
    # five chords i→i+2 forming triangles (i, i+1, i+2), far from the wrap
    chord_i = np.array([10, 1000, 20_000, 30_000, 46_000], np.int64)
    g = rg.from_edges(n, np.concatenate([ring_src, chord_i]),
                      np.concatenate([ring_dst, chord_i + 2]),
                      np.ones(n + len(chord_i), np.int64), undirected=True)
    tgr = carry(g)
    assert not trt._edge_key_fits_i32(tgr.num_nodes)
    u = np.array([10, 10, 46_000, 5], np.int32)
    w = np.array([12, 13, 46_002, 9], np.int32)
    want = np.asarray(rrt.is_an_edge(g, jnp.asarray(u), jnp.asarray(w)))
    got = trt.is_an_edge(tgr, t(u), t(w))
    assert got.tolist() == want.tolist() == [True, False, True, False]
    count = trt.wedge_count(tgr)
    assert count.dtype == torch.int32 and int(count) == int(rrt.wedge_count(g)) == 5
    out = tc.compile_bundled("tc", backend="local").bind(tgr)()
    assert int(out["triangle_count"]) == 5


@pytest.mark.parametrize("budget", [trt.WEDGE_BUDGET_BYTES, 4096, 1])
@pytest.mark.parametrize("gname", ["UR", "powerlaw", "disconnected"])
def test_wedge_count_matches_reference(gname, budget, graphs):
    """The count does not depend on the chunking: a budget of one byte
    forces one vertex per chunk."""
    g, tgr = graphs[gname]
    got = trt.wedge_count(tgr, chunk=64, budget_bytes=budget)
    assert got.dtype == torch.int32 and int(got) == int(rrt.wedge_count(g))
    last = trt.wedge_count.last
    assert last["max_degree"] == int(np.asarray(g.out_degree).max())
    if budget == 1:
        assert last["chunk_at_max_degree"] == 1 and last["chunks"] == last["vertices"]


def test_wedge_count_of_an_edgeless_graph():
    g = rg.from_edges(5, np.array([], np.int64), np.array([], np.int64))
    assert int(trt.wedge_count(carry(g))) == int(rrt.wedge_count(g)) == 0
