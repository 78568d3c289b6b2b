"""Graph layer of the PyTorch port against the JAX reference: the same numpy
inputs give the same CSR arrays and the same ELL / sliced-ELL views, array
for array."""
import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro.schedule import Schedule as RSchedule
from repro_torch.schedule import Schedule as TSchedule


def carry(g):
    """A reference graph as the port's CSRGraph, on the CPU."""
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, version=g.version,
                          device="cpu")


def assert_same_graph(ref, port):
    for f in tg.FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert b.dtype == torch.int32, f
        assert np.array_equal(a, b.numpy()), f
    for f in ("num_nodes", "num_edges", "max_out_degree", "max_in_degree",
              "version"):
        assert getattr(ref, f) == getattr(port, f), f


def star(n=700, inward=True):
    """Hub star: one vertex of degree n-1 > 512, so it lands in the COO hub
    tail of the (reverse, if inward) sliced view."""
    leaves = np.arange(1, n)
    hub = np.zeros(n - 1, np.int64)
    src, dst = (leaves, hub) if inward else (hub, leaves)
    w = np.random.default_rng(5).integers(1, 101, n - 1)
    return (n, src, dst, w)


GRAPHS = ["g_small", "g_medium", "g_road", "g_social", "powerlaw",
          "star_in", "star_out"]


@pytest.fixture(scope="module")
def graphs(g_small, g_medium, g_road, g_social):
    out = {"g_small": g_small, "g_medium": g_medium, "g_road": g_road,
           "g_social": g_social,
           "powerlaw": rg.preferential_attachment(400, m=5, seed=3)}
    for name, inward in (("star_in", True), ("star_out", False)):
        n, src, dst, w = star(inward=inward)
        out[name] = rg.from_edges(n, src, dst, w)
    return out


@pytest.mark.parametrize("name", GRAPHS)
def test_from_arrays_round_trips_every_field(name, graphs):
    g = graphs[name]
    assert_same_graph(g, carry(g))


@pytest.mark.parametrize("gen,kw", [
    ("uniform_random", dict(n=100, avg_degree=5, seed=2)),
    ("road", dict(side=10, seed=3)),
    ("small_world", dict(n=96, k=8, p=0.2, seed=4)),
    ("powerlaw_social", dict(n=300, avg_degree=6, seed=1)),
    ("preferential_attachment", dict(n=400, m=5, seed=3)),
    ("rmat", dict(scale=9, edge_factor=8, seed=0)),
])
def test_generators_give_the_reference_graph(gen, kw):
    assert_same_graph(getattr(rg, gen)(**kw),
                      getattr(tg, gen)(**kw, device="cpu"))


@pytest.mark.parametrize("opts", [
    dict(), dict(undirected=True), dict(dedup=False),
    dict(drop_self_loops=True), dict(undirected=True, drop_self_loops=True),
])
def test_from_edges_gives_the_reference_arrays(opts):
    rng = np.random.default_rng(7)
    n, e = 50, 400          # duplicates and self loops on purpose
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.integers(1, 101, e)
    assert_same_graph(rg.from_edges(n, src, dst, w, **opts),
                      tg.from_edges(n, src, dst, w, **opts, device="cpu"))


def test_from_edges_edgeless_and_unweighted():
    for n, src, dst in ((5, [], []), (6, [0, 1, 2], [1, 2, 3])):
        assert_same_graph(rg.from_edges(n, np.array(src), np.array(dst)),
                          tg.from_edges(n, np.array(src), np.array(dst),
                                        device="cpu"))


def test_edge_key_wraps_like_the_reference():
    """N² ≥ 2³¹: the key wraps to int32 exactly as the reference's does."""
    n = 70000
    src, dst = np.array([n - 1, 5, 69000]), np.array([n - 2, 7, 3])
    assert_same_graph(rg.from_edges(n, src, dst),
                      tg.from_edges(n, src, dst, device="cpu"))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_to_ell_matches_reference(name, reverse, graphs):
    g = graphs[name]
    ref = rg.to_ell(g, reverse=reverse)
    port = tg.to_ell(carry(g), reverse=reverse)
    assert (ref.num_nodes, ref.max_deg) == (port.num_nodes, port.max_deg)
    assert np.array_equal(np.asarray(ref.cols), port.cols.numpy())
    assert np.array_equal(np.asarray(ref.wts), port.wts.numpy())


def assert_same_sliced(ref, port):
    assert ref.widths == port.widths and ref.num_nodes == port.num_nodes
    assert ref.padded_cells() == port.padded_cells()
    for field in ("cols", "wts", "rows"):
        a, b = getattr(ref, field), getattr(port, field)
        assert len(a) == len(b), field
        for x, y in zip(a, b):
            assert y.dtype == torch.int32
            assert np.array_equal(np.asarray(x), y.numpy()), field
    for field in ("hub_rows", "hub_cols", "hub_wts"):
        assert np.array_equal(np.asarray(getattr(ref, field)),
                              getattr(port, field).numpy()), field


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_to_sliced_ell_matches_reference(name, reverse, graphs):
    g = graphs[name]
    assert_same_sliced(rg.to_sliced_ell(g, reverse=reverse),
                       tg.to_sliced_ell(carry(g), reverse=reverse))


@pytest.mark.parametrize("knobs", [
    dict(num_buckets=2, min_width=16, growth=2),
    dict(num_buckets=1, min_width=8, growth=4),
    dict(num_buckets=5, min_width=8, growth=2),
])
def test_sliced_layout_follows_the_schedule(knobs, graphs):
    for name in ("powerlaw", "star_in"):
        g = graphs[name]
        assert_same_sliced(
            rg.to_sliced_ell(g, reverse=True, schedule=RSchedule(**knobs)),
            tg.to_sliced_ell(carry(g), reverse=True, schedule=TSchedule(**knobs)))


def test_star_graph_has_a_hub_tail(graphs):
    ell = tg.to_sliced_ell(carry(graphs["star_in"]), reverse=True)
    assert ell.hub_rows.shape[0] == 699 and bool((ell.hub_rows == 0).all())


def test_graph_views_move_between_devices(graphs):
    g = carry(graphs["powerlaw"])
    assert g.device == torch.device("cpu")
    assert_same_graph(graphs["powerlaw"], g.to("cpu"))
    ell = tg.to_sliced_ell(g, reverse=True).to("cpu")
    assert all(c.device == torch.device("cpu") for c in ell.cols)


def test_missing_field_is_rejected():
    with pytest.raises(ValueError, match="missing fields"):
        tg.from_arrays({"indptr": np.zeros(2, np.int32)}, num_nodes=1,
                       num_edges=0, max_out_degree=1, max_in_degree=1,
                       device="cpu")
