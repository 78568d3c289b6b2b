"""The port's 2-D grid (`core/dist2d`, `graph.partition.partition_2d`) against
the reference's and the NumPy oracles. Mirrors tests/test_dist2d.py and
test_distributed.py::test_sssp_2d / test_pr_2d.

Each grid shape runs in a world of R·C gloo ranks
(`torch_dist_worker.spawn_world`, one world per size, every rank running
every case of its size). At N = 100 the shapes of 8 ranks pad their
pieces (13 vertices, 104 in all); the reference's own 2-D functions trim
a padded sharded output with `out[:N]`, which raises under jax 0.9, so
at N = 100 the port is held against the oracles
(`repro.graph.algorithms_ref`), as tests/test_dist2d.py holds the
reference. At N = 96 every shape divides N and the port is held against
`repro.core.dist2d` itself. `partition_2d`'s arrays are plain numpy and
equal the reference's at any N.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from hypothesis import given, settings, strategies as st

from repro.core import dist2d as ref2d
from repro.graph import from_edges, road, uniform_random
from repro.graph.algorithms_ref import pagerank_ref, sssp_ref
from repro.graph.partition import partition_2d as ref_partition_2d
from repro.graph.partition import piece_order_to_global as ref_piece_order
from repro_torch.core import dist
from repro_torch.graph import from_arrays, partition_2d, piece_order_to_global
from torch_dist_ref import graph_spec
from torch_dist_worker import spawn_world

# grid shapes with 8, 4 and 2 ranks (tests/test_dist2d.py's MESHES)
MESHES = [(4, 2), (2, 4), (2, 2), (8, 1), (1, 8), (2, 1), (1, 2)]
WORLDS = sorted({r * c for r, c in MESHES}, reverse=True)
# the padded tile (the reference's whole edge row) against the trimmed one
PADDED = [(4, 2), (1, 2)]
PARTITION_FIELDS = ("src_local", "dst_local", "weight", "valid", "rows", "cols",
                    "piece", "num_nodes_padded", "block_rows", "block_cols")


@pytest.fixture(scope="module")
def graphs(eight_devices):
    # N = 100 pads every shape of 8 ranks; N = 96 pads none
    # N = 6 on 8 ranks: pieces of one vertex, the last two all padding
    return {"g100": uniform_random(100, 5, seed=2), "g96": uniform_random(96, 5, seed=2),
            "road": road(10, seed=3), "g6": uniform_random(6, 3, seed=5)}


def _cases(world):
    cases = []
    for shape in (s for s in MESHES if s[0] * s[1] == world):
        cases += [(("sssp0", shape), "g100", shape, "sssp", dict(src=0)),
                  (("pr", shape), "g100", shape, "pagerank", {}),
                  (("ref_sssp", shape), "g96", shape, "sssp", dict(src=0)),
                  (("ref_pr", shape), "g96", shape, "pagerank", {}),
                  (("layout", shape), "g100", shape, "layout", {})]
        if shape in ((4, 2), (1, 8)):
            cases.append((("sssp17", shape), "g100", shape, "sssp", dict(src=17)))
        if shape == (2, 4):
            cases.append((("road", shape), "road", shape, "sssp", dict(src=0)))
        if shape == (4, 2):
            cases += [(("tiny_sssp", shape), "g6", shape, "sssp", dict(src=1)),
                      (("tiny_pr", shape), "g6", shape, "pagerank", {})]
        if shape == (2, 2):
            cases.append((("pr1", shape), "g100", shape, "pagerank", dict(max_iter=1)))
        if shape in PADDED:
            cases += [(("sssp_padded", shape), "g100", shape, "sssp_padded", dict(src=0)),
                      (("pr_padded", shape), "g100", shape, "pagerank_padded", {})]
    return cases


_WORLDS = {}


@pytest.fixture(scope="module")
def world(graphs, tmp_path_factory):
    """`world(size)`: every rank's grid results of that world size, spawned
    once per module."""
    def get(size):
        if size not in _WORLDS:
            payload = {"grid": {"graphs": {k: graph_spec(g) for k, g in graphs.items()},
                                "cases": _cases(size)}}
            try:
                _WORLDS[size] = spawn_world(size, payload, tmp_path_factory.mktemp("grid"))
            except AssertionError as e:
                _WORLDS[size] = e
        res = _WORLDS[size]
        if isinstance(res, AssertionError):
            raise res
        return res
    return get


def _got(world, key, shape):
    return world(shape[0] * shape[1])[0]["grid"][(key, shape)]


def _jax_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"))


def _carry(g):
    return from_arrays(graph_spec(g)["arrays"], num_nodes=g.num_nodes,
                       num_edges=g.num_edges, max_out_degree=int(g.max_out_degree),
                       max_in_degree=int(g.max_in_degree), device="cpu")


# --------------------------------------------------------------------------
# the partition: plain numpy, equal to the reference's
# --------------------------------------------------------------------------

def _assert_partitions_equal(got, want):
    for f in PARTITION_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(piece_order_to_global(got), ref_piece_order(want))


@pytest.mark.parametrize("r,c", MESHES)
def test_partition_2d_equals_the_reference(r, c, graphs):
    g = graphs["g100"]
    _assert_partitions_equal(partition_2d(_carry(g), r, c), ref_partition_2d(g, r, c))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 40), e=st.integers(0, 120), seed=st.integers(0, 2**16),
       shape=st.sampled_from([(2, 2), (3, 1), (1, 3), (2, 3)]))
def test_partition_2d_equals_the_reference_on_any_graph(n, e, seed, shape):
    """Mirrors test_property.py's partition cover: every edge lands in
    exactly one tile, pads included, as the reference places it."""
    rng = np.random.default_rng(seed)
    g = from_edges(n, rng.integers(0, n, e), rng.integers(0, n, e),
                   rng.integers(1, 50, e))
    got = partition_2d(_carry(g), *shape)
    _assert_partitions_equal(got, ref_partition_2d(g, *shape))
    assert int(got.valid.sum()) == g.num_edges


# --------------------------------------------------------------------------
# sssp_2d / pagerank_2d in worlds of 8, 4 and 2 ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
def test_sssp_2d_agrees_with_the_oracle(shape, graphs, world):
    got, steps = _got(world, "sssp0", shape)
    assert got.dtype == np.int32 and steps >= 1
    assert np.array_equal(got, sssp_ref(graphs["g100"], 0).astype(np.int32))


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_sssp_2d_nonzero_source(shape, graphs, world):
    got, _ = _got(world, "sssp17", shape)
    assert np.array_equal(got, sssp_ref(graphs["g100"], 17).astype(np.int32))


@pytest.mark.parametrize("shape", MESHES)
def test_pagerank_2d_agrees_with_the_oracle(shape, graphs, world):
    got, its = _got(world, "pr", shape)
    assert got.dtype == np.float32 and 1 <= its <= 100
    np.testing.assert_allclose(got, pagerank_ref(graphs["g100"]), rtol=0, atol=1e-5)


def test_sssp_2d_deep_graph(graphs, world):
    """High-diameter road grid: many supersteps of the host loop."""
    got, steps = _got(world, "road", (2, 4))
    assert steps > 10
    assert np.array_equal(got, sssp_ref(graphs["road"], 0).astype(np.int32))


def test_ranks_that_own_only_padding(graphs, world):
    """N = 6 on (4, 2): ranks 6 and 7 own padding alone (their pieces'
    out-degree is 0, and x / 0 is masked), and the answers still equal
    the oracles."""
    got, _ = _got(world, "tiny_sssp", (4, 2))
    assert np.array_equal(got, sssp_ref(graphs["g6"], 1).astype(np.int32))
    got, _ = _got(world, "tiny_pr", (4, 2))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pagerank_ref(graphs["g6"]), rtol=0, atol=1e-5)


def test_pagerank_2d_respects_maxiter(graphs, world):
    got, its = _got(world, "pr1", (2, 2))
    assert its == 1
    np.testing.assert_allclose(got, pagerank_ref(graphs["g100"], max_iter=1), rtol=0,
                               atol=1e-6)
    assert not np.allclose(got, pagerank_ref(graphs["g100"]), atol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_sssp_2d_equals_the_reference(shape, graphs, world):
    want = np.asarray(ref2d.sssp_2d(graphs["g96"], _jax_mesh(shape), 0))
    got, _ = _got(world, "ref_sssp", shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_pagerank_2d_equals_the_reference(shape, graphs, world):
    want = np.asarray(ref2d.pagerank_2d(graphs["g96"], _jax_mesh(shape)))
    got, _ = _got(world, "ref_pr", shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_data_group_gathers_pieces_in_i_order(shape, graphs, world):
    """The "data" sub-group of column j holds ranks {i·C + j : i} in i
    order: the gathered own ids are x_j's layout, the pieces of
    `piece_order_to_global` down column j; the global gather is every id
    in order; each tile holds only its real edges."""
    r, c = shape
    order = ref_piece_order(ref_partition_2d(graphs["g100"], r, c))
    part = ref_partition_2d(graphs["g100"], r, c)
    for rank, res in enumerate(world(r * c)):
        got = res["grid"][("layout", shape)]
        i, j = divmod(rank, c)
        assert got["coords"] == (i, j)
        assert np.array_equal(got["gathered"], order[:, j].reshape(-1))
        assert np.array_equal(got["whole"], np.arange(part.num_nodes_padded))
        assert got["all_real"] and got["edges"] == int(part.valid[i, j].sum())


@pytest.mark.parametrize("shape", PADDED)
def test_trimmed_tile_answers_as_the_padded_one(shape, world):
    """A rank moves only the real edges of its tile; the reference's padded
    tile (pads aimed at slot 0, weight INF, masked) gives the same answers,
    sssp equal, pagerank bitwise on the CPU (pads add exact zeros)."""
    for key, padded in (("sssp0", "sssp_padded"), ("pr", "pr_padded")):
        got, n_got = _got(world, key, shape)
        want, n_want = _got(world, padded, shape)
        assert n_got == n_want and np.array_equal(got, want), key


@pytest.mark.parametrize("size", WORLDS)
def test_every_rank_returns_the_global_result(size, world):
    res = world(size)
    for rank_res in res[1:]:
        for cid, out in res[0]["grid"].items():
            if cid[0] == "layout":
                continue
            assert np.array_equal(rank_res["grid"][cid][0], out[0]), cid
            assert rank_res["grid"][cid][1] == out[1], cid


# --------------------------------------------------------------------------
# make_mesh in this process (a gloo group of one rank)
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    assert not tdist.is_initialized()
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def test_make_mesh_never_starts_a_group():
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized default process group"):
        dist.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert not tdist.is_initialized()


def test_make_mesh_checks_shape_device_and_backend(one_rank_group, monkeypatch):
    m = dist.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert m.shape == {"data": 1, "model": 1} and (m.rank, m.device.type) == (0, "cpu")
    assert (m.axis("data").size, m.axis("data").rank) == (1, 0)
    with pytest.raises(ValueError, match="has 1 ranks, the shape 2"):
        dist.make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="one distinct name per axis"):
        dist.make_mesh((1, 1), ("data", "data"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.make_mesh((1, 1), ("data", "model"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs its collectives on nccl"):
        dist.make_mesh((1, 1), ("data", "model"), device="cuda:0")


def test_one_rank_grid_and_its_memoized_tile(one_rank_group, graphs):
    """World size 1 in this process: the grid (1, 1) equals the oracles,
    and the tile is one GraphContext view per (grid, rank, device)."""
    from repro_torch.core import dist2d, get_context
    g = _carry(graphs["g100"])
    m = dist.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert np.array_equal(dist2d.sssp_2d(g, m, 3).numpy(),
                          sssp_ref(graphs["g100"], 3).astype(np.int32))
    np.testing.assert_allclose(dist2d.pagerank_2d(g, m).numpy(),
                               pagerank_ref(graphs["g100"]), rtol=0, atol=1e-5)
    ctx = get_context(g)
    assert dist2d.prepare(g, m) is ctx.dist_tile_2d(1, 1, rank=0, device="cpu")
    assert ("dist_2d", 1, 1, 0, "cpu") in ctx.view_keys()
