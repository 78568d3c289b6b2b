"""The port's edge-list I/O (`repro_torch.graph.io`) and `to_dense`
against the reference's `repro.graph.io` and `repro.graph.to_dense`.

Each conftest graph (and a weighted RMAT, a graph with negative and zero
weights, an edgeless one) is carried over to the port with `from_arrays`;
both packages write it, and the files must be byte-identical. A file
written by either package loads to equal CSR arrays in the other,
weighted and unweighted, directed and `undirected=True`. Both loaders take
the node count from the largest id they read, so a graph whose
highest-numbered vertices have no edge comes back smaller (ROADMAP §3,
faults in the reference): held here as the reference's behaviour.
"""
import numpy as np
import pytest
import torch

import repro_torch.graph as tg
from repro.graph import generators as ref_gen
from repro.graph import io as ref_io
from repro.graph import to_dense as ref_to_dense
from repro.graph.csr import from_edges as ref_from_edges
from repro_torch.graph import io


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


def odd_weights():
    return ref_from_edges(6, np.array([0, 1, 4, 5, 2]), np.array([1, 2, 0, 4, 5]),
                          np.array([-7, 0, 123_456_789, 10, -1]))


GRAPHS = {
    "small": lambda fx: fx("g_small"),
    "medium": lambda fx: fx("g_medium"),
    "road": lambda fx: fx("g_road"),
    "social": lambda fx: fx("g_social"),
    "rmat": lambda fx: ref_gen.rmat(9, edge_factor=8, seed=3),
    "odd-weights": lambda fx: odd_weights(),
    "edgeless": lambda fx: ref_from_edges(4, np.array([], np.int64), np.array([], np.int64)),
}


@pytest.fixture(params=list(GRAPHS))
def ref_graph(request):
    return GRAPHS[request.param](request.getfixturevalue)


def assert_same_csr(port, ref):
    assert port.num_nodes == ref.num_nodes and port.num_edges == ref.num_edges
    for f in tg.FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_files_are_byte_identical(ref_graph, tmp_path):
    ref_io.save_edgelist(ref_graph, str(tmp_path / "ref.txt"))
    io.save_edgelist(carry(ref_graph), str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("weighted", [None, False, True])
def test_files_cross_load(ref_graph, tmp_path, writer, undirected, weighted):
    """Either package's file loads to the same CSR arrays in both."""
    path = str(tmp_path / "g.txt")
    if writer == "ref":
        ref_io.save_edgelist(ref_graph, path)
    else:
        io.save_edgelist(carry(ref_graph), path)
    want = ref_io.load_edgelist(path, undirected=undirected, weighted=weighted)
    got = io.load_edgelist(path, undirected=undirected, weighted=weighted, device="cpu")
    assert_same_csr(got, want)


def test_comments_and_unweighted_lines(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("% a comment\n# another\n\n0 1\n1 2\n  2 0  \n3 1\n")
    got = io.load_edgelist(str(path), device="cpu")
    assert_same_csr(got, ref_io.load_edgelist(str(path)))
    assert got.weights.tolist() == [1, 1, 1, 1]
    path.write_text("0 1 2.9\n1 2\n")            # a weight on one line only
    assert_same_csr(io.load_edgelist(str(path), device="cpu"), ref_io.load_edgelist(str(path)))


def test_isolated_top_vertices_are_dropped(tmp_path):
    """The loader ignores the header's node count: vertices above the
    largest id on an edge are lost, in both packages."""
    g = ref_from_edges(10, np.array([0, 1, 2]), np.array([1, 2, 3]), np.array([5, 6, 7]))
    path = str(tmp_path / "g.txt")
    io.save_edgelist(carry(g), path)
    assert open(path).readline() == "# nodes=10 edges=3\n"
    got = io.load_edgelist(path, device="cpu")
    assert got.num_nodes == ref_io.load_edgelist(path).num_nodes == 4
    assert got.indices.tolist() == [1, 2, 3] and got.weights.tolist() == [5, 6, 7]


def test_to_dense_matches_reference(ref_graph):
    for dtype, ref_dtype in ((torch.float32, np.float32), (torch.int32, np.int32)):
        got = tg.to_dense(carry(ref_graph), dtype=dtype)
        assert got.dtype == dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_to_dense(ref_graph, ref_dtype)))


def test_to_dense_stays_on_the_graphs_device(g_small):
    g = carry(g_small).to("meta")
    assert tg.to_dense(g).device.type == "meta"
