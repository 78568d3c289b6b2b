"""The plain reference against the port's NumPy oracles and its `local`
backend, on small graphs on the CPU. (The tests may import the port; the
reference itself may not.)"""
import numpy as np
import pytest
import torch

from portbench import graphs
from portbench.reference import algorithms as A
from repro_torch.core import compile_bundled
from repro_torch.core import runtime as rt
from repro_torch.graph import algorithms_ref as R

CONFIG = {"scale": 8,
          "graph": {"kind": "kronecker", "seed": 5, "edge_factor": 16,
                    "a": 0.57, "b": 0.19, "c": 0.19, "weights": [1, 100]}}


@pytest.fixture(scope="module")
def small():
    fields, meta, _ = graphs.build(CONFIG, 9, "cpu")
    g = graphs.to_port(fields, meta)
    edges = A.Edges(fields, meta["num_nodes"])
    srcs = torch.nonzero(fields["out_degree"] > 0).flatten()[:6]
    return g, edges, srcs


def test_bellman_ford(small):
    g, edges, srcs = small
    got = A.bellman_ford(edges, srcs, block=4)
    for i, s in enumerate(srcs.tolist()):
        assert np.array_equal(got[i].numpy(), R.sssp_ref(g, s))
        local = compile_bundled("sssp", backend="local").bind(g)(src=s)["dist"]
        assert torch.equal(local.long(), got[i].long())


def test_bfs_levels(small):
    g, edges, srcs = small
    got = A.bfs_levels(edges, srcs, block=4)
    for i, s in enumerate(srcs.tolist()):
        assert np.array_equal(got[i].numpy(), R.bfs_levels_ref(g, s))
        level, _ = rt.bfs_levels(g, s)
        assert torch.equal(level.long(), got[i].long())


def test_brandes(small):
    g, edges, srcs = small
    got = A.brandes(edges, srcs, block=4)
    np.testing.assert_allclose(got.numpy(), R.bc_ref(g, srcs.tolist()), rtol=1e-12, atol=1e-9)
    local = compile_bundled("bc", backend="local").bind(g)(sourceSet=srcs)["BC"]
    np.testing.assert_allclose(local.double().numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_ppr(small):
    g, edges, srcs = small
    got = A.ppr(edges, srcs, beta=1e-4, delta=0.85, max_iter=100, block=4)
    np.testing.assert_allclose(got.numpy(), R.ppr_matrix_ref(g, srcs.tolist()), atol=1e-12)
    rows = rt.ppr_multi(g, srcs)
    assert float((rows.double() - got).abs().sum(1).max()) < 1e-5


def test_pagerank(small):
    g, edges, _ = small
    got = A.pagerank(edges, beta=1e-4, delta=0.85, max_iter=100)
    np.testing.assert_allclose(got.numpy(), R.pagerank_ref(g), rtol=1e-12, atol=1e-15)
    local = compile_bundled("pr", backend="local").bind(g)(beta=1e-4, delta=0.85,
                                                           maxIter=100)["pageRank"]
    np.testing.assert_allclose(local.double().numpy(), got.numpy(), rtol=1e-4)


def test_controls_fall_short(small):
    _, edges, srcs = small
    exact = A.bellman_ford(edges, srcs)
    assert int((A.bellman_ford(edges, srcs, rounds_short=1) != exact).sum()) > 0
    levels = A.bfs_levels(edges, srcs)
    assert int((A.bfs_levels(edges, srcs, rounds_short=1) != levels).sum()) > 0
    bc = A.brandes(edges, srcs)
    low = A.brandes(edges, srcs, dtype=torch.bfloat16).double()
    assert float(((low - bc).abs() / bc.abs().clamp(min=1)).max()) > 1e-3
