"""The port's NumPy oracles (`repro_torch.graph.algorithms_ref`) against the
reference's (`repro.graph.algorithms_ref`): each of the nine on a graph
the port's generator builds, against the reference oracle on the graph
the reference's generator builds from the same seed, with the same
arguments. Integer answers and NaN positions equal; floats at rtol 0 (the
same NumPy on the same arrays)."""
import numpy as np
import pytest

import repro.graph as rg
import repro.graph.algorithms_ref as ref
import repro_torch.graph as tg
import repro_torch.graph.algorithms_ref as port

GRAPHS = {
    "preferential_attachment": ("preferential_attachment", dict(n=200, m=4, seed=1)),
    "uniform_random": ("uniform_random", dict(n=100, avg_degree=5, seed=2)),
    "road": ("road", dict(side=10, seed=3)),
    "rmat8": ("rmat", dict(scale=8, edge_factor=4, seed=5)),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (getattr(rg, fn)(**kw), getattr(tg, fn)(**kw, device="cpu"))
            for name, (fn, kw) in GRAPHS.items()}


def sources(n, count=4):
    return np.arange(0, n, max(n // count, 1), np.int32)[:count]


CALLS = {
    "sssp_ref": lambda m, g: m.sssp_ref(g, 3),
    "pagerank_ref": lambda m, g: m.pagerank_ref(g, delta=0.85, beta=1e-4, max_iter=100),
    "ppr_matrix_ref": lambda m, g: m.ppr_matrix_ref(g, sources(g.num_nodes), max_iter=40),
    "ppr_ref": lambda m, g: m.ppr_ref(g, sources(g.num_nodes), beta=1e-5),
    "label_propagation_ref": lambda m, g: m.label_propagation_ref(g),
    "kcore_ref": lambda m, g: m.kcore_ref(g, 3),
    "triangle_count_ref": lambda m, g: m.triangle_count_ref(g),
    "bfs_levels_ref": lambda m, g: m.bfs_levels_ref(g, 1),
    "bc_ref": lambda m, g: m.bc_ref(g, sources(g.num_nodes).tolist()),
}


def test_the_port_has_every_oracle():
    names = {n for n in dir(ref) if n.endswith("_ref")}
    assert names == set(CALLS) == {n for n in dir(port) if n.endswith("_ref")}
    assert tg.algorithms_ref is port


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("oracle", CALLS)
def test_oracle_equals_the_references(oracle, gname, graphs):
    g_ref, g_port = graphs[gname]
    want, got = CALLS[oracle](ref, g_ref), CALLS[oracle](port, g_port)
    if oracle == "triangle_count_ref":
        assert type(got) is int and got == want
        return
    want, got = np.asarray(want), np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind == "f":
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=0)
    else:
        assert np.array_equal(got, want)
