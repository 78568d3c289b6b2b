"""The benchmark's device CSR builder against the port's host builder."""
import numpy as np
import pytest
import torch

from portbench import graphs
from repro_torch.graph.csr import from_edges

CONFIG = {"scale": 9,
          "graph": {"kind": "kronecker", "seed": 3, "edge_factor": 16,
                    "a": 0.57, "b": 0.19, "c": 0.19, "weights": [1, 100]}}


@pytest.mark.parametrize("scale,seed", [(8, 1), (9, 2**31 + 7), (10, 5)])
def test_csr_fields_equal_from_edges(scale, seed):
    gen = graphs.generator(seed, "cpu")
    n, src, dst, w = graphs.kronecker_edges(scale, 16, 0.57, 0.19, 0.19, 1, 100, gen, "cpu")
    fields = graphs.csr_fields(n, src, dst, w)
    g = from_edges(n, src.numpy(), dst.numpy(), w.numpy(), drop_self_loops=True, device="cpu")
    for f in graphs.FIELDS:
        assert torch.equal(getattr(g, f), fields[f]), f
        assert fields[f].dtype == torch.int32, f


def test_edge_key_wraps_like_from_edges():
    n = 1 << 17                     # N * N overflows int32
    src = torch.tensor([n - 1, 5, n - 1, 5, 7])
    dst = torch.tensor([n - 2, 7, 3, 7, 7])
    w = torch.tensor([3, 4, 5, 6, 9], dtype=torch.int32)
    fields = graphs.csr_fields(n, src, dst, w)
    g = from_edges(n, src.numpy(), dst.numpy(), w.numpy(), drop_self_loops=True, device="cpu")
    for f in graphs.FIELDS:
        assert torch.equal(getattr(g, f), fields[f]), f
    assert int(fields["weights"][0]) == 4          # the first of the duplicates


def test_weights_and_quadrants():
    gen = graphs.generator(11, "cpu")
    n, src, dst, w = graphs.kronecker_edges(12, 8, 0.57, 0.19, 0.19, 1, 100, gen, "cpu")
    assert int(w.min()) == 1 and int(w.max()) == 100
    # the top bit of src is set where that bit's draw went down: c + d
    top = (src >= n // 2).double().mean().item()
    assert abs(top - 0.24) < 0.01


def test_seed_relabels_the_same_graph():
    f1, m1, l1 = graphs.build(CONFIG, 1, "cpu")
    f2, m2, l2 = graphs.build(CONFIG, 2, "cpu")
    assert m1 == m2
    assert sorted(l1.tolist()) == list(range(m1["num_nodes"]))
    assert not torch.equal(f1["indices"], f2["indices"])
    # generated vertex v carries label l1[v] in one run and l2[v] in the other
    deg1 = f1["out_degree"][l1]
    deg2 = f2["out_degree"][l2]
    assert torch.equal(deg1, deg2)
    again, _, _ = graphs.build(CONFIG, 1, "cpu")
    assert all(torch.equal(f1[k], again[k]) for k in graphs.FIELDS)


def test_digest_sees_a_write():
    f, _, _ = graphs.build(CONFIG, 4, "cpu")
    d = graphs.digest(f)
    f["weights"][17] += 1
    assert graphs.digest(f) != d
    assert np.sum(np.array(d) != np.array(graphs.digest(f))) == 1
