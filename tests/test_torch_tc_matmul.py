"""The port's dense triangle count against the JAX reference.

On the CPU the wrapper runs its plain version `tc_matmul_ref`; it is held
against the reference's Pallas kernel in interpret mode on the same numpy
inputs. Counts of 0/1 matrices at these sizes are exact in f32 on both
sides, so they must be equal. The card's kernel is checked by
tests/test_torch_gpu.py (and by chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.graph as tg
from repro.kernels.tc_matmul.kernel import tc_matmul as ref_tc_matmul
from repro.kernels.tc_matmul.ops import prepare_lower as ref_prepare_lower
from repro_torch.kernels.tc_matmul.kernel import tc_matmul
from repro_torch.kernels.tc_matmul.ops import count_triangles_dense, prepare_lower
from repro_torch.kernels.tc_matmul.ref import tc_matmul_ref


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


def random_lower(n, p=0.1):
    rng = np.random.default_rng(n)
    return np.tril((rng.random((n, n)) < p).astype(np.float32), -1)


@pytest.mark.parametrize("n,block", [(64, 32), (128, 64), (128, 128)])
def test_tc_matmul_matches_pallas_kernel(n, block):
    lower = random_lower(n)
    want = float(ref_tc_matmul(jnp.asarray(lower), block=block))
    got = tc_matmul(torch.from_numpy(lower), block=block)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == want
    assert float(tc_matmul_ref(torch.from_numpy(lower))) == want


def test_prepare_lower_matches_reference(g_social):
    want = np.asarray(ref_prepare_lower(g_social, block=64))
    got = prepare_lower(carry(g_social), block=64)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


def test_count_triangles_dense_vs_networkx(g_social):
    import networkx as nx
    got = count_triangles_dense(prepare_lower(carry(g_social), block=64), block=64)
    assert got.dtype == torch.int32
    G = nx.Graph()
    G.add_edges_from(zip(np.asarray(g_social.edge_src).tolist(),
                         np.asarray(g_social.indices).tolist()))
    assert int(got) == sum(nx.triangles(G).values()) // 3


def test_count_triangles_dense_on_a_graph_smaller_than_the_block():
    """block = min(block, N): a 5-vertex graph counts with one 5 x 5 block."""
    g = tg.from_edges(5, np.array([0, 1, 2, 2, 3]), np.array([1, 2, 0, 3, 4]), device="cpu")
    lower = prepare_lower(g, block=5)
    assert tuple(lower.shape) == (5, 5)
    assert int(count_triangles_dense(lower)) == 1


def test_wrapper_checks_its_inputs():
    with pytest.raises(TypeError, match="float32"):
        tc_matmul(torch.zeros(64, 64, dtype=torch.float64))
    with pytest.raises(ValueError, match="square"):
        tc_matmul(torch.zeros(64, 32))
    with pytest.raises(ValueError, match="multiple of block"):
        tc_matmul(torch.zeros(96, 96), block=64)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tc_matmul(torch.zeros(64, 64, device="meta"), block=64)
    before = tc_matmul.launches
    tc_matmul(torch.zeros(64, 64), block=64)
    assert tc_matmul.launches == before
