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
from repro_torch.kernels.tc_matmul.kernel import K_CHUNK, TILE, tc_matmul, work_units
from repro_torch.kernels.tc_matmul.ops import count_triangles_dense, prepare_lower
from repro_torch.kernels.tc_matmul.ref import pack_lower_ref, tc_matmul_ref


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


@pytest.mark.parametrize("n", [128, 200, 1024, 16384])
def test_work_units_cover_every_lower_triple_once(n):
    """The kernel's work list: every tile triple (I, J, K) with J <= K <= I
    exactly once, no unit longer than K_CHUNK, longest first."""
    units = work_units(n)
    assert units.dtype == np.int32 and units.shape[1] == 4
    i, j, k0, nk = units.T.astype(np.int64)
    assert (nk >= 1).all() and (nk <= K_CHUNK).all()
    assert (np.diff(nk) <= 0).all()
    nb = -(-n // TILE)
    assert (j <= k0).all() and (k0 + nk - 1 <= i).all() and (i < nb).all()
    # expand the units into their (I, J, K) triples, one code each
    ks = np.repeat(k0, nk) + (np.arange(int(nk.sum())) - np.repeat(np.cumsum(nk) - nk, nk))
    got = np.sort(np.repeat(i, nk) * nb * nb + np.repeat(j, nk) * nb + ks)
    ii, jj, kk = np.meshgrid(*(np.arange(nb),) * 3, indexing="ij")
    keep = (jj <= kk) & (kk <= ii)
    want = np.sort((ii * nb * nb + jj * nb + kk)[keep])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [5, 128, 200])
def test_pack_lower_ref_matches_numpy(n):
    """Padded to a multiple of 128, the strict lower triangle only, in both
    orientations; what lies on or above the diagonal is dropped."""
    rng = np.random.default_rng(n)
    a = (rng.random((n, n)) < 0.3).astype(np.float32)      # not lower: the pack drops the rest
    l8, l8t = pack_lower_ref(torch.from_numpy(a))
    n_pad = -(-n // TILE) * TILE
    want = np.zeros((n_pad, n_pad), np.int8)
    want[:n, :n] = np.tril(a, -1).astype(np.int8)
    assert l8.dtype == torch.int8 and tuple(l8.shape) == (n_pad, n_pad)
    assert np.array_equal(l8.numpy(), want)
    assert np.array_equal(l8t.numpy(), want.T)
    assert l8t.is_contiguous()


def test_pack_lower_ref_refuses_a_strictly_lower_entry_not_0_or_1():
    a = np.tril(np.ones((8, 8), np.float32), -1)
    a[0, 5] = 0.5                                          # above the diagonal: dropped
    pack_lower_ref(torch.from_numpy(a))
    a[5, 0] = 0.5
    with pytest.raises(ValueError, match="neither 0 nor 1"):
        pack_lower_ref(torch.from_numpy(a))
