"""The port's CUDA kernel on the card, against its plain version.

Marked `gpu`: without a CUDA device every test here skips (the decision is
made in a fixture, never at import). This file imports neither jax nor the
JAX package, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import Schedule, compile_bundled
from repro_torch.graph import INF_I32, preferential_attachment
from repro_torch.kernels.ell_spmv import ops
from repro_torch.kernels.ell_spmv.kernel import ell_spmv
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def operands(r, d, semiring, b, device):
    rng = np.random.default_rng(r + d)
    cols = rng.integers(0, r + 1, size=(r, d)).astype(np.int32)
    xshape = (r + 1,) if b is None else (r + 1, b)
    if semiring == "minplus":
        vals = rng.integers(1, 100, size=(r, d)).astype(np.int32)
        x = rng.integers(0, 1000, size=xshape).astype(np.int32)
    else:
        vals = rng.random((r, d)).astype(np.float32)
        x = rng.random(xshape).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (cols, vals, x))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [None, 32])
@pytest.mark.parametrize("r,d", [(1000, 8), (1001, 32), (513, 40), (300, 128), (77, 512)])
@pytest.mark.parametrize("semiring", ["minplus", "plustimes"])
def test_kernel_matches_plain_version(cuda, semiring, r, d, b):
    cols, vals, x = operands(r, d, semiring, b, cuda)
    before = ell_spmv.launches
    got = ell_spmv(cols, vals, x, semiring=semiring)
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + 1
    want = ell_spmv_ref(cols, vals, x, semiring)
    if semiring == "minplus":
        assert torch.equal(got, want)
    else:   # the sums run in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_raises_on_non_contiguous_input(cuda):
    cols, vals, x = operands(64, 8, "minplus", 4, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmv(cols, vals, x[:, ::2])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 64])     # thread per row, warp per row
def test_kernel_asserts_on_a_column_past_x(cuda, d):
    """A column outside [0, M) stops the kernel with a device-side assert.
    It runs in a child process: the assert leaves the CUDA context unusable."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.ell_spmv.kernel import ell_spmv\n"
        f"cols = torch.zeros((64, {d}), dtype=torch.int32, device='cuda')\n"
        "cols[17, 3] = 65\n"
        "vals = torch.ones_like(cols)\n"
        "x = torch.zeros(65, dtype=torch.int32, device='cuda')\n"
        "ell_spmv(cols, vals, x)\n"
        "torch.cuda.synchronize()\n")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stdout + proc.stderr, proc.stderr[-2000:]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sssp", "sssp_pull", "pr"])
def test_cuda_backend_matches_local_on_the_card(cuda, name):
    g = preferential_attachment(600, m=6, seed=11, device=cuda)
    params = dict(src=0) if name != "pr" else dict(beta=1e-4, delta=0.85, maxIter=60)
    ell_spmv.launches = 0
    got = compile_bundled(name, backend="cuda").bind(g)(**params)
    assert ell_spmv.launches > 0
    want = compile_bundled(name, backend="local").bind(g)(**params)
    for key in want:
        if want[key].dtype.is_floating_point:
            torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-6)
        else:
            assert torch.equal(got[key], want[key]), key
    if name != "pr":
        assert int((got["dist"] < int(INF_I32)).sum()) > 1
        ops.relax_minplus.push_steps = ops.relax_minplus.pull_steps = 0
        pinned = compile_bundled(name, backend="cuda",
                                 schedule=Schedule(direction="pull")).bind(g)(**params)
        assert torch.equal(pinned["dist"], want["dist"])
        assert ops.relax_minplus.push_steps == 0 and ops.relax_minplus.pull_steps > 0
