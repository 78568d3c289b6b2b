"""The port's CUDA kernels on the card, against their plain versions.

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
from repro_torch.graph import INF_I32, from_edges, preferential_attachment, to_sliced_ell
from repro_torch.kernels.ell_spmv import ops
from repro_torch.kernels.ell_spmv.kernel import ell_spmv, ell_sweep
from repro_torch.kernels.ell_spmv.plan import build_sweep_plan
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref, ell_sweep_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.tc_matmul.kernel import tc_matmul
from repro_torch.kernels.tc_matmul.ref import tc_matmul_ref


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


def child_fails_with_device_assert(code):
    """Run `code` in a child process (a device-side assert leaves the CUDA
    context unusable) and check that it stopped on one."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stdout + proc.stderr, proc.stderr[-2000:]


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
    child_fails_with_device_assert(
        "import torch\n"
        "from repro_torch.kernels.ell_spmv.kernel import ell_spmv\n"
        f"cols = torch.zeros((64, {d}), dtype=torch.int32, device='cuda')\n"
        "cols[17, 3] = 65\n"
        "vals = torch.ones_like(cols)\n"
        "x = torch.zeros(65, dtype=torch.int32, device='cuda')\n"
        "ell_spmv(cols, vals, x)\n"
        "torch.cuda.synchronize()\n")


# --- the one-launch pull sweep ----------------------------------------------------

def star_graph(device):
    n = 700
    rng = np.random.default_rng(5)
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 300)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(0, n, 300)])
    return from_edges(n, src, dst, rng.integers(1, 101, len(src)), device=device)


def two_hub_graph(device):
    """Hub rows 3 and 5 at hub entries 0..599 and 600..1299."""
    n = 1000
    rng = np.random.default_rng(9)
    src = np.concatenate([np.arange(10, 610), np.arange(10, 710), rng.integers(10, n, 400)])
    dst = np.concatenate([np.full(600, 3), np.full(700, 5), rng.integers(10, 400, 400)])
    return from_edges(n, src, dst, rng.integers(1, 101, len(src)), device=device)


def all_hub_graph(device):
    n = 520
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return from_edges(n, src, dst, np.random.default_rng(2).integers(1, 101, len(src)),
                      device=device)


SWEEP_CASES = [("pa", 4096), ("star", 4096), ("star", 100), ("two_hubs", 7),
               ("two_hubs", 100), ("two_hubs", 128), ("two_hubs", 650), ("all_hubs", 4096),
               ("all_hubs", 1000), ("edgeless", 4096)]


def sweep_case(gname, device):
    if gname == "pa":
        return preferential_attachment(3000, m=8, seed=11, device=device)
    if gname == "edgeless":
        return from_edges(6, np.zeros(0, np.int64), np.zeros(0, np.int64), device=device)
    return {"star": star_graph, "two_hubs": two_hub_graph, "all_hubs": all_hub_graph}[gname](
        device)


@pytest.mark.gpu
@pytest.mark.parametrize("gname,chunk", SWEEP_CASES)
def test_sweep_matches_plain_version(cuda, gname, chunk):
    """The sweep against `ell_sweep_ref` on the same view and plan: int32
    equal, f32 at rtol 1e-5 (the sums run in another order); two plus-times
    calls are bitwise equal (fixed order, no atomics)."""
    g = sweep_case(gname, cuda)
    ell = to_sliced_ell(g, reverse=True)
    plan = build_sweep_plan(ell, chunk=chunk)
    n = g.num_nodes
    rng = np.random.default_rng(n + chunk)
    d = rng.integers(0, 500, n).astype(np.int32)
    d[rng.random(n) < 0.3] = INF_I32
    dist = torch.from_numpy(d).to(cuda)
    x = torch.where(torch.from_numpy(rng.random(n) < 0.5).to(cuda), dist, int(INF_I32))
    before = ell_sweep.launches
    got = ell_sweep(ell, plan, x, semiring="minplus", dist=dist)
    torch.cuda.synchronize()
    assert ell_sweep.launches == before + 1
    assert torch.equal(got, ell_sweep_ref(ell, plan, x, "minplus", dist))
    contrib = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    got = ell_sweep(ell, plan, contrib, semiring="plustimes")
    again = ell_sweep(ell, plan, contrib, semiring="plustimes")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ell_sweep_ref(ell, plan, contrib, "plustimes"),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["bucket", "hub"])
def test_sweep_asserts_on_a_column_past_n(cuda, where):
    """A bucket column above N (N itself is the sentinel) or a hub column
    at N stops the sweep with a device-side assert."""
    if where == "bucket":
        change = ("c = ell.cols[0].clone()\n"
                  "c[1, 0] = g.num_nodes + 1\n"
                  "ell = dataclasses.replace(ell, cols=(c,) + ell.cols[1:])\n")
    else:
        change = ("h = ell.hub_cols.clone()\n"
                  "h[5] = g.num_nodes\n"
                  "ell = dataclasses.replace(ell, hub_cols=h)\n")
    child_fails_with_device_assert(
        "import dataclasses\n"
        "import numpy as np\n"
        "import torch\n"
        "from repro_torch.graph import from_edges, to_sliced_ell\n"
        "from repro_torch.kernels.ell_spmv.kernel import ell_sweep\n"
        "from repro_torch.kernels.ell_spmv.plan import build_sweep_plan\n"
        "n = 700\n"
        "src = np.concatenate([np.arange(1, n), np.arange(0, n - 1)])\n"
        "dst = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n)])\n"
        "g = from_edges(n, src, dst, np.ones(len(src), np.int64), device='cuda')\n"
        "ell = to_sliced_ell(g, reverse=True)\n"
        + change +
        "x = torch.zeros(n, dtype=torch.int32, device='cuda')\n"
        "ell_sweep(ell, build_sweep_plan(ell), x, semiring='minplus', dist=x)\n"
        "torch.cuda.synchronize()\n")


@pytest.mark.gpu
def test_pull_relax_and_gather_launch_the_sweep(cuda):
    g = star_graph(cuda)
    ell = to_sliced_ell(g, reverse=True)
    dist = torch.full((g.num_nodes,), int(INF_I32), dtype=torch.int32, device=cuda)
    dist[0] = 0
    sweeps, tiles = ell_sweep.launches, ell_spmv.launches
    ops.relax_minplus(ell, dist, frontier=dist == 0, csr=g, direction="pull")
    ops.gather_plustimes(ell, torch.ones(g.num_nodes, device=cuda))
    assert (ell_sweep.launches - sweeps, ell_spmv.launches - tiles) == (2, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sssp", "sssp_pull", "pr"])
def test_cuda_backend_matches_local_on_the_card(cuda, name):
    g = preferential_attachment(600, m=6, seed=11, device=cuda)
    params = dict(src=0) if name != "pr" else dict(beta=1e-4, delta=0.85, maxIter=60)
    ell_sweep.launches = 0
    got = compile_bundled(name, backend="cuda").bind(g)(**params)
    assert ell_sweep.launches > 0
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


@pytest.mark.gpu
def test_sequential_ppr_launches_the_sweep(cuda):
    """Sequential ppr (batch_sources=1) gathers through `ell_sweep`, as
    the reference's sequential ppr gathers through its Pallas kernel."""
    g = preferential_attachment(600, m=6, seed=11, device=cuda)
    params = dict(beta=1e-4, delta=0.85, maxIter=60, sourceSet=[0, 7, 23])
    sched = Schedule(batch_sources=1)
    ell_sweep.launches = 0
    got = compile_bundled("ppr", backend="cuda", schedule=sched).bind(g)(**params)
    assert ell_sweep.launches > 0
    want = compile_bundled("ppr", backend="local", schedule=sched).bind(g)(**params)
    torch.testing.assert_close(got["ppr"], want["ppr"], rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("batch_sources", [1, 32])
@pytest.mark.parametrize("name", ["bc", "ppr", "tc", "cc", "lp", "kcore"])
def test_programs_on_the_card_match_the_cpu(cuda, name, batch_sources):
    """The batched engine and the wedge count run plain torch on the card:
    both backends there against the `local` backend on the CPU."""
    params = {"bc": dict(sourceSet=[0, 7, 23, 99, 250]),
              "ppr": dict(beta=1e-4, delta=0.85, maxIter=60, sourceSet=[0, 7, 23, 99, 250]),
              "kcore": dict(k=3)}.get(name, {})
    sched = Schedule(batch_sources=batch_sources)
    want = compile_bundled(name, backend="local", schedule=sched).bind(
        preferential_attachment(600, m=6, seed=11, device="cpu"))(**params)
    g = preferential_attachment(600, m=6, seed=11, device=cuda)
    for backend in ("local", "cuda"):
        got = compile_bundled(name, backend=backend, schedule=sched).bind(g)(**params)
        for key in want:
            a, b = want[key], got[key].cpu()
            if a.dtype.is_floating_point:
                torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6, equal_nan=True)
            else:
                assert torch.equal(b, a), (backend, key)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1 << 27, 1000])
def test_float_sums_on_the_card_round_once(cuda, chunk, monkeypatch):
    """float32 segment sums on the card accumulate in float64 and round
    once: a hub row of ~10^6 terms lands within an ulp of the float64 sum,
    whatever order the atomics take and however the edges are chunked."""
    from repro_torch.core import runtime as rt
    monkeypatch.setattr(rt, "_F64_CHUNK", chunk)
    rng = np.random.default_rng(5)
    e, n = 1 << 20, 64
    seg = np.sort(np.concatenate([np.zeros(e - 1000, np.int64), rng.integers(1, n, 1000)]))
    vals = rng.random((3, e)).astype(np.float32)
    want = np.stack([np.bincount(seg, weights=v.astype(np.float64), minlength=n)
                     for v in vals]).astype(np.float32)
    seg_t = torch.from_numpy(seg).to(cuda)
    vals_t = torch.from_numpy(vals).to(cuda)
    np.testing.assert_allclose(rt.segment_sum_batch(vals_t, seg_t, n).cpu().numpy(),
                               want, rtol=2.0 ** -23, atol=0)
    np.testing.assert_allclose(rt.segment_sum(vals_t[0], seg_t, n).cpu().numpy(),
                               want[0], rtol=2.0 ** -23, atol=0)
    base = torch.ones((3, n), device=cuda)
    np.testing.assert_allclose(rt.scatter_add_rows(base, seg_t, vals_t).cpu().numpy(),
                               (want.astype(np.float64) + 1).astype(np.float32),
                               rtol=2.0 ** -22, atol=0)



# --- the serving path: delta-stepping, updates, refresh, GraphService --------------

@pytest.mark.gpu
@pytest.mark.parametrize("delta", [1, 16, 64])
def test_delta_on_the_card(cuda, delta):
    """sssp, cc and lp under priority="delta": both backends on the card
    equal the default schedule; the cuda sssp run pinned to pull launches
    the sweep (auto may push every bucket on a small graph), the local one
    takes the compact `_dell` relax or its fallback."""
    g = preferential_attachment(600, m=6, seed=11, device=cuda)
    for name, params in (("sssp", dict(src=0)), ("cc", {}), ("lp", {})):
        want = compile_bundled(name, backend="local").bind(g)(**params)
        for backend in ("cuda", "local"):
            for direction in ("auto", "pull"):
                sched = Schedule(priority="delta", delta_bucket=delta, direction=direction)
                ell_sweep.launches = 0
                got = compile_bundled(name, backend=backend, schedule=sched).bind(g)(**params)
                if name == "sssp" and backend == "cuda" and direction == "pull":
                    assert ell_sweep.launches > 0
                for key in want:
                    assert torch.equal(got[key], want[key]), (name, backend, direction, key)


def write_batch(g, rng, k=60):
    n = g.num_nodes
    adds = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)], 1)
    idx = rng.choice(g.num_edges, k, replace=False)
    dels = np.stack([g.edge_src.cpu().numpy()[idx], g.indices.cpu().numpy()[idx]], 1)
    return adds, dels, rng.integers(1, 101, k)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7, 4096])
def test_patched_view_sweep_on_the_card(cuda, chunk):
    """The sweep on a patched view (padding rows mid-bucket, the sorted
    hub tail) against `ell_sweep_ref` on the same view and plan."""
    from repro_torch.core import get_context
    g = preferential_attachment(3000, m=8, seed=11, device=cuda)
    sched = Schedule(num_buckets=2, min_width=8, growth=2)
    get_context(g).sliced_ell(sched, reverse=True)
    delta = g.update(*write_batch(g, np.random.default_rng(chunk))[:2])
    ell = get_context(delta.graph).sliced_ell(sched, reverse=True)
    assert bool((ell.hub_rows[1:] >= ell.hub_rows[:-1]).all())
    plan = build_sweep_plan(ell, chunk=chunk)
    n = g.num_nodes
    rng = np.random.default_rng(n)
    dist = torch.from_numpy(rng.integers(0, 500, n).astype(np.int32)).to(cuda)
    got = ell_sweep(ell, plan, dist, semiring="minplus", dist=dist)
    assert torch.equal(got, ell_sweep_ref(ell, plan, dist, "minplus", dist))
    x = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    torch.testing.assert_close(ell_sweep(ell, plan, x, semiring="plustimes"),
                               ell_sweep_ref(ell, plan, x, "plustimes"), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sssp", "pr"])
def test_refresh_on_the_card(cuda, name):
    g = preferential_attachment(3000, m=8, seed=11, device=cuda)
    params = dict(src=0) if name == "sssp" else dict(beta=1e-6, delta=0.85, maxIter=200)
    prog = compile_bundled(name, backend="cuda", schedule=Schedule(refresh_threshold_frac=1.0))
    prev = prog.bind(g)(**params)
    delta = g.update(*write_batch(g, np.random.default_rng(1)))
    bound = prog.bind(delta.graph)
    ell_sweep.launches = 0
    warm = bound.refresh(prev, delta, **params)
    assert ell_sweep.launches > 0
    cold = bound(**params)
    if name == "sssp":
        assert torch.equal(warm["dist"], cold["dist"])
    else:
        torch.testing.assert_close(warm["pageRank"], cold["pageRank"], rtol=1e-3, atol=1e-7)


@pytest.mark.gpu
def test_graph_service_on_the_card(cuda):
    """GraphService on `cuda`: coalesced and lone answers equal the bound
    programs on the card; the lone sssp query launches the sweep."""
    import asyncio
    from repro_torch.core import runtime as rt
    from repro_torch.serve import GraphService, ServiceConfig
    g = preferential_attachment(3000, m=8, seed=11, device=cuda)
    srcs = [0, 5, 9, 17, 42, 99]

    async def main():
        async with GraphService(ServiceConfig(backend="cuda", max_wait_ms=10.0)) as svc:
            svc.register_graph("g", g)
            res = await asyncio.gather(*(svc.query("g", "sssp", src=s) for s in srcs),
                                       *(svc.query("g", "bfs", src=s) for s in srcs))
            ell_sweep.launches = 0
            lone = await svc.query("g", "sssp", src=7)
            return res, lone, ell_sweep.launches, svc.stats()

    res, lone, launches, st = asyncio.run(main())
    bound = compile_bundled("sssp", backend="cuda").bind(g)
    for s, row in zip(srcs, res[:len(srcs)]):
        assert np.array_equal(row, bound(src=s)["dist"].cpu().numpy()), s
    for s, row in zip(srcs, res[len(srcs):]):
        assert np.array_equal(row, rt.bfs_levels(g, s)[0].cpu().numpy()), s
    assert np.array_equal(lone, bound(src=7)["dist"].cpu().numpy())
    assert launches > 0 and st["max_batch"] > 1

# --- flash_attention ----------------------------------------------------------

def qkv(bh, sq, skv, d, dtype, device, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tuple(torch.randn((bh, s, d), generator=gen, device=device).to(dtype)
                 for s in (sq, skv, skv))


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,d", [
    (2, 128, 128, 64), (1, 256, 256, 32), (3, 128, 256, 64), (2, 64, 512, 128),
    (4, 32, 32, 128), (2, 32, 96, 64), (1, 100, 100, 32), (2, 8, 640, 128),
    (2, 4, 4, 64), (3, 1, 256, 128), (3, 100, 100, 64), (2, 130, 200, 128),
    (2, 1, 640, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda, bh, sq, skv, d, causal, dtype):
    """f32 at atol 2e-5, bf16 at 3e-2: the reference's own tolerances.
    SQ and SKV need not be multiples of the kernel's 128-row tiles (bq =
    SQ and bk = SKV keep the reference's block contract for any shape)."""
    q, k, v = qkv(bh, sq, skv, d, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, bq=sq, bk=skv)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-5 if dtype == torch.float32 else 3e-2)


def gqa_operands(sq, device):
    q = qkv(2 * 8, sq, sq, 64, torch.bfloat16, device)[0].reshape(2, 8, sq, 64)
    k, v = (t.reshape(2, 2, 128, 64) for t in qkv(2 * 2, 128, 128, 64, torch.bfloat16,
                                                  device, seed=1)[1:])
    return q, k, v


def gqa_plain(q, k, v):
    """The plain version of gqa_attention: KV heads repeated, attention_ref."""
    b, hq, sq, d = q.shape
    k, v = (t.repeat_interleave(hq // t.shape[1], dim=1).reshape(b * hq, -1, d)
            for t in (k, v))
    return attention_ref(q.reshape(b * hq, sq, d), k, v, causal=True).reshape(q.shape)


@pytest.mark.gpu
def test_gqa_attention_goes_through_the_kernel(cuda):
    q, k, v = gqa_operands(128, cuda)
    before = flash_attention.launches
    got = gqa_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), gqa_plain(q, k, v).float(), rtol=0, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 4])
def test_gqa_attention_short_queries_go_through_the_kernel(cuda, sq):
    """SQ < 8, which the reference sends to its plain version: the CUDA
    kernel masks its ragged edge and takes it."""
    q, k, v = gqa_operands(sq, cuda)
    before = flash_attention.launches
    got = gqa_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), gqa_plain(q, k, v).float(), rtol=0, atol=3e-2)


@pytest.mark.gpu
def test_gqa_attention_plain_version_raises_on_the_card(cuda):
    q, k, v = gqa_operands(128, cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        gqa_attention(q, k, v, use_kernel=False)


@pytest.mark.gpu
def test_flash_attention_raises_on_what_it_does_not_take(cuda):
    q, k, v = qkv(1, 64, 64, 96, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v)
    q, k, v = qkv(1, 64, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)


# --- tc_matmul ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n,block,p", [(64, 32, 0.1), (128, 128, 0.1), (384, 128, 0.05),
                                       (200, 100, 0.2), (1000, 200, 0.05),
                                       (1024, 128, 0.02)])
def test_tc_matmul_matches_plain_version(cuda, n, block, p):
    """0/1 operands: every count is an integer below 2^24, so exact. N off
    the kernel's 128 tiles (200, 1000) packs with zero padding."""
    rng = np.random.default_rng(n)
    lower = torch.from_numpy(np.tril((rng.random((n, n)) < p).astype(np.float32), -1)).to(cuda)
    before = tc_matmul.launches
    got = tc_matmul(lower, block=block)
    torch.cuda.synchronize()
    assert tc_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == float(tc_matmul_ref(lower)) > 0


@pytest.mark.gpu
def test_tc_matmul_asserts_on_a_strictly_lower_entry_not_0_or_1(cuda):
    """0.5 below the diagonal would pack to a wrong int8 count: the pack
    pass stops with a device-side assert instead. In a child process, as
    the assert leaves the CUDA context unusable."""
    child_fails_with_device_assert(
        "import torch\n"
        "from repro_torch.kernels.tc_matmul.kernel import tc_matmul\n"
        "lower = torch.zeros((256, 256), device='cuda')\n"
        "lower[200, 3] = 0.5\n"
        "print(float(tc_matmul(lower)))\n"
        "torch.cuda.synchronize()\n")


@pytest.mark.gpu
def test_tc_matmul_reads_only_the_strict_lower_triangle(cuda):
    rng = np.random.default_rng(5)
    a = (rng.random((256, 256)) < 0.1).astype(np.float32)
    full = torch.from_numpy(a).to(cuda)
    lower = torch.from_numpy(np.tril(a, -1)).to(cuda)
    assert float(tc_matmul(full)) == float(tc_matmul_ref(lower))


# --- the LM on the card -----------------------------------------------------------

@pytest.mark.gpu
def test_lm_kernel_path_matches_plain_path_on_the_card(cuda):
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"].smoke(), dtype="float32")
    m = build(cfg, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        got, _ = m({"tokens": toks}, impl="kernel", last_only=True)
        assert flash_attention.launches == before + cfg.n_layers
        want, _ = m({"tokens": toks}, impl="ref")
    torch.testing.assert_close(got[:, 0], want[:, -1], rtol=0, atol=1e-4)
