#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py                          # the smoke run: one card, RMAT scale 22
    python3 chip_smoke.py --trace                  # ... and where each run's time goes
    python3 chip_smoke.py --scale 10 --device cpu  # rehearsal of the plain versions

Phases, each printed with its own seconds; any failure exits non-zero:

  1. device  — the card's name, the device count and nvidia-smi's name and
               power limit;
  2. build   — nvcc builds every kernel of the port from the checkout's
               sources (one nvcc per source, all at once), printing the
               -Xptxas -v report, then one line per kernel of the two
               tensor-core libraries: registers, shared memory (static, and
               the dynamic bytes its launch asks for) and spills;
  3. graph   — rmat(scale, edge_factor=16, seed=0) on the card (scale 22:
               4,194,304 vertices, 67,108,864 sampled edges before dedup,
               the size of the paper's soc-LiveJournal1) and its reverse
               sliced-ELL view;
  4. kernels — the rectangular `ell_spmv` against its plain version
               `ell_spmv_ref` on every bucket shape of that view, for both
               semirings, in the SpMV form and the SpMM form (B = 32), plus
               random shapes: int32 results equal, f32 at rtol 1e-5 (sums
               run in another order). Times with CUDA events (warm-up, then
               the mean of 20 launches) beside the memory bound and, for
               plus-times, torch.sparse.mm on the same entries. Then the
               whole-view pull sweep `ell_sweep` against `ell_sweep_ref` on
               the same view and plan, for both semirings (int32 equal, f32
               at rtol 1e-5, two calls bitwise equal), timed beside its
               real-entry bound (HBM bytes, and the L2 sectors its x
               gathers pull at the L2 read rate measured in this run) and,
               for plus-times, one torch.sparse.mm over the whole reverse
               CSR with unit values;
  5. main    — compile_bundled(name, backend="cuda").bind(g)(...) for sssp,
               sssp pinned to pull, sssp_pull and pr; the second call is
               timed (host clock ending in synchronize()), with the
               kernels' launch counts (`ell_sweep`, `ell_spmv`) reset just
               before it and read just after; every run must launch the
               sweep. Then, on the same graph, the other bundled programs:
               bc over 32 sources drawn with --seed from the vertices of
               out-degree > 0 (one chunk of the default batch_sources) and
               over 2 of them with batch_sources=1, ppr (beta 1e-4, delta
               0.85, maxIter 20) over the 32 and over 4 with
               batch_sources=1 (which must launch `ell_sweep`), cc, lp and
               kcore with k = 8; each prints its BFS levels, [B, E] sums
               and sweeps, and its peak memory above what was allocated
               just before the call (the graph, its views, earlier results);
  6. check   — every result against the port's `local` backend on the same
               card (int32 outputs equal, pageRank and ppr at rtol 1e-4 and
               atol 1e-9: ranks are about 1/N; BC at rtol 1e-4 and atol
               1e-4 with its nan positions compared), dist against scipy's
               Dijkstra and pageRank against a float64 power iteration of
               the same length (rtol 1e-4); then phase `oracles` holds both
               backends on the card against host oracles in numpy/scipy on
               rmat(16) (bc: Brandes in float64 over 8 sources; ppr: a
               per-lane float64 iteration with the same stop rule; kcore
               k = 8: numpy peeling) and its symmetrised copy (cc and lp:
               the least vertex id of each connected component);
  7. trace   — with --trace only: one more call of each `cuda` run under
               torch.profiler (the graph runs of phase 5, batched bc and
               batched ppr among them), printing the device time by kernel,
               the device-busy share of the traced call (kernel time over
               wall time; one stream, so kernels do not overlap) and the
               traced call's wall time beside the untraced one (the
               tracing cost); the runs that only pull (sssp pinned to pull,
               pr) must show no scatter or index_add kernel; phase 9 then
               traces one prefill and one decode step the same way, and
               phase 10 three tc_matmul calls (pack and products);
  8. lm-kernels — `flash_attention` against `attention_ref` on the same
               seeded inputs: the reference's test shapes and two with
               SQ < 8 (f32 at atol 2e-5, bf16 at 3e-2, causal and not) and
               qwen2.5-3b's shape (BH 16, D 128, bf16, causal) at S = 32,
               512, 2048 and 4096, then three ragged shapes (SQ and SKV off
               the 128-row tiles); then at the path's shape, BH 16, S =
               32,768, against `attention_ref` run in blocks of 1,024 query
               rows (whole, its f32 scores would be 68.7 GB): elementwise
               at rtol = atol = 2^-7 and each block's rms error within 1% of
               its rms. The kernel is timed there with CUDA events beside
               its bound, that plain run and SDPA;
  9. lm      — qwen2.5-3b at full width and depth (3,086,200,832
               parameters, bf16, seeded init): a 32,768-token prefill
               through the kernel (second call timed; the kernel must launch
               once per layer, 36 times; peak memory counted above what
               earlier phases hold), kernel against plain end to end at
               2,048 tokens, and ServeEngine(max_len=64, batch_size=4)
               serving 4 prompts of 32 tokens with 16 new tokens each, the
               prefill forward held against the decode chain at position 31;
 10. tc      — rmat(14, edge_factor=16) → prepare_lower → count_triangles_dense
               on the card (N = 16,384), equal to a scipy count on the host
               and to `tc_matmul_ref`; the kernel (int8 wgmma) timed beside
               its bound (the strict-lower products at the int8 rate, the
               bf16 figure printed beside it), the plain version and a bf16
               matmul-and-mask. Then the DSL's tc, compile_bundled("tc",
               backend="cuda") on the symmetrised graph (the wedge count),
               equal to scipy's count and count_triangles_dense's there,
               with the wedge blocks' largest degree D, their chunk C and
               the second call's seconds.

The line before the last is {"kernels": [...]} (ell_spmv's two semirings,
reported by the sweep that the main path runs, flash_attention.bf16 and
tc_matmul.f32); the last line is {"ok": true,
"device": {...}}. Without a CUDA device the run fails; a `--device cpu`
rehearsal runs phases 3, 5, 6 and 8 to 10 with the plain versions at smoke
sizes (the LM's smoke config, a 256-token prefill, RMAT 8 for every
graph), prints no result line and exits 3: it is not a smoke run.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 on the tensor cores, dense
SOURCE = "src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu"
REPLACES = "src/repro/kernels/ell_spmv/kernel.py:76"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:81"
TC_SOURCE = "src/repro_torch/kernels/tc_matmul/csrc/tc_matmul.cu"
TC_REPLACES = "src/repro/kernels/tc_matmul/kernel.py:50"
TIMED_LAUNCHES = 20
INF = 2**30                   # INF_I32 of the graph layer
L2_PROBE_BYTES = 16 * 2**20   # a tensor that stays in the 50 MB L2
SECTOR_BYTES = 32             # what L2 moves for one random 4-byte gather
# logits of the full-size LM (std about 1): two bf16 paths through 36
# layers agree within this (PERF.md, "lm" phase)
LM_LOGIT_ATOL = 0.25


def phase(name, t0, detail=""):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {detail}".rstrip(), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def import_port():
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch
    pkg = os.path.dirname(os.path.abspath(repro_torch.__file__))
    if not pkg.startswith(os.path.join(HERE, "src") + os.sep):
        fail(f"repro_torch imported from {pkg}, not from this checkout")


# --------------------------------------------------------------------------
# kernel vs plain
# --------------------------------------------------------------------------

def cuda_ms(fn, n=TIMED_LAUNCHES, warm=3):
    import torch
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(r, d, m, b):
    """Least time for one call: bytes (cols, vals read once, the m rows of x
    that the columns reach read once, y written once) over HBM rate vs 2
    ops per cell and lane over the f32 rate; the larger wins."""
    t_bytes = (2 * r * d + m * b + r * b) * 4 / HBM_BYTES_PER_S
    t_ops = 2 * r * d * b / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_call(cols, vals, x, n_sentinel):
    """torch.sparse.mm on the bucket's real entries (pads dropped): the
    same plus-times function, for the yardstick only."""
    import warnings

    import torch
    real = cols < n_sentinel
    crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(real.sum(dim=1), 0)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, cols[real].long(), vals[real],
                                    size=(cols.shape[0], x.shape[0]))
    if x.ndim == 1:
        return lambda: torch.sparse.mm(a, x[:, None])[:, 0]
    return lambda: torch.sparse.mm(a, x)


def check_kernel(name, cols, vals, x, semiring, n_sentinel, timed=True):
    import torch
    from repro_torch.kernels.ell_spmv.kernel import ell_spmv
    from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref
    got = ell_spmv(cols, vals, x, semiring=semiring)
    torch.cuda.synchronize()
    want = ell_spmv_ref(cols, vals, x, semiring)
    if semiring == "minplus":
        if not torch.equal(got, want):
            fail(f"{name}: kernel != plain version")
        err = 0.0
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        err = float((got - want).abs().max())
    r, d = cols.shape
    b = 1 if x.ndim == 1 else x.shape[1]
    row = dict(name=name, semiring=semiring, R=r, D=d, M=x.shape[0], B=b,
               max_abs_err=err)
    if timed:
        row["ms"] = cuda_ms(lambda: ell_spmv(cols, vals, x, semiring=semiring))
        row["plain_ms"] = cuda_ms(lambda: ell_spmv_ref(cols, vals, x, semiring))
        # x rows this call must read: the distinct columns it gathers
        m_read = int(torch.unique(cols).numel())
        row["x_rows_read"] = m_read
        row["bound_ms"], row["bound_by"] = bound_ms(r, d, m_read, b)
        row["library_ms"] = None
        if semiring == "plustimes":
            lib = library_call(cols, vals, x, n_sentinel)
            lib_err = float((lib() - want).abs().max())
            if not lib_err <= 1e-5 * float(want.abs().max()) + 1e-6:
                fail(f"{name}: torch.sparse.mm disagrees ({lib_err})")
            row["library_ms"] = cuda_ms(lib)
    return row


def kernel_phase(ell, n, seed):
    """Every bucket shape of the reverse view × semiring × form, then a few
    random shapes (as in tests/test_kernels.py)."""
    import torch
    dev = ell.cols[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for b in (1, 32):
        xshape = (n + 1,) if b == 1 else (n + 1, b)
        xi = torch.randint(0, 1 << 20, xshape, generator=gen, device=dev, dtype=torch.int32)
        xf = torch.rand(xshape, generator=gen, device=dev)
        xi[n] = 0
        xf[n] = 0
        for cols, wts in zip(ell.cols, ell.wts):
            tag = f"bucket D={cols.shape[1]} B={b}"
            rows.append(check_kernel(tag, cols, wts, xi, "minplus", n))
            ones = torch.ones(cols.shape, dtype=torch.float32, device=dev)
            rows.append(check_kernel(tag, cols, ones, xf, "plustimes", n))
    rng = np.random.default_rng(seed)
    for r, d in ((64, 8), (128, 16), (96, 24), (1000, 40), (777, 64)):
        for b in (1, 32):
            cols = torch.from_numpy(rng.integers(0, r + 1, (r, d)).astype(np.int32)).to(dev)
            xshape = (r + 1,) if b == 1 else (r + 1, b)
            vi = torch.from_numpy(rng.integers(1, 100, (r, d)).astype(np.int32)).to(dev)
            xi = torch.from_numpy(rng.integers(0, 1000, xshape).astype(np.int32)).to(dev)
            vf = torch.from_numpy(rng.random((r, d)).astype(np.float32)).to(dev)
            xf = torch.from_numpy(rng.random(xshape).astype(np.float32)).to(dev)
            tag = f"random R={r} D={d} B={b}"
            rows.append(check_kernel(tag, cols, vi, xi, "minplus", r + 1, timed=False))
            rows.append(check_kernel(tag, cols, vf, xf, "plustimes", r + 1, timed=False))
    return rows


def l2_read_rate(dev, reps=256):
    """Bytes per second that one torch.sum reads when it sums `reps`
    broadcast copies of a 16 MiB float32 tensor (a stride-0 dimension, so
    every copy after the first is read from L2): the L2 read rate measured
    in this run. The fastest of the torch reductions tried on the H100
    (PERF.md); a floor on the L2's peak, not the peak itself."""
    import torch
    t = torch.ones(L2_PROBE_BYTES // 4, device=dev).view(1, -1).expand(reps, -1)
    return reps * L2_PROBE_BYTES / (cuda_ms(lambda: t.sum(dim=0), n=20) / 1e3)


def sweep_bound(ell, semiring, l2_rate):
    """Least time for one sweep from its real entries: each real edge's
    column (and weight, min-plus) read once, the bucket row ids once, x
    (and dist) read once and y written once, over the HBM rate; beside it
    the L2 figure, one 32-byte sector per x gather over the measured L2
    rate (a floor on the L2's peak, so this figure is a ceiling on the
    time L2 alone needs); and the operations (an add and a min, or an
    add, per edge)."""
    n = ell.num_nodes
    edges = sum(int((c < n).sum()) for c in ell.cols) + int(ell.hub_rows.shape[0])
    rows = sum(int((r < n).sum()) for r in ell.rows)
    minplus = semiring == "minplus"
    hbm_bytes = edges * (8 if minplus else 4) + rows * 4 + (3 if minplus else 2) * n * 4
    t_bytes = hbm_bytes / HBM_BYTES_PER_S
    t_ops = edges * (2 if minplus else 1) / F32_OPS_PER_S
    l2_bytes = edges * SECTOR_BYTES
    t_l2 = l2_bytes / l2_rate
    return dict(real_edges=edges, bucket_rows=rows, hbm_bytes=hbm_bytes,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                l2_sector_bytes=l2_bytes, l2_bytes_per_s=l2_rate, bound_l2_ms=1e3 * t_l2,
                binds="l2" if t_l2 > max(t_bytes, t_ops) else "hbm")


def whole_graph_spmv(g):
    """torch.sparse.mm over the whole reverse CSR with unit values: the
    plus-times sweep's function, for the yardstick only."""
    import warnings

    import torch
    n = g.num_nodes
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(g.rev_indptr.long(), g.rev_indices.long(),
                                    torch.ones(g.num_edges, device=g.device), size=(n, n))
    return lambda x: torch.sparse.mm(a, x[:, None])[:, 0]


def sweep_phase(g, ell, seed):
    """The one-launch pull sweep over the whole view against its plain
    version on the same plan, for both semirings, timed beside its bound
    and (plus-times) torch.sparse.mm."""
    import torch
    from repro_torch.core import get_context
    from repro_torch.kernels.ell_spmv.kernel import ell_sweep
    from repro_torch.kernels.ell_spmv.ref import ell_sweep_ref
    plan = get_context(g).sweep_plan(None)     # the plan the main path uses
    n, dev = g.num_nodes, g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dist = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev, dtype=torch.int32)
    dist[torch.rand(n, generator=gen, device=dev) < 0.3] = INF
    x = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, dist, INF)
    contrib = torch.rand(n, generator=gen, device=dev)
    l2_rate = l2_read_rate(dev)
    rows = {}
    for semiring, xs, d in (("minplus", x, dist), ("plustimes", contrib, None)):
        def kernel(xs=xs, d=d, semiring=semiring):
            return ell_sweep(ell, plan, xs, semiring=semiring, dist=d)

        def plain(xs=xs, d=d, semiring=semiring):
            return ell_sweep_ref(ell, plan, xs, semiring, d)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain()
        if not torch.equal(got, again):
            fail(f"ell_sweep {semiring}: two calls differ")
        if semiring == "minplus":
            if not torch.equal(got, want):
                fail("ell_sweep minplus != ell_sweep_ref")
            err = 0.0
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            err = float((got - want).abs().max())
        row = dict(name=f"sweep {semiring}", N=n, hub_entries=int(ell.hub_rows.shape[0]),
                   chunks=plan.num_chunks, spanning_rows=int(plan.span_rows.shape[0]),
                   zero_rows=int(plan.zero_rows.shape[0]), blocks=plan.num_blocks,
                   max_abs_err=err, ms=cuda_ms(kernel),
                   plain_ms=cuda_ms(plain, n=5, warm=1), library_ms=None,
                   **sweep_bound(ell, semiring, l2_rate))
        # the x gathers' sector traffic over the kernel's time
        row["sector_bytes_per_s"] = row["l2_sector_bytes"] / (row["ms"] / 1e3)
        if semiring == "plustimes":
            lib = whole_graph_spmv(g)
            lib_err = float((lib(xs) - got).abs().max())
            if not lib_err <= 1e-5 * float(got.abs().max()) + 1e-6:
                fail(f"torch.sparse.mm disagrees with the sweep ({lib_err})")
            row["library_ms"] = cuda_ms(lambda: lib(xs))
        rows[semiring] = row
    return rows


def kernel_name(mangled):
    """`tc_wgmma`, `flash_fwd_bf16<128>`: the last name of an Itanium-mangled
    function and its one integer template argument, if any."""
    m = re.match(r"_ZN?", mangled)
    rest, names = mangled[m.end():] if m else mangled, []
    while rest[:1].isdigit():
        n = int(re.match(r"\d+", rest).group())
        digits = len(str(n))
        names.append(rest[digits:digits + n])
        rest = rest[digits + n:]
    arg = re.match(r"ILi(\d+)E", rest)
    return (names[-1] if names else mangled) + (f"<{arg.group(1)}>" if arg else "")


def ptxas_summary(logs):
    """One row per kernel of the two tensor-core libraries from nvcc's
    -Xptxas -v report: registers, static shared memory, spills, and the
    dynamic shared memory its launch asks for (which ptxas does not see)."""
    from repro_torch.kernels.flash_attention.kernel import _library as flash_library
    from repro_torch.kernels.tc_matmul.kernel import _library as tc_library
    dynamic = {"tc_wgmma": tc_library().tc_matmul_smem_bytes()}
    for d in (32, 64, 128):
        dynamic[f"flash_fwd_bf16<{d}>"] = flash_library().flash_attention_bf16_smem_bytes(d)
    def num(pattern, block):
        m = re.search(pattern, block)
        return int(m.group(1)) if m else 0

    rows = []
    for lib in ("tc_matmul", "flash_attention"):
        for block in logs.get(lib, "").split("Compiling entry function '")[1:]:
            name = kernel_name(block.split("'")[0])
            rows.append(dict(library=lib, kernel=name,
                             registers=num(r"Used (\d+) registers", block),
                             static_smem_bytes=num(r"(\d+) bytes smem", block),
                             dynamic_smem_bytes=dynamic.get(name, 0),
                             spill_store_bytes=num(r"(\d+) bytes spill stores", block),
                             spill_load_bytes=num(r"(\d+) bytes spill loads", block)))
    return rows


# --------------------------------------------------------------------------
# main path + oracles
# --------------------------------------------------------------------------

RUNS = (("sssp", "auto", dict(src=0)),
        ("sssp", "pull", dict(src=0)),
        ("sssp_pull", "auto", dict(src=0)),
        ("pr", "auto", dict(beta=1e-4, delta=0.85, maxIter=100)))
SET_SOURCES = 32       # one chunk of the default Schedule.batch_sources
PPR_PARAMS = dict(beta=1e-4, delta=0.85, maxIter=20)


def set_runs(srcs):
    """(program, run, Schedule knobs, params) of the other bundled programs:
    bc and ppr over `srcs` batched and over a few of them one source at a
    time, then cc, lp and kcore."""
    return (("bc", "batched", {}, dict(sourceSet=srcs)),
            ("bc", "sequential", dict(batch_sources=1), dict(sourceSet=srcs[:2])),
            ("ppr", "batched", {}, dict(PPR_PARAMS, sourceSet=srcs)),
            ("ppr", "sequential", dict(batch_sources=1), dict(PPR_PARAMS, sourceSet=srcs[:4])),
            ("cc", "auto", {}, {}),
            ("lp", "auto", {}, {}),
            ("kcore", "auto", {}, dict(k=8)))


def pick_sources(g, count, seed):
    """`count` distinct vertices of out-degree > 0, drawn with `seed`."""
    cand = np.flatnonzero(g.out_degree.cpu().numpy() > 0)
    return np.random.default_rng(seed).choice(cand, count, replace=False).astype(np.int32)


def drive(g, backend, name, run, params, on_card, knobs=None):
    """Compile, bind, call once to warm, then the timed call with the
    launch, step and engine counters set to 0 just before it and read just
    after (`launches`: the rectangular `ell_spmv`; `sweep_launches`:
    `ell_sweep`; `bfs_*`: the BFS calls and their levels; `batch_sums`:
    the [B, E] segment sums). `knobs` are the Schedule's; None pins the
    direction to `run`. The peak is counted above what is allocated just
    before the timed call."""
    import torch
    from repro_torch.core import Schedule, compile_bundled
    from repro_torch.core import runtime as rt
    from repro_torch.kernels.ell_spmv import ops
    from repro_torch.kernels.ell_spmv.kernel import ell_spmv, ell_sweep
    sched = Schedule(**(dict(direction=run) if knobs is None else knobs))
    bound = compile_bundled(name, backend=backend, schedule=sched).bind(g)
    bound(**params)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    held = torch.cuda.memory_allocated() if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ell_spmv.launches = ell_sweep.launches = 0
    ops.relax_minplus.push_steps = ops.relax_minplus.pull_steps = 0
    rt.bfs_levels_batch.calls = rt.bfs_levels_batch.levels = 0
    rt.segment_sum_batch.calls = 0
    t = time.perf_counter()
    out = bound(**params)
    sync()
    secs = time.perf_counter() - t
    info = dict(program=name, backend=backend, run=run, direction=sched.direction,
                batch_sources=sched.batch_sources, seconds=secs,
                launches=ell_spmv.launches, sweep_launches=ell_sweep.launches,
                push_steps=ops.relax_minplus.push_steps,
                pull_steps=ops.relax_minplus.pull_steps,
                bfs_calls=rt.bfs_levels_batch.calls, bfs_levels=rt.bfs_levels_batch.levels,
                batch_sums=rt.segment_sum_batch.calls,
                peak_bytes=torch.cuda.max_memory_allocated() if on_card else None,
                held_bytes=held,
                peak_above_held_bytes=torch.cuda.max_memory_allocated() - held if on_card
                else None)
    if name == "pr":
        info["iterations"] = int(out["iterCount"])
    elif name in ("sssp", "sssp_pull"):
        info["iterations"] = info["push_steps"] + info["pull_steps"] if backend == "cuda" \
            else None
    if "finished" in out:
        info["finished"] = bool(out["finished"])
    if "sourceSet" in params:
        info["sources"] = len(params["sourceSet"])
    return bound, out, info


def trace_run(fn, top=12):
    """One more call of `fn` under torch.profiler: device time by kernel and
    the device-busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    rows = []
    for ev in prof.key_averages():
        # kernels only: an aten op's row repeats the device time of the
        # kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    if busy_s == 0:
        fail("torch.profiler recorded no device time")
    return dict(traced_ms=traced_s * 1e3, device_busy_ms=busy_s * 1e3,
                idle_share=1 - busy_s / traced_s,
                top=[dict(kernel=k[:90], ms=d / 1e3, calls=c) for d, k, c in rows[:top]],
                kernels=[k for _, k, _ in rows])


def dijkstra_ref(g, src=0):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = g.num_nodes
    a = sp.csr_matrix((g.weights.cpu().numpy().astype(np.float64),
                       g.indices.cpu().numpy(), g.indptr.cpu().numpy()), shape=(n, n))
    d = dijkstra(a, directed=True, indices=src)
    return np.where(np.isinf(d), 2**30, d).astype(np.int64)


def pagerank_ref(g, iters, delta=0.85):
    """float64 power iteration of pr.sp's update, `iters` sweeps."""
    import scipy.sparse as sp
    n = g.num_nodes
    src = g.edge_src.cpu().numpy()
    dst = g.indices.cpu().numpy()
    outdeg = g.out_degree.cpu().numpy().astype(np.float64)
    a = sp.csr_matrix((1.0 / outdeg[src], (dst, src)), shape=(n, n))
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        rank = (1 - delta) / n + delta * (a @ rank)
    return rank


def check_results(g, results, t0):
    import torch
    dist_ref = dijkstra_ref(g)
    for (name, direction), out in results["cuda"].items():
        compare_outputs(out, results["local"][(name, direction)],
                        f"{name}/{direction} cuda vs local")
        for key, got in out.items():
            if got.dtype.is_floating_point and not bool(torch.isfinite(got).all()):
                fail(f"{name}.{key}: non-finite values")
        if name == "pr":
            iters = int(out["iterCount"])
            rank = pagerank_ref(g, iters)
            got = out["pageRank"].double().cpu().numpy()
            np.testing.assert_allclose(got, rank, rtol=1e-4, atol=0)
            print(f"  pr: {iters} iterations, max rel err vs float64 "
                  f"{float(np.max(np.abs(got - rank) / rank)):.3e}")
        else:
            dist = out["dist"].cpu().numpy().astype(np.int64)
            if not np.array_equal(dist, dist_ref):
                bad = int(np.sum(dist != dist_ref))
                fail(f"{name}/{direction}: dist differs from Dijkstra at {bad} vertices")
            print(f"  {name}/{direction}: dist == Dijkstra "
                  f"({int(np.sum(dist < 2**30))} reachable)")
    phase("check", t0, "cuda == local, dist == Dijkstra, pageRank == float64 iteration")


def compare_outputs(got, want, what):
    """`cuda` against `local` on the card: int32 and bool outputs equal;
    BC at rtol 1e-4, atol 1e-4 with its nan positions compared, not its
    values (sigma overflows float32 on deep graphs in both reference
    backends); ppr and pageRank at rtol 1e-4, atol 1e-9 (ranks are about
    1/N). Other floats (pr's `diff`, an L1 sum of tiny differences) are
    not compared: only the ranks and the iteration count."""
    import torch
    for key, w in want.items():
        x = got[key]
        if tuple(x.shape) != tuple(w.shape) or x.dtype != w.dtype:
            fail(f"{what}.{key}: {tuple(x.shape)} {x.dtype} vs {tuple(w.shape)} {w.dtype}")
        if not x.dtype.is_floating_point:
            if not torch.equal(x, w):
                fail(f"{what}.{key}: {int((x != w).sum())} entries differ")
        elif key == "BC":
            if not torch.equal(torch.isnan(x), torch.isnan(w)):
                fail(f"{what}.BC: nan positions differ")
            ok = ~torch.isnan(w)
            torch.testing.assert_close(x[ok], w[ok], rtol=1e-4, atol=1e-4)
        elif key in ("ppr", "pageRank"):
            torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-9)


def check_set_results(set_results):
    for (name, run), out in set_results["cuda"].items():
        compare_outputs(out, set_results["local"][(name, run)], f"{name}/{run} cuda vs local")
        if name == "bc":
            bc = out["BC"]
            detail = dict(nan=int(bc.isnan().sum()), max=float(bc[~bc.isnan()].max()))
        elif name == "ppr":
            detail = dict(sum=float(out["ppr"].sum()))
        elif name in ("cc", "lp"):
            key = "comp" if name == "cc" else "label"
            detail = dict(distinct=int(out[key].unique().numel()))
        elif name == "kcore":
            detail = dict(survivors=int(out["core"].sum()))
        print(f"  {name}/{run}: cuda == local {json.dumps(detail)}")


# --------------------------------------------------------------------------
# host oracles (numpy/scipy) for the other bundled programs
# --------------------------------------------------------------------------

def host_csr(g):
    import scipy.sparse as sp
    n = g.num_nodes
    src, dst = g.edge_src.cpu().numpy(), g.indices.cpu().numpy()
    return sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)), src, dst


def brandes_ref(g, sources):
    """Brandes BC in float64 over bc.sp's out-edge BFS DAG, one source at a
    time and one level at a time as sparse products: sigma of level l + 1
    sums the sigma of level l over in-edges from it; delta(v) = sigma(v) ·
    Σ over DAG successors w of (1 + delta(w)) / sigma(w); BC sums delta
    over every reached v but the source."""
    a, _, _ = host_csr(g)
    at = a.T.tocsr()
    n = g.num_nodes
    bc = np.zeros(n)
    for s in sources:
        level = np.full(n, -1)
        level[s] = 0
        frontier = np.zeros(n)
        frontier[s] = 1.0
        depth = 0
        while True:
            new = (at @ frontier > 0) & (level < 0)
            if not new.any():
                break
            depth += 1
            level[new] = depth
            frontier = new.astype(np.float64)
        sigma = np.zeros(n)
        sigma[s] = 1.0
        for k in range(depth):
            nxt = level == k + 1
            sigma[nxt] = (at @ np.where(level == k, sigma, 0.0))[nxt]
        delta = np.zeros(n)
        for k in range(depth - 1, -1, -1):
            nxt = level == k + 1
            term = np.where(nxt, (1.0 + delta) / np.where(nxt, sigma, 1.0), 0.0)
            cur = level == k
            delta[cur] = (sigma * (a @ term))[cur]
        reached = level >= 0
        reached[s] = False
        bc[reached] += delta[reached]
    return bc


def ppr_ref(g, sources, beta, delta, max_iter):
    """ppr.sp per lane in float64: rank' = (1 - delta)·restart + delta ·
    Σ over in-neighbours u of rank(u)/outdeg(u), stopping after the sweep
    whose L1 change is at most beta or the max_iter-th; the lanes summed.
    Returns (sum, sweeps per lane)."""
    import scipy.sparse as sp
    n = g.num_nodes
    _, src, dst = host_csr(g)
    outdeg = g.out_degree.cpu().numpy().astype(np.float64)
    pull = sp.csr_matrix((1.0 / outdeg[src], (dst, src)), shape=(n, n))
    total, sweeps = np.zeros(n), []
    for s in sources:
        restart = np.zeros(n)
        restart[s] = 1.0
        rank, it = restart, 0
        while True:
            nxt = (1 - delta) * restart + delta * (pull @ rank)
            diff = np.abs(nxt - rank).sum()
            rank, it = nxt, it + 1
            if not (diff > beta and it < max_iter):
                break
        total += rank
        sweeps.append(it)
    return total, sweeps


def component_min_ref(g):
    """The least vertex id of each weakly connected component."""
    from scipy.sparse.csgraph import connected_components
    a, _, _ = host_csr(g)
    ncomp, lab = connected_components(a, directed=True, connection="weak")
    least = np.full(ncomp, g.num_nodes)
    np.minimum.at(least, lab, np.arange(g.num_nodes))
    return least[lab].astype(np.int32)


def kcore_ref(g, k):
    """kcore.sp's peeling in numpy: each sweep drops every survivor with
    fewer than k surviving out-neighbours, until a sweep drops none."""
    _, src, dst = host_csr(g)
    core = np.ones(g.num_nodes, bool)
    while True:
        live = core[src] & core[dst]
        peel = core & (np.bincount(src[live], minlength=g.num_nodes) < k)
        if not peel.any():
            return core.astype(np.int32)
        core &= ~peel


def symmetrised(g):
    from repro_torch.graph import from_edges
    return from_edges(g.num_nodes, g.edge_src.cpu().numpy(), g.indices.cpu().numpy(),
                      g.weights.cpu().numpy(), undirected=True, device=g.device)


def oracle_phase(scale, seed, dev):
    """Both backends on the card against the host oracles: bc, ppr (batched
    and one source at a time) and kcore on rmat(scale), cc and lp on its
    symmetrised copy."""
    import torch
    from repro_torch.core import Schedule, compile_bundled
    from repro_torch.graph import rmat
    g = rmat(scale, edge_factor=16, seed=seed, device=dev)
    gs = symmetrised(g)
    srcs = pick_sources(g, 8, seed)
    least = component_min_ref(gs)
    beta, delta, max_iter = (PPR_PARAMS[k] for k in ("beta", "delta", "maxIter"))
    ppr_sum, sweeps = ppr_ref(g, srcs, beta, delta, max_iter)
    ppr_seq, _ = ppr_ref(g, srcs[:4], beta, delta, max_iter)
    cases = (("bc", {}, g, dict(sourceSet=srcs), "BC", brandes_ref(g, srcs)),
             ("ppr", {}, g, dict(PPR_PARAMS, sourceSet=srcs), "ppr", ppr_sum),
             ("ppr", dict(batch_sources=1), g, dict(PPR_PARAMS, sourceSet=srcs[:4]), "ppr",
              ppr_seq),
             ("kcore", {}, g, dict(k=8), "core", kcore_ref(g, 8)),
             ("cc", {}, gs, {}, "comp", least),
             ("lp", {}, gs, {}, "label", least))
    for name, knobs, graph, params, key, want in cases:
        for backend in ("cuda", "local"):
            got = compile_bundled(name, backend=backend, schedule=Schedule(**knobs)).bind(
                graph)(**params)[key].cpu().numpy()
            what = f"{name}{'/sequential' if knobs else ''} {backend} on rmat({scale})" \
                   f"{' symmetrised' if graph is gs else ''}"
            if got.dtype.kind == "f":
                if not np.isfinite(got).all():
                    fail(f"{what}: non-finite values")
                atol = 1e-4 if name == "bc" else 1e-9
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=what)
                err = float(np.max(np.abs(got - want)))
            else:
                if not np.array_equal(got, want):
                    fail(f"{what}: {int((got != want).sum())} vertices differ from the oracle")
                err = 0.0
            print(f"  {what}: == oracle (max abs err {err:.3e})")
    print(f"  rmat({scale}): N={g.num_nodes} E={g.num_edges}, symmetrised E={gs.num_edges}; "
          f"ppr oracle sweeps per lane {sweeps}; components {len(np.unique(least))}")
    del g, gs
    if dev == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# LM: flash_attention against its plain version, then the model's paths
# --------------------------------------------------------------------------

FLASH_TEST_SHAPES = ((2, 128, 128, 64), (1, 256, 256, 32), (3, 128, 256, 64),
                     (2, 64, 512, 128))   # tests/test_kernels.py:180-200
# SQ < 8, which the reference leaves to its plain version (a TPU tiling
# limit); the CUDA kernel takes it, as gqa_attention sends it there
FLASH_SHORT_SHAPES = ((2, 4, 4, 64), (3, 1, 256, 128))
# SQ and SKV off the kernel's 128-row tiles (bq = SQ, bk = SKV)
FLASH_RAGGED_SHAPES = ((3, 100, 100, 64), (2, 130, 200, 128), (2, 1, 640, 32))
# the kernel against the plain version at the path's shape, bf16:
# elementwise |kernel - plain| <= FLASH_RTOL·|plain| + FLASH_ATOL, and per
# block of query rows rms(kernel - plain) <= FLASH_REL_RMS · rms(plain)
# (PERF.md, "Tolerances")
FLASH_RTOL = FLASH_ATOL = 2.0 ** -7
FLASH_REL_RMS = 1e-2
PLAIN_CHUNK = 1024


def attention_ref_in_chunks(q, k, v, chunk):
    """Causal attention_ref, one block of `chunk` query rows at a time
    against the kv rows that block can see: the same function as one
    call, with only [BH, chunk, <= SKV] f32 scores live at once. Each
    block's causal offset SKV' - SQ' is its first row plus SKV - SQ."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    sq, skv = q.shape[1], k.shape[1]
    if skv < sq:
        raise ValueError(f"SKV={skv} < SQ={sq}: some rows see no kv row")
    out = torch.empty_like(q)
    for i in range(0, sq, chunk):
        j = min(i + chunk, sq)
        end = j + skv - sq
        out[:, i:j] = attention_ref(q[:, i:j], k[:, :end], v[:, :end], causal=True)
    return out


def flash_vs_plain(got, want, chunk):
    """Elementwise excess over the tolerance and the worst per-block
    relative rms error of the kernel's output against the plain one."""
    diff = (got.float() - want.float()).abs()
    excess = float((diff - FLASH_RTOL * want.float().abs()).max())
    rel_rms = 0.0
    for i in range(0, got.shape[1], chunk):
        d, w = diff[:, i:i + chunk], want[:, i:i + chunk].float()
        rel_rms = max(rel_rms, float(d.square().mean().sqrt() / w.square().mean().sqrt()))
    return float(diff.max()), excess, rel_rms


def flash_bound_ms(bh, sq, skv, d, causal, itemsize):
    """4·D FLOPs per (query, kv) pair that the mask keeps, over the bf16
    tensor-core rate, vs q, k, v read once and o written once."""
    offset = skv - sq
    if causal:
        i = np.arange(sq, dtype=np.int64)
        pairs = int(np.clip(i + offset + 1, 0, skv).sum())
    else:
        pairs = sq * skv
    flops = 4 * d * pairs * bh
    t_ops = flops / BF16_OPS_PER_S
    t_bytes = (2 * bh * sq * d + 2 * bh * skv * d) * itemsize / HBM_BYTES_PER_S
    return flops, 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lm_kernel_phase(seed, dev, on_card, long_seq):
    """flash_attention against attention_ref on the same inputs: the
    reference's test shapes and two with SQ < 8 (f32 at atol 2e-5, bf16 at
    3e-2, causal and not), qwen2.5-3b's shape (BH 16, D 128, bf16, causal)
    up to S = 4,096, then at the path's shape `long_seq`, where the plain
    version runs in blocks of query rows; the kernel timed there beside the
    plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def operands(bh, sq, skv, d, dtype):
        return tuple(torch.randn((bh, s, d), generator=gen, device=dev).to(dtype)
                     for s in (sq, skv, skv))

    cases = [(shape, causal, dtype) for dtype in (torch.float32, torch.bfloat16)
             for shape in FLASH_TEST_SHAPES + FLASH_SHORT_SHAPES + FLASH_RAGGED_SHAPES
             for causal in (True, False)]
    qwen_lengths = (32, 512, 2048, 4096) if on_card else (32,)
    cases += [((16, s, s, 128), True, torch.bfloat16) for s in qwen_lengths]
    rows, bf16_err = [], 0.0
    for shape, causal, dtype in cases:
        q, k, v = operands(*shape, dtype)
        blocks = dict(bq=shape[1], bk=shape[2]) if shape in FLASH_RAGGED_SHAPES else {}
        got = flash_attention(q, k, v, causal=causal, **blocks)
        want = attention_ref(q, k, v, causal=causal)
        atol = 2e-5 if dtype == torch.float32 else 3e-2
        err = float((got.float() - want.float()).abs().max())
        if not err <= atol:
            fail(f"flash_attention {shape} causal={causal} {dtype}: max abs err {err} > {atol}")
        if dtype == torch.bfloat16:
            bf16_err = max(bf16_err, err)
        rows.append(dict(shape=shape, causal=causal, dtype=str(dtype), max_abs_err=err,
                         atol=atol))
    for row in rows:
        print("  " + json.dumps(row))
    bh, s, d = 16, long_seq, 128
    chunk = PLAIN_CHUNK if on_card else 64
    q, k, v = operands(bh, s, s, d, torch.bfloat16)
    flops, bound, bound_by = flash_bound_ms(bh, s, s, d, True, 2)
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref_in_chunks(q, k, v, chunk)
    err, excess, rel_rms = flash_vs_plain(got, want, chunk)
    print(f"  flash_attention bf16 BH={bh} S={s} D={d} causal against attention_ref in "
          f"blocks of {chunk} query rows: max abs err {err:.3e}, max of |err| - "
          f"{FLASH_RTOL:.3e}·|plain| {excess:.3e} (atol {FLASH_ATOL:.3e}), worst block's "
          f"rms err / rms plain {rel_rms:.3e} (limit {FLASH_REL_RMS:.0e})")
    if not excess <= FLASH_ATOL or not rel_rms <= FLASH_REL_RMS:
        fail(f"flash_attention at S={s} disagrees with attention_ref")
    if not on_card:
        return None
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), n=10)
    plain_ms = cuda_ms(lambda: attention_ref_in_chunks(q, k, v, chunk), n=2, warm=1)
    del want
    # SDPA takes [B, H, S, D]; on 3-d operands it falls back to its
    # materializing path. Timed as the library call, never used by the port
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731
    lib_err = float((got.float() - lib()[0].float()).abs().max())
    lib_ms = cuda_ms(lib, n=10)
    print(f"  flash_attention bf16 BH={bh} S={s} D={d} causal: {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound:.4f} ms ({bound_by}, "
          f"{flops:.3e} FLOPs at {BF16_OPS_PER_S:.3e}/s), plain in blocks {plain_ms:.4f} ms, "
          f"SDPA {lib_ms:.4f} ms (max abs diff vs SDPA {lib_err:.3e})")
    return dict(name="flash_attention.bf16", route="cuda", source=FLASH_SOURCE,
                replaces=FLASH_REPLACES, launches=0, max_abs_err=max(bf16_err, err), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)


def top2_gap(logits):
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def lm_phase(seed, dev, on_card, seq, check_seq, trace):
    """qwen2.5-3b at full width and depth (smoke size on the CPU): prefill
    through the kernel, kernel against plain end to end, and serving. With
    `trace`, one more prefill and one more decode step under the profiler."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS["qwen2.5-3b"] if on_card else ARCHS["qwen2.5-3b"].smoke()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # what earlier phases still hold: the LM's own peak is counted above it
    held = torch.cuda.memory_allocated() if on_card else 0
    t = time.perf_counter()
    model = build(cfg, device=dev, seed=seed)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  build({cfg.name}): {n_params:,} parameters, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {time.perf_counter() - t:.3f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    info = dict(model=cfg.name, parameters=n_params, seq=seq)
    with torch.inference_mode():
        # 1. prefill through the kernel, the second call timed
        toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
        model({"tokens": toks}, impl="kernel", last_only=True)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t = time.perf_counter()
        logits, _ = model({"tokens": toks}, impl="kernel", last_only=True)
        sync()
        secs = time.perf_counter() - t
        launches = flash_attention.launches
        if tuple(logits.shape) != (1, 1, cfg.vocab_padded) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits: shape {tuple(logits.shape)} or non-finite values")
        if on_card and launches != cfg.n_layers:
            fail(f"prefill launched flash_attention {launches} times, not {cfg.n_layers}")
        info.update(prefill_s=secs, prefill_tokens_per_s=seq / secs, flash_launches=launches,
                    peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9 if on_card
                    else None, held_before_gb=held / 1e9 if on_card else None,
                    weights_gb=sum(p.numel() * p.element_size()
                                   for p in model.parameters()) / 1e9)

        # 2. kernel against plain, end to end
        lk, _ = model({"tokens": toks[:, :check_seq]}, impl="kernel", last_only=True)
        lr, _ = model({"tokens": toks[:, :check_seq]}, impl="ref", last_only=True)
        err = float((lk - lr).abs().max())
        info.update(check_seq=check_seq, kernel_vs_ref_max_abs=err,
                    kernel_vs_ref_mean_abs=float((lk - lr).abs().mean()),
                    logit_max_abs=float(lr.abs().max()), logit_std=float(lr.std()))
        print("  " + json.dumps(info))
        if not err <= LM_LOGIT_ATOL:
            fail(f"kernel vs ref logits at S={check_seq}: max abs diff {err} > {LM_LOGIT_ATOL}")

        # 3. serve, and the prefill forward against the decode chain
        prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        engine = ServeEngine(model, max_len=64, batch_size=4)
        engine.generate(prompts, new_tokens=2)          # warm-up
        sync()
        t = time.perf_counter()
        res = engine.generate(prompts, new_tokens=16)
        sync()
        serve_s = time.perf_counter() - t
        steps = prompts.shape[1] + 16 - 1               # decode_step calls
        if res.tokens.shape != (4, 48) or not np.array_equal(res.tokens[:, :32], prompts):
            fail(f"ServeEngine returned {res.tokens.shape} or changed the prompts")
        pt = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        lf, _ = model({"tokens": pt}, impl="kernel", last_only=True)
        cache = model.init_cache(4, 64)
        for i in range(32):
            ld, cache = model.decode_step(pt[:, i:i + 1], cache, i)
        derr = float((lf[:, 0] - ld).abs().max())
        gap = top2_gap(lf[:, 0])
        clear = gap > LM_LOGIT_ATOL
        same = lf[:, 0].argmax(-1) == ld.argmax(-1)
        chain_first = ld.argmax(-1).cpu().numpy()
        serve = dict(prompts=list(prompts.shape), new_tokens=16, serve_s=serve_s,
                     decode_steps=steps, ms_per_decode_step=1e3 * serve_s / steps,
                     prefill_vs_decode_max_abs=derr, top2_gaps=gap.tolist(),
                     argmax_equal=same.tolist(),
                     first_token_equal=bool(np.array_equal(res.tokens[:, 32], chain_first)))
        print("  " + json.dumps(serve))
        if not derr <= LM_LOGIT_ATOL:
            fail(f"prefill vs decode chain at position 31: max abs diff {derr} > {LM_LOGIT_ATOL}")
        if not bool(same[clear].all()):
            fail("prefill and decode chain pick other tokens where the top-2 gap is clear")
        if not serve["first_token_equal"]:
            fail("ServeEngine's first new token differs from the decode chain's argmax")
        if trace:
            tr = trace_run(lambda: model({"tokens": toks}, impl="kernel", last_only=True))
            print("  " + json.dumps(dict(call="prefill", untraced_ms=secs * 1e3, **tr)))
            tr = trace_run(lambda: model.decode_step(ld.argmax(-1)[:, None], cache, 32))
            print("  " + json.dumps(dict(call="decode_step", untraced_ms=serve[
                "ms_per_decode_step"], **tr)))
    info.update(serve)
    return info


# --------------------------------------------------------------------------
# tc: the dense triangle count
# --------------------------------------------------------------------------

def scipy_triangles(g):
    """(L @ L) ⊙ L summed over the CSR of the strict-lower closure, exact."""
    import scipy.sparse as sp
    src = g.edge_src.cpu().numpy()
    dst = g.indices.cpu().numpy()
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keep = lo != hi
    n = g.num_nodes
    lower = sp.csr_matrix((np.ones(int(keep.sum()), np.int64), (hi[keep], lo[keep])),
                          shape=(n, n))
    lower.sum_duplicates()
    lower.data[:] = 1
    return int((lower @ lower).multiply(lower).sum())


def dsl_tc(g, sync):
    """The DSL's tc (the wedge count, `rt.wedge_count`) through the cuda
    backend on the symmetrised graph, against scipy's count and
    count_triangles_dense's on the same graph; the second call timed."""
    from repro_torch.core import compile_bundled
    from repro_torch.core import runtime as rt
    from repro_torch.kernels.tc_matmul.ops import count_triangles_dense, prepare_lower
    gs = symmetrised(g)
    bound = compile_bundled("tc", backend="cuda").bind(gs)
    bound()
    sync()
    t = time.perf_counter()
    got = bound()["triangle_count"]
    sync()
    secs = time.perf_counter() - t
    want = scipy_triangles(gs)
    dense = int(count_triangles_dense(prepare_lower(gs)))
    if got.dtype.is_floating_point or int(got) != want or dense != want:
        fail(f"DSL tc = {int(got)} ({got.dtype}), scipy {want}, count_triangles_dense {dense}")
    w = rt.wedge_count.last
    print("  " + json.dumps(dict(call="dsl tc", backend="cuda", E=gs.num_edges, triangles=want,
                                 seconds=secs, max_degree=w["max_degree"],
                                 chunk_at_max_degree=w["chunk_at_max_degree"],
                                 chunks=w["chunks"], vertices=w["vertices"])))


def tc_phase(seed, dev, on_card, scale, trace):
    import torch
    from repro_torch.graph import rmat
    from repro_torch.kernels.tc_matmul.kernel import tc_matmul
    from repro_torch.kernels.tc_matmul.ops import count_triangles_dense, prepare_lower
    from repro_torch.kernels.tc_matmul.ref import tc_matmul_ref
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t = time.perf_counter()
    g = rmat(scale, edge_factor=16, seed=seed, device=dev)
    lower = prepare_lower(g)
    sync()
    n = lower.shape[0]
    setup_s = time.perf_counter() - t
    want = scipy_triangles(g)
    tc_matmul.launches = 0
    t = time.perf_counter()
    got = count_triangles_dense(lower)
    sync()
    path_s = time.perf_counter() - t
    launches = tc_matmul.launches
    if on_card and launches == 0:
        fail("count_triangles_dense launched no tc_matmul kernel")
    if got.dtype != torch.int32 or int(got) != want:
        fail(f"count_triangles_dense = {int(got)} ({got.dtype}), scipy counts {want}")
    plain = tc_matmul_ref(lower if want < 2**24 else lower.double())
    if int(plain) != want:
        fail(f"tc_matmul_ref = {float(plain)}, scipy counts {want}")
    info = dict(scale=scale, N=n, E=g.num_edges, triangles=want, setup_s=setup_s,
                path_s=path_s, launches=launches)
    print("  " + json.dumps(info))
    dsl_tc(g, sync)
    if not on_card:
        return None
    dense_flops = 2 * n ** 3
    need_flops = 2 * (n * (n - 1) * (n - 2) // 6)     # triples i > k > j
    t_ops = need_flops / INT8_OPS_PER_S                # the kernel's int8 products
    t_bytes = n * n * 4 / HBM_BYTES_PER_S              # f32 L read once
    bound, bound_by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    bf16_bound = 1e3 * max(need_flops / BF16_OPS_PER_S, t_bytes)
    lb = lower.bfloat16()
    ms = cuda_ms(lambda: tc_matmul(lower), n=5)
    plain_ms = cuda_ms(lambda: tc_matmul_ref(lower), n=5)
    lib_ms = cuda_ms(lambda: ((lb @ lb) * lb).sum(), n=5)
    print(f"  tc_matmul f32 N={n}: {ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
          f"{need_flops:.3e} operations of the strict-lower triples at int8's "
          f"{INT8_OPS_PER_S:.3e}/s; at bf16's {BF16_OPS_PER_S:.3e}/s {bf16_bound:.4f} ms; "
          f"one read of f32 L {1e3 * t_bytes:.4f} ms; the dense form's {dense_flops:.3e} at "
          f"bf16 {1e3 * dense_flops / BF16_OPS_PER_S:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bf16 matmul-and-mask {lib_ms:.4f} ms")
    if trace:
        # three calls: the profiler can miss the first kernel of its window
        tr = trace_run(lambda: [tc_matmul(lower) for _ in range(3)])
        print("  " + json.dumps(dict(call="tc_matmul x3", untraced_ms=3 * ms, **tr)))
    return dict(name="tc_matmul.f32", route="cuda", source=TC_SOURCE, replaces=TC_REPLACES,
                launches=launches, max_abs_err=float(abs(int(got) - want)), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale (N = 2^scale)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: rehearse with the plain versions (not a smoke run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="profile one more call of each cuda run (phase 7)")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"

    import torch
    if on_card and not torch.cuda.is_available():
        fail("no CUDA device is available (a --device cpu rehearsal is not a smoke run)")
    import_port()
    from repro_torch.core import get_context
    from repro_torch.graph import rmat
    from repro_torch.kernels import _build

    # 1. device
    t0 = time.perf_counter()
    kind, count = None, 0
    if on_card:
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout.strip()
        print(f"device: {kind} (count {count})")
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
              f"{sys.version.split()[0]}")
        phase("device", t0)

        # 2. build
        t0 = time.perf_counter()
        logs = _build.build_all()
        for name, log in logs.items():
            print(f"  nvcc {name}: " + "\n  ".join(log.strip().splitlines()))
        for row in ptxas_summary(logs):
            print("  ptxas " + json.dumps(row))
        phase("build", t0, f"flags {' '.join(_build.FLAGS)}")

    # 3. graph
    t0 = time.perf_counter()
    g = rmat(args.scale, edge_factor=16, seed=args.seed, device=args.device)
    ell = get_context(g).sliced_ell(None, reverse=True)
    if on_card:
        torch.cuda.synchronize()
    phase("graph", t0, f"N={g.num_nodes} E={g.num_edges} max_in={g.max_in_degree} "
          f"buckets={[tuple(c.shape) for c in ell.cols]} hub_edges={ell.hub_rows.shape[0]} "
          f"padded_cells={ell.padded_cells()}")

    # 4. kernels
    shapes = []
    if on_card:
        t0 = time.perf_counter()
        shapes = kernel_phase(ell, g.num_nodes, args.seed)
        for row in shapes:
            print("  " + json.dumps(row))
        sweeps = sweep_phase(g, ell, args.seed)
        for row in sweeps.values():
            print("  " + json.dumps(row))
        phase("kernels", t0, f"{len(shapes)} shapes and the sweep: kernel == plain version")

    # 5. main path (cuda backend) and the local backend beside it
    t0 = time.perf_counter()
    results, infos, bounds = {"cuda": {}, "local": {}}, [], {}
    for name, direction, params in RUNS:
        bound, out, info = drive(g, "cuda", name, direction, params, on_card)
        bounds[(name, direction)] = bound
        if on_card and info["sweep_launches"] == 0:
            fail(f"{name}/{direction}: the main path launched no ell_sweep kernel")
        results["cuda"][(name, direction)] = out
        infos.append(info)
        print("  " + json.dumps(info))
    for name, direction, params in RUNS:
        _, out, info = drive(g, "local", name, direction, params, on_card)
        results["local"][(name, direction)] = out
        infos.append(info)
        print("  " + json.dumps(info))
    srcs = pick_sources(g, SET_SOURCES, args.seed)
    print(f"  sources (seed {args.seed}): {srcs.tolist()}")
    set_results, set_infos = {"cuda": {}, "local": {}}, []
    for backend in ("cuda", "local"):
        for name, run, knobs, params in set_runs(srcs):
            bound, out, info = drive(g, backend, name, run, params, on_card, knobs)
            if backend == "cuda":
                bounds[(name, run)] = (bound, params)
                if on_card and name == "ppr" and run == "sequential" \
                        and info["sweep_launches"] == 0:
                    fail("sequential ppr launched no ell_sweep kernel")
            set_results[backend][(name, run)] = out
            set_infos.append(info)
            print("  " + json.dumps(info))
    phase("main", t0, "compile_bundled(..., backend='cuda').bind(g)(...)")

    # 6. check
    t0 = time.perf_counter()
    check_results(g, results, t0)
    t0 = time.perf_counter()
    check_set_results(set_results)
    phase("check-programs", t0, "bc, ppr, cc, lp, kcore: cuda == local")
    t0 = time.perf_counter()
    oracle_phase(16 if on_card else args.scale, args.seed, args.device)
    phase("oracles", t0, "bc == Brandes, ppr == float64 iteration, cc and lp == least id "
          "per component, kcore == numpy peeling")

    # 7. trace (optional)
    if on_card and args.trace:
        t0 = time.perf_counter()
        for (name, direction, params), info in zip(RUNS, infos):   # the cuda runs
            bound = bounds[(name, direction)]
            tr = trace_run(lambda: bound(**params))
            names = tr.pop("kernels")
            sweep = [k[:90] for k in names if "ell_sweep" in k]
            print("  " + json.dumps(dict(program=name, direction=direction,
                                         untraced_ms=info["seconds"] * 1e3, **tr,
                                         sweep_kernels=sweep)))
            if on_card and (direction == "pull" or name == "pr"):
                scatters = [k for k in names if re.search(r"scatter|index_?add|indexFunc", k,
                                                          re.IGNORECASE)]
                if scatters or not sweep:
                    fail(f"{name}/{direction} pulls only, yet traced {scatters[:3]} "
                         f"and sweep kernels {sweep}")
        for name, run in (("bc", "batched"), ("ppr", "batched")):
            bound, params = bounds[(name, run)]
            info = next(i for i in set_infos if i["backend"] == "cuda"
                        and (i["program"], i["run"]) == (name, run))
            tr = trace_run(lambda: bound(**params))
            tr.pop("kernels")
            print("  " + json.dumps(dict(program=name, run=run, untraced_ms=info["seconds"] * 1e3,
                                         **tr)))
        phase("trace", t0, "torch.profiler, one call per cuda run; no scatter in a pull")
    del g, ell, results, bounds, set_results
    dev = args.device

    # 8. lm-kernels
    lm_seq = 32768 if on_card else 256
    t0 = time.perf_counter()
    flash = lm_kernel_phase(args.seed, dev, on_card, lm_seq)
    phase("lm-kernels", t0, "flash_attention == attention_ref"
          + (f"; timed at BH=16 S={lm_seq} D=128" if on_card else ""))

    # 9. lm
    t0 = time.perf_counter()
    lm = lm_phase(args.seed, dev, on_card, lm_seq, 2048 if on_card else 128,
                  on_card and args.trace)
    phase("lm", t0, f"prefill {lm['prefill_s']:.3f} s ({lm['prefill_tokens_per_s']:.0f} "
          f"tokens/s), serve {lm['ms_per_decode_step']:.3f} ms per decode step")

    # 10. tc
    t0 = time.perf_counter()
    tc = tc_phase(args.seed, dev, on_card, 14 if on_card else 8, on_card and args.trace)
    phase("tc", t0, "count_triangles_dense == scipy == tc_matmul_ref; DSL tc == scipy == "
          "count_triangles_dense on the symmetrised graph")

    if not on_card:
        print("rehearsal finished: plain versions on the CPU — not a smoke run")
        sys.exit(3)

    # the kernels of the path: the whole-view pull sweep of each semiring
    # (the rectangular per-bucket rows stay printed in phase 4), launches
    # from the main-path runs that use it
    kernels = []
    for semiring, cname, progs in (("minplus", "minplus_i32", ("sssp", "sssp_pull")),
                                   ("plustimes", "plustimes_f32", ("pr", "ppr"))):
        sw = sweeps[semiring]
        mine = [r for r in shapes if r["semiring"] == semiring]
        kernels.append(dict(
            name=f"ell_spmv.{cname}", route="cuda", source=SOURCE, replaces=REPLACES,
            launches=sum(i["launches"] + i["sweep_launches"] for i in infos + set_infos
                         if i["backend"] == "cuda" and i["program"] in progs),
            max_abs_err=max([sw["max_abs_err"]] + [r["max_abs_err"] for r in mine]),
            ms=sw["ms"], plain_ms=sw["plain_ms"], bound_ms=sw["bound_ms"],
            bound_by=sw["bound_by"], library_ms=sw["library_ms"],
            bound_l2_ms=sw["bound_l2_ms"]))
    flash["launches"] = lm["flash_launches"]
    kernels += [flash, tc]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
