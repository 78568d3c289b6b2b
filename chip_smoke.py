#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py                          # the smoke run: one card, RMAT scale 22
    python3 chip_smoke.py --trace                  # ... and where each run's time goes
    python3 chip_smoke.py --scale 10 --device cpu  # rehearsal of the plain versions
    torchrun --nproc-per-node 4 chip_smoke.py --dist-only   # phases 16, 17 and 19 on 4 cards
    torchrun --nproc-per-node 4 chip_smoke.py --dist-only train   # phase 19 alone

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

Phases 11 to 14, the serving path, run right after phase 7, on the same
graph (before the LM phases free it):

 11. delta   — sssp on `cuda` under the default schedule and under
               Schedule(priority="delta") with delta_bucket 64 and 16
               (drive's counters: trips, sweeps, seconds of the second
               call); dist equal the default's and Dijkstra's, each run
               must launch `ell_sweep`; `local` delta sssp on the card (the
               compact `_dell` relax or its dense fallback) equals `cuda`;
               cc under delta equals cc under the default (its keys are
               vertex ids: its bucket is N / 64, so 64 buckets);
 12. serve   — GraphService(ServiceConfig(backend="cuda", max_wait_ms=5))
               with register_graph over the four built-in kinds; one burst
               under one asyncio.gather: 64 sssp and 32 bfs queries from
               sources drawn with --seed (out-degree > 0), 32 ppr, one bc
               over 8 of them, printing queries/s, p50 and p99 latency per
               kind and the service's stats; then a lone sssp query (must
               launch `ell_sweep`) and one coalesced sssp sweep of B = 32
               through the kind's runner, timed with its peak memory above
               held. Checks: sampled sssp rows == the bound cuda program,
               one == Dijkstra; bfs rows == rt.bfs_levels; ppr rows ==
               rt.ppr_multi (and two == the local ppr program) at rtol 1e-4,
               atol 1e-9; the bc row == the bound bc (nan positions
               compared);
 13. update  — one write batch through service.update_graph: 4,096 added
               edges (weights uniform in [1, 100], 1,024 of them aimed at
               rows of in-degree 0 and at rows at their bucket's width) and
               4,096 deleted existing edges, drawn with --seed. The new
               context's reverse view must be patched (same widths and
               bucket shapes, hub rows sorted), encode a rebuilt view's
               edges (sorted (row, col, weight) keys on the card) and run
               `ell_sweep` == `ell_sweep_ref` for both semirings; a lone
               sssp query equals Dijkstra on the new graph; refresh of sssp
               and pr (Schedule(refresh_threshold_frac=1.0), so the warm
               path runs) equals a cold call (sssp equal, pr at rtol 1e-4).
               Prints the update's seconds (host apply, patch, first plan)
               and each refresh's seconds beside the cold call's;
 14. tune    — autotune(compile_bundled("sssp", backend="cuda"), rmat(16),
               budget=4) into a TuningStore in a temporary file; a second
               GraphService with that store registers the graph: `sssp`
               must be listed as tuned and answer as the default does.

Phase 16 runs right after phase 14, on the same graph:

 16. dist    — the distributed backend (one rank per shard on
               torch.distributed) at world size 1: a process group of one
               rank in this process (NCCL with device_id cuda:0; gloo in the
               rehearsal; under torchrun the launcher's group), then
               compile_bundled(name, backend="distributed",
               schedule=Schedule(dist_frontier=...)).bind(g,
               mesh=make_mesh_1d())(...) for sssp, sssp_pull, pr, bc over
               the 32 sources (batched), ppr over 4 of them (the
               distributed lowering keeps ppr's per-source loop
               sequential, as the reference does; held against phase 5's
               sequential run), cc, lp and kcore k = 8, each under
               dist_frontier "dense" and "auto", each equal to its phase-5
               `cuda` result under phase 6's rules, printing the partition's
               seconds and per run the second call's seconds, its
               `_gather_elems` and its peak above held; then tc on the
               symmetrised rmat(14) (the dense ELL rows fit: largest
               degree 3,582), equal to scipy's count.

Phase 17 runs right after phase 16, in the same process group, on the same
graph:

 17. grid    — the rest of the distributed backend at world size 1. The
               2-D grid: make_mesh((1, 1), ("data", "model")), its tile's
               partition seconds and per-superstep elements (gathered N/C,
               reduce-scattered N/R, beside 1-D dense's N), then
               dist2d.sssp_2d(g, mesh, 0), equal to phase 5's `cuda` sssp
               exactly, and dist2d.pagerank_2d(g, mesh) (its sweep count
               printed), held against a float64 iteration of as many sweeps
               at rtol 1e-4; each timed on its second call with its peak
               above held. Pods: make_mesh((1, 1), ("pod", "data")) and
               dist.run_pod_parallel(compile_bundled("bc",
               backend="distributed"), g, mesh, the 32 sources), equal to
               phase 5's batched bc under phase 6's rules, its
               `_gather_elems` equal to phase 16's dense bc. Distributed
               autotune: autotune(compile_bundled("sssp",
               backend="distributed"), rmat(16), budget=4, mesh=...) into a
               TuningStore in a temporary file, the trials printed, every
               rank's schedule and record the same (an all-gather of a
               digest), the winner's dist equal to `cuda`'s.

`--dist-only` runs the graph, its `cuda` baselines and phases 16, 17 and
19 alone (`--dist-only train`: phase 19 alone); under `torchrun
--nproc-per-node 4 chip_smoke.py --dist-only` (one card a rank, NCCL)
phase 17 takes the grids (2, 2), (1, 4) and (4, 1) and the pods (2, 2)
and (4, 1), a pod count above 1 holding `_gather_elems` to the sum of
each pod's slice run alone; only rank 0 prints.

Phase 18 runs after phase 15, phase 19 only under --dist-only:

 18. train   — qwen2.5-3b at full width and depth (bf16, seeded init)
               trained through launch.train's pieces: 5 steps of seq
               2,048, global batch 8 in 4 microbatches, remat,
               impl="ref"; every loss finite, state.step == 5, every
               matrix moved; it prints seconds a step (steps 2 to 5),
               tokens/s, 6·N·T over the step time against the bf16 peak
               and the peak memory above held, beside nvidia-smi's name
               and power limit. Then crash and resume at full width with
               2 layers: 3 steps straight against 2, a checkpoint on
               disk, a restore into a fresh model and 1 step (loss at
               rel 1e-4, parameters within 2.5·lr + 2^-7·|p|: bf16, and
               the embedding backward adds with atomics; m and v within
               0.1 of the straight run's, leaf by leaf), printing the
               bytes written and the save and restore seconds; one f32
               smoke step on the card against the CPU's from the same
               weights (loss and grad norm at rel 1e-4); and
               impl="kernel" under grad must raise (flash has no
               backward), launching nothing. It launches no kernel of
               the port;
 19. train-dist — qwen2.5-3b at full width with 4 layers, sharded by
               launch.sharding (each rank holds its block of every
               sharded parameter, m and v): 3 steps on mesh (2, 2) and a
               checkpoint, then from it 2 steps on (4, 1) and 2 on
               (1, 4), and an unbroken (2, 2) run of 5 steps (at one
               rank (1, 1) each); losses at rel 1e-4 of the unbroken
               run's, the resumed runs' m and v at step 5 within 0.1 of
               its (gathered, leaf by leaf), every rank's held bytes of
               params + m + v equal to the specs' arithmetic; then 3
               steps on (2, 2) at full depth (36 layers) for its peak
               and step times; rank 0 prints the held bytes, the peaks
               and every rank's step times. Then one step of the first
               mesh at 4 layers under the census of launch.hlo_cost on
               every rank: rank 0's collective bytes must equal those of
               the dry run's census of the same cell on a fake world of
               as many ranks (launch.dryrun, in a process of its own).

Phase 20 runs after phase 18:

 20. offline — rmat(16) written by graph.io.save_edgelist and read back by
               load_edgelist onto the card: its edge arrays equal the
               source's, its node arrays up to the largest id on an edge
               (the loader takes the node count from it, as the
               reference's does; the vertices above it must be isolated),
               with the seconds of each; `python -m repro_torch.analyze
               --bundled --strict --backend cuda` in a process of its own
               exits 0 with "0 error(s), 0 warning(s)", and
               tests/programs_bad/race_cross_write.sp exits 1 with SP101;
               then one more step of phase 18's cell under the census of
               launch.hlo_cost on the card, its dot FLOPs and dot bytes
               equal to the dry run's census of the same cell on the meta
               device (launch.dryrun.train_census), printing the roofline
               terms of launch.roofline, phase 18's step time over their
               bound, 6·N·T over the census FLOPs and the dry run's
               predicted peak (arguments and temps) beside phase 18's
               measured peak above held. It launches no kernel of the port.

Phase 15 runs last, after phase 10:

 15. lm-families — deepseek-moe-16b, zamba2-1.2b, xlstm-1.3b and
               seamless-m4t-large-v2 at full width and depth (bf16, seeded
               init), each built, checked and freed in turn: a prefill
               through the kernel, second call timed (32,768 tokens;
               xlstm cut to 4,096, its sLSTM being a per-token loop;
               seamless 32,768 frame embeddings and 1,024 decoder tokens),
               its flash launches 28 / 6 / 0 / 72 and its peak above held;
               the first call's first flash call of each shape (BH, SQ,
               SKV, D, causal) held against attention_ref in blocks of
               1,024 query rows (phase 8's rules); moe and hybrid timed
               once more with F.silu in place of layers.silu; every flash
               call of a 2,048-token forward held the same way; two MoE
               forwards bitwise equal; serving 4 x 32 + 16 tokens
               (ServeEngine; encdec: decode_step through the kernel
               against 4 x 2,048 encoded frames, its cross call at SQ = 1
               held), the first new token equal to its decode chain's
               argmax; then the same weights upcast to f32: kernel vs ref
               at 2,048 tokens and the prefill vs the decode chain at
               position 31 (MoE at capacity factor 16) within 1e-3. For
               xlstm and seamless the bf16 forms of those two are held at
               0.25, and their bf16 plain logits within 0.25 of their f32
               plain ones; for deepseek and zamba2 they are printed.

With --trace, phase 12 also traces one lone sssp query and one coalesced
sweep (B = 32), and phase 13 one sssp refresh, in phase 7's format, and
phase 15 one prefill of each family (xlstm's at 512 tokens), and phase 18
a sixth train step. The CUDA caching allocator runs with expandable
segments (PYTORCH_CUDA_ALLOC_CONF, unless the caller sets it): without
them phase 15's f32 upcast of deepseek-moe-16b ran out of memory after
--trace's profiled prefill, on fragmented segments.

The line before the last is {"kernels": [...]} (ell_spmv's two semirings,
reported by the sweep that the main path runs, with the launches of
phases 5, 11, 12 and 13, flash_attention.bf16 with the launches of
phases 9 and 15, and tc_matmul.f32); the last line is {"ok": true,
"device": {...}}. Without a CUDA device the run fails; a `--device cpu`
rehearsal runs phases 3, 5, 6, 8 to 18 and 20 with the plain versions at
smoke sizes (the LMs' smoke configs, a 256-token prefill (128 in phase
15), RMAT --scale for the graph phases, RMAT 8 for tc, phase 18 at seq
64 without its card-against-CPU and flash checks, phase 20 on rmat(8)),
prints no result line
and exits 3: it is not a smoke run.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# expandable segments, set before the port's import below loads torch:
# phase 15's f32 upcast of deepseek-moe-16b (67.5 GB of weights from 33.8 GB
# of bf16) found no room in the caching allocator's fragmented segments
# once --trace's profiled prefill ran
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.path.join(HERE, "src"))
# the H100 SXM's peaks: HBM bytes/s; f32 outside the tensor cores, bf16 and
# int8 on them, dense
from repro_torch.launch.roofline import (F32_FLOPS as F32_OPS_PER_S,  # noqa: E402
                                         HBM_BW as HBM_BYTES_PER_S,
                                         INT8_OPS as INT8_OPS_PER_S,
                                         PEAK_FLOPS as BF16_OPS_PER_S)
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
    """A phase's line with its seconds; under torchrun, rank 0's only."""
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"[{name}] {time.perf_counter() - t0:.3f} s {detail}".rstrip(), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def import_port():
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


def trace_run(fn, top=12, attempts=2):
    """One more call of `fn` under torch.profiler: device time by kernel and
    the device-busy share of the call's wall time. A window in which the
    profiler recorded no device time at all is profiled once more (it
    happened once in a long run, on calls it had traced before); a second
    empty window fails."""
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
        # kernels it launched, and an `nccl:` row that of its NCCL kernel
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("nccl:"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    if busy_s == 0:
        if attempts > 1:
            print("  torch.profiler recorded no device time; profiling the call once more")
            return trace_run(fn, top, attempts - 1)
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
    return dist_ref


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
# the serving path: delta-stepping, GraphService, a write batch, the tuner
# --------------------------------------------------------------------------

DELTA_RUNS = (("default", {}), ("delta64", dict(priority="delta")),
              ("delta16", dict(priority="delta", delta_bucket=16)))
CC_BUCKETS = 64         # cc under delta: buckets over its label range [0, N)
BURST = dict(sssp=64, bfs=32, ppr=32)    # and one bc query over 8 sources
BC_SOURCES = 8
WRITES = 4096           # added edges, and as many deleted existing ones
AIMED = 1024            # of the adds: at in-degree-0 rows and rows at their width
REFRESH_PR = dict(beta=1e-7, delta=0.85, maxIter=300)


def sync(on_card):
    if on_card:
        import torch
        torch.cuda.synchronize()


def delta_phase(g, on_card, dist_ref):
    """sssp on `cuda` under the default schedule and under delta-stepping
    (Δ = 64 and 16): dist equal the default's and Dijkstra's, every cuda
    run launches `ell_sweep`; `local` delta on the card (the compact
    `_dell` relax or its dense fallback) equals `cuda`; cc under delta
    (a bucket of N / CC_BUCKETS) equals cc under the default. Returns the
    delta runs' infos."""
    import torch
    from repro_torch.core import get_context
    infos, dists = [], {}
    for label, knobs in DELTA_RUNS:
        _, out, info = drive(g, "cuda", "sssp", label, dict(src=0), on_card, knobs)
        dists[label] = out["dist"]
        if on_card and info["sweep_launches"] == 0:
            fail(f"sssp/{label}: launched no ell_sweep kernel")
        infos.append(info)
        print("  " + json.dumps(info))
    for label, _ in DELTA_RUNS[1:]:
        if not torch.equal(dists[label], dists["default"]):
            fail(f"sssp/{label}: dist differs from the default schedule's")
    if not np.array_equal(dists["delta16"].cpu().numpy().astype(np.int64), dist_ref):
        fail("sssp/delta16: dist differs from Dijkstra")
    _, out, info = drive(g, "local", "sssp", "delta64", dict(src=0), on_card,
                         dict(priority="delta"))
    info["compact_view"] = get_context(g).delta_ell() is not None
    print("  " + json.dumps(info))
    if not torch.equal(out["dist"], dists["delta64"]):
        fail("sssp/delta64: local differs from cuda on the card")
    # cc's keys are vertex ids: a bucket of 64 makes N / 64 buckets (65,536
    # on RMAT 22: 339 s per call on the card), N / CC_BUCKETS makes 64
    _, cc, _ = drive(g, "cuda", "cc", "default", {}, on_card, {})
    bucket = max(g.num_nodes // CC_BUCKETS, 1)
    _, ccd, info = drive(g, "cuda", "cc", f"delta{bucket}", {}, on_card,
                         dict(priority="delta", delta_bucket=bucket))
    print("  " + json.dumps(info))
    if not torch.equal(cc["comp"], ccd["comp"]):
        fail(f"cc/delta{bucket}: comp differs from the default schedule's")
    return infos


async def serve_burst(service, name, srcs, seed):
    """One burst under one asyncio.gather: sssp from every source in
    `srcs`, bfs from the first BURST["bfs"], ppr from the last
    BURST["ppr"], one bc over the first BC_SOURCES. Returns the answers
    keyed by (kind, source) and the per-kind latencies."""
    async def timed(kind, key, **params):
        t = time.perf_counter()
        out = await service.query(name, kind, timeout=None, **params)
        return kind, key, out, time.perf_counter() - t

    jobs = [timed("sssp", int(s), src=int(s)) for s in srcs[:BURST["sssp"]]]
    jobs += [timed("bfs", int(s), src=int(s)) for s in srcs[:BURST["bfs"]]]
    jobs += [timed("ppr", int(s), src=int(s)) for s in srcs[-BURST["ppr"]:]]
    jobs.append(timed("bc", None, sourceSet=srcs[:BC_SOURCES]))
    t = time.perf_counter()
    res = await asyncio.gather(*jobs)
    wall = time.perf_counter() - t
    answers = {(kind, key): out for kind, key, out, _ in res}
    lat = {}
    for kind, _, _, secs in res:
        lat.setdefault(kind, []).append(secs)
    return answers, lat, wall


def check_burst(g, answers, srcs, on_card):
    """The burst's answers against the bound programs and the oracles."""
    import torch
    from repro_torch.core import compile_bundled
    from repro_torch.core import runtime as rt
    sssp = compile_bundled("sssp", backend="cuda").bind(g)
    picks = srcs[:BURST["sssp"]][::21]
    for s in picks:
        if not np.array_equal(answers[("sssp", int(s))], sssp(src=int(s))["dist"].cpu().numpy()):
            fail(f"serve: sssp from {s} differs from the bound cuda program")
    if not np.array_equal(answers[("sssp", int(srcs[0]))].astype(np.int64),
                          dijkstra_ref(g, int(srcs[0]))):
        fail(f"serve: sssp from {srcs[0]} differs from Dijkstra")
    for s in srcs[:BURST["bfs"]]:
        if not np.array_equal(answers[("bfs", int(s))],
                              rt.bfs_levels(g, int(s))[0].cpu().numpy()):
            fail(f"serve: bfs from {s} differs from rt.bfs_levels")
    ppr_srcs = srcs[-BURST["ppr"]:]
    want = rt.ppr_multi(g, torch.as_tensor(ppr_srcs, device=g.device)).cpu().numpy()
    local = compile_bundled("ppr", backend="local").bind(g)
    got_all = np.stack([answers[("ppr", int(s))] for s in ppr_srcs])
    over = np.abs(got_all - want) - 1e-9
    print(f"  serve: ppr rows vs rt.ppr_multi: max abs diff {np.abs(got_all - want).max()!r}, "
          f"largest diff beyond atol as a share of |want| "
          f"{float(np.max(np.where(over > 0, over / np.maximum(np.abs(want), 1e-30), 0.0)))!r} "
          f"(rtol 1e-4)")
    for i, s in enumerate(ppr_srcs):
        got = answers[("ppr", int(s))]
        np.testing.assert_allclose(got, want[i], rtol=1e-4, atol=1e-9,
                                   err_msg=f"serve: ppr from {s} vs rt.ppr_multi")
        if i < 2:
            one = local(beta=1e-4, delta=0.85, maxIter=100, sourceSet=[int(s)])["ppr"]
            np.testing.assert_allclose(got, one.cpu().numpy(), rtol=1e-4, atol=1e-9,
                                       err_msg=f"serve: ppr from {s} vs local ppr")
    bc = compile_bundled("bc", backend="cuda").bind(g)(sourceSet=srcs[:BC_SOURCES])
    compare_outputs({"BC": torch.from_numpy(answers[("bc", None)]).to(g.device)},
                    bc, "serve: bc vs the bound bc")
    print(f"  serve checks: sssp rows {picks.tolist()} == bound cuda sssp, "
          f"{srcs[0]} == Dijkstra; {BURST['bfs']} bfs rows == rt.bfs_levels; "
          f"{BURST['ppr']} ppr rows == rt.ppr_multi (2 == local ppr); bc == bound bc")


def write_batch(g, ell, seed):
    """WRITES added edges (weights uniform in [1, 100]), AIMED of them at
    rows of in-degree 0 and at rows whose in-degree equals their bucket's
    width, half each (so both migrate into the hub tail), and WRITES
    deleted existing edges, drawn with `seed`. A graph of fewer than
    2·WRITES edges (a rehearsal) gets E / 2 of each, and fewer aimed adds
    where it has fewer such rows."""
    rng = np.random.default_rng(seed + 1)
    n = g.num_nodes
    writes = min(WRITES, g.num_edges // 2)
    in_deg = g.in_degree.cpu().numpy()
    empty = np.flatnonzero(in_deg == 0)
    full = np.flatnonzero(np.isin(in_deg, np.asarray(ell.widths)))
    aimed = [rng.choice(rows, min(AIMED * writes // WRITES // 2, rows.size), replace=False)
             for rows in (empty, full)]
    dst = np.concatenate(aimed + [rng.integers(0, n, writes - sum(a.size for a in aimed))])
    adds = np.stack([rng.integers(0, n, writes), dst], 1)
    idx = rng.choice(g.num_edges, writes, replace=False)
    dels = np.stack([g.edge_src.cpu().numpy()[idx], g.indices.cpu().numpy()[idx]], 1)
    return adds, dels, rng.integers(1, 101, writes)


def view_edge_keys(view):
    """The (row, col, weight) multiset of a sliced view as sorted int64
    keys, on the view's device ((row·N + col)·128 + weight; weights < 128)."""
    import torch
    n = view.num_nodes
    parts = []
    for cols, wts, rows in zip(view.cols, view.wts, view.rows):
        real = (rows < n)[:, None] & (cols < n)
        r = rows[:, None].expand_as(cols)[real].long()
        parts.append((r * n + cols[real].long()) * 128 + wts[real].long())
    parts.append((view.hub_rows.long() * n + view.hub_cols.long()) * 128 + view.hub_wts.long())
    return torch.sort(torch.cat(parts)).values


class Timers:
    """Host seconds spent in module functions, each call ending in a
    synchronize: wraps `module.attr` while the `with` block runs."""

    def __init__(self, on_card, **targets):
        self.on_card, self.targets, self.seconds = on_card, targets, {}

    def __enter__(self):
        self.saved = {}
        for label, (module, attr) in self.targets.items():
            fn = getattr(module, attr)
            self.saved[label] = (module, attr, fn)

            def timed(*a, _fn=fn, _label=label, **kw):
                t = time.perf_counter()
                out = _fn(*a, **kw)
                sync(self.on_card)
                self.seconds[_label] = self.seconds.get(_label, 0.0) + time.perf_counter() - t
                return out
            setattr(module, attr, timed)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved.values():
            setattr(module, attr, fn)


async def update_phase(service, name, g, seed, on_card, trace):
    """One write batch through `service.update_graph`: the new context's
    reverse view was patched (same widths and bucket shapes, hub rows
    sorted), encodes the rebuilt view's edges and runs `ell_sweep` equal
    to `ell_sweep_ref`; a lone sssp query equals Dijkstra on the new
    graph; refresh of sssp and pr equals a cold call. Returns the
    `ell_sweep` launches of the lone query and the refreshes, by semiring."""
    import torch
    from repro_torch.core import Schedule, compile_bundled, context, get_context
    from repro_torch.graph import dynamic, to_sliced_ell
    from repro_torch.kernels.ell_spmv import plan as plan_mod
    from repro_torch.kernels.ell_spmv.kernel import ell_sweep
    from repro_torch.kernels.ell_spmv.ref import ell_sweep_ref
    old_view = get_context(g).sliced_ell(None, reverse=True)
    adds, dels, wts = write_batch(g, old_view, seed)
    s = int(pick_sources(g, 1, seed + 2)[0])
    refresh = Schedule(refresh_threshold_frac=1.0)
    progs = {"sssp": (compile_bundled("sssp", backend="cuda", schedule=refresh), dict(src=s)),
             "pr": (compile_bundled("pr", backend="cuda", schedule=refresh), REFRESH_PR)}
    prev = {k: p.bind(g)(**params) for k, (p, params) in progs.items()}
    sync(on_card)
    with Timers(on_card, apply=(dynamic, "apply_update"),
                patch=(context, "adopt_patched_views"),
                plan=(plan_mod, "build_sweep_plan")) as tm:
        t = time.perf_counter()
        delta = await service.update_graph(name, adds=adds, dels=dels, weights=wts)
        sync(on_card)
        total = time.perf_counter() - t
    new = delta.graph
    view = get_context(new).sliced_ell(None, reverse=True)
    if view.widths != old_view.widths or \
            [tuple(c.shape) for c in view.cols] != [tuple(c.shape) for c in old_view.cols]:
        fail("update: the new context's reverse view was rebuilt, not patched")
    if not bool((view.hub_rows[1:] >= view.hub_rows[:-1]).all()):
        fail("update: the patched hub tail is not sorted by row")
    fresh = to_sliced_ell(new, reverse=True)
    if not torch.equal(view_edge_keys(view), view_edge_keys(fresh)):
        fail("update: the patched view's edges differ from a rebuilt view's")
    pads = lambda v: sum(int((r == v.num_nodes).sum()) for r in v.rows)  # noqa: E731
    plan = get_context(new).sweep_plan(None)
    rng = np.random.default_rng(seed)
    dist = torch.from_numpy(rng.integers(0, 1000, new.num_nodes).astype(np.int32)).to(new.device)
    x = torch.from_numpy(rng.random(new.num_nodes).astype(np.float32)).to(new.device)
    if on_card:
        got = ell_sweep(view, plan, dist, semiring="minplus", dist=dist)
        if not torch.equal(got, ell_sweep_ref(view, plan, dist, "minplus", dist)):
            fail("update: min-plus ell_sweep on the patched view differs from ell_sweep_ref")
        torch.testing.assert_close(ell_sweep(view, plan, x, semiring="plustimes"),
                                   ell_sweep_ref(view, plan, x, "plustimes"),
                                   rtol=1e-5, atol=1e-6)
    print("  " + json.dumps(dict(
        added=delta.num_added, removed=delta.num_removed, version=new.version,
        E=new.num_edges, update_s=total, host_apply_s=tm.seconds["apply"] - tm.seconds["patch"],
        patch_s=tm.seconds["patch"], first_plan_s=tm.seconds.get("plan", 0.0),
        hub_edges=[int(old_view.hub_rows.shape[0]), int(view.hub_rows.shape[0])],
        padding_rows=[pads(old_view), pads(view)])))
    ell_sweep.launches = 0
    lone = await service.query(name, "sssp", src=s, timeout=None)
    lone_launches = ell_sweep.launches
    if not np.array_equal(lone.astype(np.int64), dijkstra_ref(new, s)):
        fail("update: the lone sssp query differs from Dijkstra on the updated graph")
    t = time.perf_counter()
    seeding = delta.plan()
    plan_s = time.perf_counter() - t
    launches, rows = {"minplus": lone_launches, "plustimes": 0}, []
    for key, (prog, params) in progs.items():
        bound = prog.bind(new)
        bound(**params)                             # warm
        sync(on_card)
        ell_sweep.launches = 0
        t = time.perf_counter()
        warm = bound.refresh(prev[key], delta, **params)
        sync(on_card)
        refresh_s, refreshed = time.perf_counter() - t, ell_sweep.launches
        launches["minplus" if key == "sssp" else "plustimes"] += refreshed
        t = time.perf_counter()
        cold = bound(**params)
        sync(on_card)
        cold_s = time.perf_counter() - t
        if key == "sssp":
            if not torch.equal(warm["dist"], cold["dist"]):
                fail("update: refreshed sssp differs from a cold call")
        else:
            torch.testing.assert_close(warm["pageRank"], cold["pageRank"], rtol=1e-4, atol=0)
        if on_card and refreshed == 0:
            fail(f"update: {key} refresh launched no ell_sweep kernel")
        rows.append(dict(refresh=key, refresh_s=refresh_s, cold_s=cold_s, sweep_launches=refreshed,
                         **({"iterations": [int(warm["iterCount"]), int(cold["iterCount"])]}
                            if key == "pr" else {})))
    print("  " + json.dumps(dict(plan_s=plan_s, affected_frac=seeding.affected_frac,
                                 cone=seeding.cone_size, lone_query_sweeps=lone_launches)))
    for row in rows:
        print("  " + json.dumps(row))
    if trace:
        prog, params = progs["sssp"]
        bound = prog.bind(new)
        tr = trace_run(lambda: bound.refresh(prev["sssp"], delta, **params))
        tr.pop("kernels")
        print("  " + json.dumps(dict(run="sssp refresh", untraced_ms=rows[0]["refresh_s"] * 1e3,
                                     **tr)))
    return launches


async def serving_phase(g, seed, on_card, trace):
    """Phases `serve` and `update`: GraphService(backend="cuda") over the
    graph, one burst, a lone query, one coalesced sssp sweep measured on
    its own, the checks, then a write batch. Returns the `ell_sweep`
    launches of the lone queries and the refreshes, by semiring."""
    import torch
    from repro_torch.kernels.ell_spmv.kernel import ell_sweep
    from repro_torch.serve import BUILTIN_KINDS, GraphService, ServiceConfig
    name = "rmat22"
    srcs = pick_sources(g, BURST["sssp"], seed)
    print(f"  sources (seed {seed}): {srcs.tolist()}")
    t0 = time.perf_counter()
    async with GraphService(ServiceConfig(backend="cuda", max_wait_ms=5.0)) as svc:
        t = time.perf_counter()
        handle = svc.register_graph(name, g)
        register_s = time.perf_counter() - t
        answers, lat, wall = await serve_burst(svc, name, srcs, seed)
        st = svc.stats()
        n = sum(len(v) for v in lat.values())
        row = dict(queries=n, wall_s=wall, queries_per_s=n / wall, register_s=register_s,
                   sweeps=st["sweeps"], mean_batch=st["mean_batch"], max_batch=st["max_batch"],
                   served=st["served"], rejected=st["rejected"], timeouts=st["timeouts"])
        for kind, xs in lat.items():
            row[f"{kind}_p50_s"], row[f"{kind}_p99_s"] = (float(np.percentile(xs, q))
                                                          for q in (50, 99))
        print("  " + json.dumps(row))
        ell_sweep.launches = 0
        t = time.perf_counter()
        lone = await svc.query(name, "sssp", src=int(srcs[1]), timeout=None)
        lone_s, lone_launches = time.perf_counter() - t, ell_sweep.launches
        if on_card and lone_launches == 0:
            fail("serve: the lone sssp query launched no ell_sweep kernel")
        if not np.array_equal(lone, answers[("sssp", int(srcs[1]))]):
            fail("serve: the lone sssp query differs from its coalesced answer")
        # one coalesced sssp sweep (B = 32) on its own: seconds and peak
        runner = BUILTIN_KINDS[0].make_runner(handle, handle.schedules["sssp"], 32)
        params = [{"src": int(s)} for s in srcs[:32]]
        sync(on_card)
        held = torch.cuda.memory_allocated() if on_card else None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rows = runner(params)
        sync(on_card)
        sweep_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - held if on_card else None
        for s, r in zip(srcs[:32], rows):
            if not np.array_equal(r, answers[("sssp", int(s))]):
                fail(f"serve: sssp from {s} differs between two coalesced sweeps")
        print("  " + json.dumps(dict(lone_sssp_s=lone_s, lone_sssp_sweeps=lone_launches,
                                     coalesced_sssp_B=32, coalesced_sssp_s=sweep_s,
                                     coalesced_sssp_peak_above_held_bytes=peak,
                                     held_bytes=held)))
        check_burst(g, answers, srcs, on_card)
        if trace:
            for label, fn, ms in (("lone sssp query", lambda: runner(params[1:2]), lone_s),
                                  ("coalesced sssp sweep, B = 32", lambda: runner(params),
                                   sweep_s)):
                tr = trace_run(fn)
                tr.pop("kernels")
                print("  " + json.dumps(dict(run=label, untraced_ms=ms * 1e3, **tr)))
        del answers, rows
        phase("serve", t0, "GraphService(backend='cuda'): burst == bound programs and oracles")
        t0 = time.perf_counter()
        launches = await update_phase(svc, name, g, seed, on_card, trace)
        launches["minplus"] += lone_launches
        phase("update", t0, "update_graph: patched view == rebuilt, sweep == plain, "
              "refresh == cold")
    return launches


def tune_phase(scale, seed, dev):
    """autotune(sssp, cuda) on rmat(scale), saved to a TuningStore in
    a temporary file; a second GraphService with that store registers the
    graph: sssp is served under the tuned schedule, with the default
    schedule's answers."""
    import tempfile
    from repro_torch.autotune import TuningStore, autotune, schedule_to_dict
    from repro_torch.core import Schedule, compile_bundled
    from repro_torch.graph import rmat
    from repro_torch.serve import GraphService, ServiceConfig
    g16 = rmat(scale, edge_factor=16, seed=seed, device=dev)
    srcs = pick_sources(g16, 4, seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning.json")
        t = time.perf_counter()
        res = autotune(compile_bundled("sssp", backend="cuda"), g16, budget=4,
                       store=TuningStore(path))
        tune_s = time.perf_counter() - t
        base = schedule_to_dict(Schedule())
        for i, trial in enumerate(res.record.trials):
            knobs = {k: v for k, v in trial["schedule"].items() if v != base[k]}
            print("  " + json.dumps(dict(trial=i, ms=trial["ms"], knobs=knobs)))

        async def serve():
            async with GraphService(ServiceConfig(backend="cuda"), tune_store=path) as svc:
                handle = svc.register_graph("rmat16", g16, kinds=["sssp"])
                outs = await asyncio.gather(*(svc.query("rmat16", "sssp", src=int(s))
                                              for s in srcs))
                return handle, outs, await svc.query("rmat16", "sssp", src=int(srcs[0]))

        handle, outs, lone = asyncio.run(serve())
    if "sssp" not in handle.tuned or handle.schedules["sssp"] != res.schedule:
        fail(f"tune: the service did not reload the tuned schedule ({handle.tuned})")
    default = compile_bundled("sssp", backend="cuda").bind(g16)
    for s, out in zip(srcs, outs):
        if not np.array_equal(out, default(src=int(s))["dist"].cpu().numpy()):
            fail(f"tune: sssp from {s} under the tuned schedule differs from the default's")
    if not np.array_equal(lone, outs[0]):
        fail("tune: the lone sssp query differs from the coalesced one")
    print("  " + json.dumps(dict(graph=f"rmat({scale})", N=g16.num_nodes, E=g16.num_edges,
                                 tune_s=tune_s, best_ms=res.record.best_ms,
                                 default_ms=res.record.default_ms, tuned=handle.tuned,
                                 sources=srcs.tolist())))


# --------------------------------------------------------------------------
# dist: the 1-D distributed backend on torch.distributed
# --------------------------------------------------------------------------

DIST_FRONTIERS = ("dense", "auto")


def dist_runs(srcs):
    """(program, the phase-5 `cuda` run it must equal, params) of phase 16.
    ppr is held against the sequential run (4 sources): a per-source
    do-while inside the set loop keeps the distributed lowering on the
    sequential per-source loop, as in the reference."""
    return (("sssp", ("sssp", "auto"), dict(src=0)),
            ("sssp_pull", ("sssp_pull", "auto"), dict(src=0)),
            ("pr", ("pr", "auto"), next(dict(p) for n, _, p in RUNS if n == "pr")),
            ("bc", ("bc", "batched"), dict(sourceSet=srcs)),
            ("ppr", ("ppr", "sequential"), dict(PPR_PARAMS, sourceSet=srcs[:4])),
            ("cc", ("cc", "auto"), {}),
            ("lp", ("lp", "auto"), {}),
            ("kcore", ("kcore", "auto"), dict(k=8)))


@contextlib.contextmanager
def process_group(on_card):
    """The process group of phases 16 and 17 (NCCL on the card, gloo for the
    rehearsal), destroyed at the end: under torchrun (WORLD_SIZE is set)
    the launcher's ranks, one card each (cuda:LOCAL_RANK); else a group of
    one rank in this process."""
    import datetime
    import torch
    import torch.distributed as tdist
    backend = "nccl" if on_card else "gloo"
    kw = dict(timeout=datetime.timedelta(seconds=300))
    if on_card:
        kw["device_id"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" not in os.environ:
        kw.update(store=tdist.HashStore(), rank=0, world_size=1)
    tdist.init_process_group(backend, **kw)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def dist_baselines(g, srcs, on_card):
    """The phase-5 `cuda` results phases 16 and 17 hold their runs
    against, for a run of those phases alone (--dist-only)."""
    from repro_torch.core import Schedule, compile_bundled
    want = {}
    for name, run, params in dist_runs(srcs):
        knobs = dict(batch_sources=1) if run[1] == "sequential" else {}
        want[run] = compile_bundled(name, backend="cuda",
                                    schedule=Schedule(**knobs)).bind(g)(**params)
    sync(on_card)
    return want


def collective_probe(mesh, n_pad, on_card, reps=10):
    """ms and bytes/s of the two collectives of a dense superstep at the
    graph's size: an all-gather of this rank's int32 block into [N_pad] and
    an all_reduce (sum) of an int32 [N_pad] buffer (the mean of `reps`
    calls after one warm-up; bytes: the N_pad * 4 of the result)."""
    import torch
    from repro_torch.core import runtime_dist as rtd
    blk = torch.zeros(n_pad // mesh.size, dtype=torch.int32, device=mesh.device)
    full = torch.zeros(n_pad, dtype=torch.int32, device=mesh.device)
    out = dict(dist="collectives", world=mesh.size, n_pad=n_pad,
               all_gather_api=rtd._all_gather.__name__)
    for name, fn in (("all_gather", lambda: rtd.gather(blk, mesh)),
                     ("all_reduce", lambda: rtd.psum(full, mesh))):
        fn()
        sync(on_card)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(on_card)
        secs = (time.perf_counter() - t) / reps
        out[name] = dict(ms=secs * 1e3, bytes_per_s=n_pad * 4 / secs)
    return out


def second_call(fn, on_card):
    """Calls `fn` twice; returns the second call's result and its timing:
    the first call's seconds, the second's (host clock ending in a
    synchronize) and its peak device memory above what was allocated just
    before it."""
    import torch
    t = time.perf_counter()
    fn()
    sync(on_card)
    first_s = time.perf_counter() - t
    held = torch.cuda.memory_allocated() if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    sync(on_card)
    secs = time.perf_counter() - t
    return out, dict(first_s=first_s, seconds=secs, peak_above_held_bytes=(
        torch.cuda.max_memory_allocated() - held if on_card else None))


def shower(rank):
    """Prints a phase line on rank 0 only."""
    return (lambda info: print("  " + json.dumps(info))) if rank == 0 else (lambda info: None)


def dist_phase(g, want, srcs, on_card, seed, tc_scale, trace=False):
    """Phase 16, inside `process_group`: the programs of phase 5 through
    compile_bundled(..., backend="distributed").bind(g,
    mesh=make_mesh_1d())(...) under dist_frontier dense and auto, each
    equal to its phase-5 `cuda` result (`want`); then tc on the
    symmetrised rmat(tc_scale), equal to scipy. With `trace`, one more
    call of each dense run under torch.profiler."""
    import torch
    from repro_torch.core import Schedule, compile_bundled, dist
    from repro_torch.graph import rmat
    infos = []
    mesh = dist.make_mesh_1d(device=None if on_card else "cpu")
    show = shower(mesh.rank)
    t = time.perf_counter()
    gd = dist.prepare(g, mesh)
    sync(on_card)
    show(dict(dist="prepare", world=mesh.size, device=str(mesh.device),
              seconds=time.perf_counter() - t))
    show(collective_probe(mesh, gd["own_ids"].shape[0] * mesh.size, on_card))
    for name, run, params in dist_runs(srcs):
        for frontier in DIST_FRONTIERS:
            bound = compile_bundled(name, backend="distributed",
                                    schedule=Schedule(dist_frontier=frontier)).bind(
                                        g, mesh=mesh)
            out, timing = second_call(lambda: bound(**params), on_card)
            compare_outputs(out, want[run], f"{name}/{frontier} distributed vs "
                            f"{'/'.join(run)} cuda")
            info = dict(dist=name, frontier=frontier, held_against=f"{'/'.join(run)} cuda",
                        first_s=timing["first_s"], seconds=timing["seconds"],
                        gather_elems=float(out["_gather_elems"]),
                        peak_above_held_bytes=timing["peak_above_held_bytes"])
            infos.append(info)
            show(info)
            if trace and frontier == "dense":
                tr = trace_run(lambda: bound(**params))
                tr.pop("kernels")
                show(dict(dist=name, frontier=frontier, traced=True,
                          untraced_ms=timing["seconds"] * 1e3, **tr))
    gs = symmetrised(rmat(tc_scale, edge_factor=16, seed=seed, device=g.device))
    bound = compile_bundled("tc", backend="distributed").bind(gs, mesh=mesh)
    bound()
    sync(on_card)
    t = time.perf_counter()
    got = bound()["triangle_count"]
    sync(on_card)
    secs = time.perf_counter() - t
    count = scipy_triangles(gs)
    if got.dtype != torch.int32 or int(got) != count:
        fail(f"distributed tc = {int(got)} ({got.dtype}), scipy counts {count}")
    info = dict(dist="tc", graph=f"rmat({tc_scale}) symmetrised", E=gs.num_edges,
                triangles=count, seconds=secs)
    infos.append(info)
    show(info)
    return infos


# --------------------------------------------------------------------------
# grid: the 2-D grid, pod-parallel bc and distributed autotune
# --------------------------------------------------------------------------

def grid_shapes(world):
    """(grids, pods) of phase 17 at `world` ranks: at 1 the (1, 1) of each;
    at 4 the grids (2, 2), (1, 4), (4, 1) and the pods (2, 2), (4, 1)."""
    sq = math.isqrt(world)
    grids = dict.fromkeys((r, world // r) for r in (sq, 1, world) if world % r == 0)
    pods = dict.fromkeys((p, world // p) for p in (sq, world) if world % p == 0)
    return list(grids), list(pods)


def agree_across_ranks(value, mesh, what):
    """Fails unless every rank of the 1-D `mesh` holds the same JSON value
    (an all-gather of the first 8 bytes of its sha256)."""
    import hashlib
    import torch
    from repro_torch.core import runtime_dist as rtd
    digest = hashlib.sha256(json.dumps(value, sort_keys=True).encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(digest, "little", signed=True)], device=mesh.device)
    every = rtd.gather(mine, mesh)
    if not bool((every == mine).all()):
        fail(f"{what}: the ranks disagree ({every.tolist()})")


def grid_phase(g, want, srcs, on_card, seed, tune_scale, dist_infos):
    """Phase 17, inside `process_group`, after phase 16: the 2-D grid
    (`dist2d.sssp_2d` == phase 5's `cuda` sssp exactly, `pagerank_2d` ==
    a float64 iteration of as many sweeps at rtol 1e-4), pod-parallel bc
    (`dist.run_pod_parallel` over the 32 sources == phase 5's batched bc
    under phase 6's rules; `_gather_elems` == phase 16's dense bc at one
    pod, else the sum of each pod's slice run alone) and distributed
    autotune of sssp on rmat(tune_scale) (budget 4, every rank's result
    the same, the winner's dist == `cuda`'s)."""
    import tempfile
    import torch
    import torch.distributed as tdist
    from repro_torch.autotune import TuningStore, autotune, schedule_to_dict
    from repro_torch.core import Schedule, compile_bundled, dist, dist2d
    from repro_torch.graph import rmat
    dev = None if on_card else "cpu"
    world = tdist.get_world_size()
    show = shower(tdist.get_rank())
    grids, pod_shapes = grid_shapes(world)
    infos, pr_refs = [], {}
    for shape in grids:
        t = time.perf_counter()
        mesh = dist.make_mesh(shape, (dist2d.DATA, dist2d.MODEL), device=dev)
        tile = dist2d.prepare(g, mesh)
        sync(on_card)
        piece, n_pad = tile["piece"], tile["piece"] * world
        show(dict(grid=shape, prepare_s=time.perf_counter() - t, piece=piece,
                  tile_edges=int(tile["valid"].shape[0]),
                  superstep_elems=dict(gathered=piece * shape[0],
                                       reduce_scattered=piece * shape[1],
                                       one_d_dense=n_pad)))
        dist_out, timing = second_call(lambda: dist2d.sssp_2d(g, mesh, 0), on_card)
        if not torch.equal(dist_out, want[("sssp", "auto")]["dist"]):
            bad = int((dist_out != want[("sssp", "auto")]["dist"]).sum())
            fail(f"sssp_2d {shape}: dist differs from cuda sssp at {bad} vertices")
        info = dict(grid=shape, run="sssp_2d", supersteps=dist2d.sssp_2d.supersteps, **timing)
        infos.append(info)
        show(info)
        pr, timing = second_call(lambda: dist2d.pagerank_2d(g, mesh), on_card)
        iters = dist2d.pagerank_2d.iterations
        if not bool(torch.isfinite(pr).all()):
            fail(f"pagerank_2d {shape}: non-finite ranks")
        if tdist.get_rank() == 0:
            if iters not in pr_refs:
                pr_refs[iters] = pagerank_ref(g, iters)
            ref = pr_refs[iters]
            rel = np.abs(pr.double().cpu().numpy() - ref) / ref
            if not float(rel.max()) <= 1e-4:
                fail(f"pagerank_2d {shape}: {int((rel > 1e-4).sum())} ranks beyond rtol "
                     f"1e-4 of the float64 iteration (largest {float(rel.max()):.3e})")
            timing["max_rel_err_vs_float64"] = float(rel.max())
        info = dict(grid=shape, run="pagerank_2d", iterations=iters, **timing)
        infos.append(info)
        show(info)
    prog = compile_bundled("bc", backend="distributed")
    dense_bc = next(i["gather_elems"] for i in dist_infos
                    if i["dist"] == "bc" and i["frontier"] == "dense")
    for shape in pod_shapes:
        pod_mesh = dist.make_mesh(shape, ("pod", "data"), device=dev)
        out, timing = second_call(lambda: dist.run_pod_parallel(prog, g, pod_mesh, srcs),
                                  on_card)
        compare_outputs(out, want[("bc", "batched")], f"pod bc {shape} vs bc/batched cuda")
        k = len(srcs) // shape[0]
        alone = prog.bind(g, mesh=pod_mesh.axis("data"))
        want_elems = dense_bc if shape[0] == 1 else sum(
            float(alone(sourceSet=srcs[p * k:(p + 1) * k])["_gather_elems"])
            for p in range(shape[0]))
        if float(out["_gather_elems"]) != want_elems:
            fail(f"pod bc {shape}: _gather_elems {float(out['_gather_elems'])}, the pods' "
                 f"own runs {want_elems}")
        info = dict(pods=shape, run="run_pod_parallel bc", sources=len(srcs),
                    gather_elems=float(out["_gather_elems"]), **timing)
        infos.append(info)
        show(info)
    g16 = rmat(tune_scale, edge_factor=16, seed=seed, device=g.device)
    mesh = dist.make_mesh_1d(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tuning.json")
        t = time.perf_counter()
        res = autotune(compile_bundled("sssp", backend="distributed"), g16, budget=4,
                       store=TuningStore(path), mesh=mesh)
        tune_s = time.perf_counter() - t
        stored = TuningStore(path).records() if mesh.rank == 0 else None
    agree_across_ranks(dict(schedule=schedule_to_dict(res.schedule),
                            record=res.record.to_dict()), mesh, "distributed autotune")
    if mesh.rank == 0 and (len(stored) != 1 or stored[0].schedule != res.record.schedule):
        fail("distributed autotune: rank 0's store does not hold the winner")
    base = schedule_to_dict(Schedule())
    for i, trial in enumerate(res.record.trials):
        knobs = {k: v for k, v in trial["schedule"].items() if v != base[k]}
        show(dict(trial=i, ms=trial["ms"], knobs=knobs))
    got = res.program.bind(g16, mesh=mesh)(src=0)["dist"]
    ref = compile_bundled("sssp", backend="cuda").bind(g16)(src=0)["dist"]
    if not torch.equal(got, ref):
        fail(f"distributed autotune: the winner's dist differs from cuda's at "
             f"{int((got != ref).sum())} vertices")
    info = dict(tune=f"rmat({tune_scale})", N=g16.num_nodes, E=g16.num_edges, tune_s=tune_s,
                best_ms=res.record.best_ms, default_ms=res.record.default_ms)
    infos.append(info)
    show(info)
    return infos


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


def attention_ref_in_chunks(q, k, v, chunk, causal=True):
    """attention_ref, one block of `chunk` query rows at a time against the
    kv rows that block can see: the same function as one call, with only
    [BH, chunk, <= SKV] f32 scores live at once. Causal: each block's
    offset SKV' - SQ' is its first row plus SKV - SQ; otherwise every block
    sees every kv row."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    sq, skv = q.shape[1], k.shape[1]
    if causal and skv < sq:
        raise ValueError(f"SKV={skv} < SQ={sq}: some rows see no kv row")
    out = torch.empty_like(q)
    for i in range(0, sq, chunk):
        j = min(i + chunk, sq)
        end = j + skv - sq if causal else skv
        out[:, i:j] = attention_ref(q[:, i:j], k[:, :end], v[:, :end], causal=causal)
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
# lm-families: the moe, hybrid, ssm and encdec families at full size
# --------------------------------------------------------------------------

# (config, prefill length on the card)
FAMILY_RUNS = (("deepseek-moe-16b", 32768), ("zamba2-1.2b", 32768),
               ("xlstm-1.3b", 4096), ("seamless-m4t-large-v2", 32768))
# xlstm's 4,096 tokens (the reference's train_4k length): its sLSTM is a
# recurrence over tokens, a Python loop of about a dozen launches per token
# and layer here; 6 layers x 32,768 tokens would cost 2.4M launches
XLSTM_CUT = "xlstm prefill cut to 4,096 tokens: the sLSTM runs one step per token"
ENCDEC_DEC_TOKENS = 1024        # seamless: decoder tokens beside the frames
FAMILY_CHECK = (2048, 1024)     # kernel vs ref: tokens (frames), decoder tokens
# the same weights upcast to f32: two paths through 24 to 48 layers of f32
# arithmetic in other orders (flash's online softmax against the
# materialized one, the chunked SSD form against its recurrence) agree
# within this on logits of std about 1 (PERF.md, "Findings")
F32_LOGIT_ATOL = 1e-3
# the families whose bf16 end-to-end figures are held at LM_LOGIT_ATOL, and
# whose bf16 plain logits must lie within it of their f32 ones (NVIDIA H100
# 80GB HBM3, 700 W: xlstm 0.1086, seamless 0.0512; PERF.md, "Findings").
# A random-weight MoE's top-6 routing turns bf16's last bits into other
# experts, layer after layer, and zamba2's bf16 noise grows through its 38
# layers (5.2431, 1.8141): their bf16 figures are printed, and each flash
# shape of their path is held against the plain version instead
BF16_HELD_FAMILIES = ("ssm", "encdec")
# xlstm's traced prefill: the profiler's post-processing of the sLSTM
# loop's launches (about 300k at 4,096 tokens) outlasts the run itself
XLSTM_TRACE_TOKENS = 512


@contextlib.contextmanager
def capacity_factor(model, cf):
    """The same weights with another MoE capacity factor: a decode chain
    routes B tokens per step, a prefill all of them, and capacity drops
    depend on that count by design."""
    import dataclasses
    cfg = model.cfg
    model.cfg = model.net.cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    try:
        yield
    finally:
        model.cfg = model.net.cfg = cfg


@contextlib.contextmanager
def one_kernel_silu(model):
    """The MoE and Mamba2 blocks with F.silu (one kernel) in place of
    layers.silu (the reference's four ops, each rounded: five kernels),
    to time what that rounding costs."""
    import torch.nn.functional as F
    from repro_torch.models import layers, moe, ssm
    mlps = [m for m in model.modules() if isinstance(m, layers.MLP) and m.act is layers.silu]
    for m in mlps:
        m.act = F.silu
    moe.silu = ssm.silu = F.silu
    try:
        yield
    finally:
        moe.silu = ssm.silu = layers.silu
        for m in mlps:
            m.act = layers.silu


@contextlib.contextmanager
def each_flash_call_held(rows, chunk, first_of_each_shape=False):
    """Inside, flash_attention calls of the model (through gqa_attention)
    also run attention_ref on the same q, k, v in blocks of `chunk` query
    rows: every call, or with `first_of_each_shape` the first call of each
    (BH, SQ, SKV, D, causal, dtype). Each held call's shape and phase 8's
    figures (flash_vs_plain) go to `rows`; see `held_calls_agree`."""
    from repro_torch.kernels.flash_attention import ops
    kernel, seen = ops.flash_attention, set()

    def held(q, k, v, *, causal=True, **kw):
        out = kernel(q, k, v, causal=causal, **kw)
        key = (*q.shape, k.shape[1], causal, str(q.dtype))
        if not (first_of_each_shape and key in seen):
            seen.add(key)
            want = attention_ref_in_chunks(q, k, v, chunk, causal)
            err, excess, rel_rms = flash_vs_plain(out, want, chunk)
            rows.append(dict(bh=q.shape[0], sq=q.shape[1], skv=k.shape[1], d=q.shape[2],
                             causal=causal, dtype=str(q.dtype), max_abs_err=err,
                             excess=excess, rel_rms=rel_rms))
        return out
    ops.flash_attention = held
    try:
        yield
    finally:
        ops.flash_attention = kernel


def held_calls_agree(cfg, what, rows):
    """Fails unless every held call meets phase 8's rules: |kernel - plain|
    <= FLASH_RTOL·|plain| + FLASH_ATOL elementwise, and each block's rms
    error within FLASH_REL_RMS of the plain block's rms."""
    bad = [r for r in rows if not (r["excess"] <= FLASH_ATOL and r["rel_rms"] <= FLASH_REL_RMS)]
    if bad:
        fail(f"{cfg.name}: {what}: flash_attention disagrees with attention_ref: {bad[0]}")


def flash_calls(cfg):
    """flash_attention calls of one forward. At full size: moe one causal
    D = 128 call per layer (28); hybrid one causal D = 64 call per
    shared-attention site (layers 5, 11, ..., 35 of 38: 6); ssm none;
    encdec 24 non-causal encoder calls, 24 causal decoder self-attention
    calls and 24 cross-attention calls (72)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers if cfg.family == "moe" else 0


def family_batch(cfg, gen, dev, seq, dec_tokens):
    """Seeded inputs: tokens [1, seq], or for encdec frame embeddings
    [1, seq, d] (bf16, std 1) and decoder tokens [1, dec_tokens]."""
    import torch
    if cfg.family == "encdec":
        return {"embeds": torch.randn((1, seq, cfg.d_model), generator=gen, device=dev)
                .to(torch.bfloat16),
                "tokens": torch.randint(0, cfg.vocab, (1, dec_tokens), generator=gen,
                                        device=dev)}
    return {"tokens": torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)}


def head(batch, n, dec_n):
    out = {"tokens": batch["tokens"][:, :dec_n if "embeds" in batch else n]}
    if "embeds" in batch:
        out["embeds"] = batch["embeds"][:, :n]
    return out


def greedy_encdec(model, cache, prompts, new_tokens):
    """ServeEngine.generate's loop for encdec: the prompt through
    decode_step (impl="kernel": the cross-attention at SQ = 1), then greedy
    tokens. Returns (tokens [B, S + new], decode_step calls, the logits of
    the prompt's last step)."""
    import torch
    s = prompts.shape[1]
    logits, steps = None, 0
    for i in range(s):
        logits, cache = model.decode_step(prompts[:, i:i + 1], cache, i, impl="kernel")
        steps += 1
    last_prompt = logits
    out, cur = [prompts], torch.argmax(logits, dim=-1)[:, None]
    for j in range(new_tokens):
        out.append(cur)
        if j == new_tokens - 1:
            break
        logits, cache = model.decode_step(cur, cache, s + j, impl="kernel")
        steps += 1
        cur = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(out, dim=1), steps, last_prompt


def prefill_and_chain(model, cfg, pt, enc_out):
    """The prefill forward's last logits (through the kernel) and the
    decode chain's at position 31, for the same 4 prompts; MoE at capacity
    factor 16."""
    if cfg.family == "encdec":
        cache = model.init_cache(4, 64, enc_len=enc_out.shape[1])
        cache["enc_out"] = enc_out
        _, _, ld = greedy_encdec(model, cache, pt, 1)
        return model.net.decode_train(pt, enc_out, impl="kernel", last_only=True)[:, 0], ld
    with capacity_factor(model, 16.0 if cfg.family == "moe" else cfg.moe_capacity_factor):
        lf, _ = model({"tokens": pt}, impl="kernel", last_only=True)
        cache = model.init_cache(4, 64)
        for i in range(32):
            ld, cache = model.decode_step(pt[:, i:i + 1], cache, i)
    return lf[:, 0], ld


def family_serve(model, cfg, seed, dev, on_card, enc_len, chunk):
    """4 seeded prompts of 32 tokens, 16 new each: ServeEngine for the token
    families, the decode_step loop against `enc_len` encoded frames for
    encdec (the warm-up's cross call at SQ = 1 held against the plain
    version); the first new token against the argmax of the engine's own
    decode chain. Returns (the serve record, the prompts, encdec's encoder
    output)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.serve import ServeEngine
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    pt = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    rec, enc_out = dict(prompts=list(prompts.shape), new_tokens=16), None
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        frames = torch.randn((4, enc_len, cfg.d_model), generator=gen, device=dev).to(
            model.net.embed.dtype)
        enc_out = model.net.encode(frames, impl="kernel")

        def serve():
            cache = model.init_cache(4, 64, enc_len=enc_len)
            cache["enc_out"] = enc_out
            return greedy_encdec(model, cache, pt, 16)
        held_rows = []
        with each_flash_call_held(held_rows, chunk, first_of_each_shape=True):
            serve()                                 # warm-up, its cross call held
        held_calls_agree(cfg, "decode_step", held_rows)
        rec["flash_shapes_held"] = held_rows
        sync()
        flash_attention.launches = 0
        t = time.perf_counter()
        toks, steps, ld = serve()
        sync()
        serve_s = time.perf_counter() - t
        rec.update(enc_len=enc_len, flash_launches=flash_attention.launches)
        if on_card and flash_attention.launches != steps * cfg.n_dec_layers:
            fail(f"{cfg.name}: {steps} decode steps launched flash_attention "
                 f"{flash_attention.launches} times, not {steps * cfg.n_dec_layers}")
        tokens = toks.cpu().numpy()
    else:
        engine = ServeEngine(model, max_len=64, batch_size=4)
        engine.generate(prompts, new_tokens=2)      # warm-up
        sync()
        t = time.perf_counter()
        tokens = engine.generate(prompts, new_tokens=16).tokens
        sync()
        serve_s = time.perf_counter() - t
        steps = prompts.shape[1] + 16 - 1
        cache = model.init_cache(4, 64)
        for i in range(32):
            ld, cache = model.decode_step(pt[:, i:i + 1], cache, i)
    if tokens.shape != (4, 48) or not np.array_equal(tokens[:, :32], prompts):
        fail(f"{cfg.name}: serving returned {tokens.shape} or changed the prompts")
    rec.update(serve_s=serve_s, decode_steps=steps, ms_per_decode_step=1e3 * serve_s / steps,
               first_token_equal=bool(np.array_equal(tokens[:, 32],
                                                     ld.argmax(-1).cpu().numpy())))
    if not rec["first_token_equal"]:
        fail(f"{cfg.name}: the first new token differs from its decode chain's argmax")
    return rec, pt, enc_out


def hold_logits(cfg, what, got, want, atol, held):
    """max |got - want| (and argmax agreement where the top-2 gap of
    `want` exceeds atol) as a record; fails if `held` and it is over."""
    err = float((got - want).abs().max())
    gap = top2_gap(want)
    same = got.argmax(-1) == want.argmax(-1)
    rec = dict(max_abs=err, atol=atol, held=held,
               argmax_equal_where_clear=bool(same[gap > atol].all()))
    if held and not (err <= atol and rec["argmax_equal_where_clear"]):
        fail(f"{cfg.name}: {what}: max abs diff {err} > {atol} or another argmax where the "
             "top-2 gap is clear")
    return rec


def lm_families_phase(seed, dev, on_card, trace):
    """Each family of FAMILY_RUNS at full width and depth (smoke size on
    the CPU), bf16, seeded init, built and freed in turn: the prefill
    through the kernel (second call timed, its flash launches counted; the
    first call holds the first flash call of each shape against
    attention_ref), MoE and Mamba2 prefill once more with F.silu, every
    flash call of a 2,048-token forward against attention_ref, MoE
    repeatability, serving; then the same weights upcast to f32 for the
    end-to-end checks (kernel vs ref, prefill vs decode chain). The bf16
    end-to-end figures are held at LM_LOGIT_ATOL for BF16_HELD_FAMILIES,
    and printed for the others."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import build
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    chunk = PLAIN_CHUNK if on_card else 64
    print(f"  {XLSTM_CUT}")
    out = []
    for name, card_seq in FAMILY_RUNS:
        cfg = ARCHS[name] if on_card else ARCHS[name].smoke()
        want_launches = flash_calls(cfg)
        seq = card_seq if on_card else 128
        dec_tokens = ENCDEC_DEC_TOKENS if on_card else 64
        check_seq, check_dec = FAMILY_CHECK if on_card else (64, 32)
        if on_card:
            gc.collect()
            torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() if on_card else 0
        t = t_family = time.perf_counter()
        model = build(cfg, device=dev, seed=seed)
        sync()
        stages = {}                     # wall seconds of each step of the phase
        info = dict(model=cfg.name, family=cfg.family,
                    parameters=sum(p.numel() for p in model.parameters()),
                    layers=cfg.n_layers, d_model=cfg.d_model, build_s=time.perf_counter() - t,
                    seq=seq, weights_gb=sum(p.numel() * p.element_size()
                                            for p in model.parameters()) / 1e9)
        if cfg.family == "encdec":
            info["decoder_tokens"] = dec_tokens
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        batch = family_batch(cfg, gen, dev, seq, dec_tokens)
        small = head(batch, check_seq, check_dec)
        with torch.inference_mode():
            # 1. prefill through the kernel, the first call's flash shapes
            #    held against the plain version, the second call timed
            shapes = []
            with each_flash_call_held(shapes, chunk, first_of_each_shape=True):
                model(batch, impl="kernel", last_only=True)
            sync()
            held_calls_agree(cfg, "prefill", shapes)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = 0
            t = time.perf_counter()
            logits, aux = model(batch, impl="kernel", last_only=True)
            sync()
            secs = time.perf_counter() - t
            launches = flash_attention.launches
            if tuple(logits.shape) != (1, 1, cfg.vocab_padded) or \
                    not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(aux)):
                fail(f"{cfg.name}: prefill logits {tuple(logits.shape)} or non-finite values")
            if on_card and launches != want_launches:
                fail(f"{cfg.name}: the prefill launched flash_attention {launches} times, "
                     f"not {want_launches}")
            n_tok = seq + (dec_tokens if cfg.family == "encdec" else 0)
            info.update(prefill_s=secs, prefill_tokens_per_s=n_tok / secs,
                        flash_launches=launches, aux=float(aux), flash_shapes_held=shapes,
                        peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9
                        if on_card else None, held_before_gb=held / 1e9 if on_card else None)
            if cfg.family in ("moe", "hybrid"):
                with one_kernel_silu(model):
                    for _ in range(2):      # the second call timed
                        t = time.perf_counter()
                        model(batch, impl="kernel", last_only=True)
                        sync()
                info["prefill_s_with_F_silu"] = time.perf_counter() - t
            stages["prefill"] = time.perf_counter() - t_family
            if trace:
                t = time.perf_counter()
                traced, untraced_ms = batch, secs * 1e3
                if cfg.family == "ssm":
                    traced = head(batch, XLSTM_TRACE_TOKENS, XLSTM_TRACE_TOKENS)
                    model(traced, impl="kernel", last_only=True)    # warm-up at that length
                    sync()
                    t_short = time.perf_counter()
                    model(traced, impl="kernel", last_only=True)
                    sync()
                    untraced_ms = 1e3 * (time.perf_counter() - t_short)
                tr = trace_run(lambda: model(traced, impl="kernel", last_only=True))
                tr.pop("kernels")
                print("  " + json.dumps(dict(call=f"{cfg.name} prefill",
                                             tokens=traced["tokens"].shape[1],
                                             untraced_ms=untraced_ms, **tr)))
                stages["trace"] = time.perf_counter() - t
            del batch, logits
            t = time.perf_counter()

            # 2. every flash call of a check_seq forward against the plain
            #    version on the same q, k, v; the forward against impl="ref"
            calls = []
            with each_flash_call_held(calls, chunk):
                lk, _ = model(small, impl="kernel", last_only=True)
            lr, _ = model(small, impl="ref", last_only=True)
            worst = max(calls, key=lambda r: r["excess"], default=None)
            info.update(check_seq=check_seq, flash_calls_held=len(calls),
                        flash_worst_call=worst, flash_rtol=FLASH_RTOL, flash_atol=FLASH_ATOL,
                        flash_rel_rms=FLASH_REL_RMS)
            if cfg.family == "encdec":
                info["check_decoder_tokens"] = check_dec
            if len(calls) != want_launches:
                fail(f"{cfg.name}: {len(calls)} flash calls held, not {want_launches}")
            held_calls_agree(cfg, f"a {check_seq}-token forward", calls)
            # 3. MoE: two forwards bitwise equal (the combine has no atomics)
            if cfg.family == "moe":
                l1, a1 = model(small, impl="kernel")
                l2, a2 = model(small, impl="kernel")
                info["repeat_bitwise_equal"] = bool(torch.equal(l1, l2) and torch.equal(a1, a2))
                del l1, l2
                if not info["repeat_bitwise_equal"]:
                    fail(f"{cfg.name}: two forwards on the same tokens differ")

            stages["checks"] = time.perf_counter() - t

            # 4. serve, bf16; the prefill against the decode chain
            t = time.perf_counter()
            serve, pt, enc_out = family_serve(model, cfg, seed, dev, on_card, check_seq, chunk)
            lf, ld = prefill_and_chain(model, cfg, pt, enc_out)
            stages["serve"] = time.perf_counter() - t

            # 5. the same weights in f32: the end-to-end checks
            t = time.perf_counter()
            model.float()
            model.cfg = model.net.cfg = dataclasses.replace(cfg, dtype="float32")
            lk32, _ = model(small, impl="kernel", last_only=True)
            lr32, _ = model(small, impl="ref", last_only=True)
            lf32, ld32 = prefill_and_chain(model, model.cfg, pt,
                                           None if enc_out is None else enc_out.float())
            sync()
            stages["f32"] = time.perf_counter() - t
            bf16_off = float((lr - lr32).abs().max())
            held16 = cfg.family in BF16_HELD_FAMILIES
            info.update(
                bf16_ref_vs_f32_ref_max_abs=bf16_off, logit_std=float(lr32.std()),
                kernel_vs_ref_f32=hold_logits(cfg, "kernel vs ref (f32)", lk32[:, 0],
                                              lr32[:, 0], F32_LOGIT_ATOL, True),
                kernel_vs_ref_bf16=hold_logits(cfg, "kernel vs ref (bf16)", lk[:, 0], lr[:, 0],
                                               LM_LOGIT_ATOL, held16),
                prefill_vs_decode_f32=hold_logits(cfg, "prefill vs decode chain (f32)", ld32,
                                                  lf32, F32_LOGIT_ATOL, True),
                prefill_vs_decode_bf16=hold_logits(cfg, "prefill vs decode chain (bf16)", ld,
                                                   lf, LM_LOGIT_ATOL, held16),
                serve=serve, stage_s=stages)
            print("  " + json.dumps(info))
            if held16 and not bf16_off <= LM_LOGIT_ATOL:
                fail(f"{cfg.name}: bf16 plain lies {bf16_off} from f32 plain, over "
                     f"{LM_LOGIT_ATOL}")
        out.append(info)
        del model, small, lk, lr, lf, ld, lk32, lr32, lf32, ld32, enc_out
    return out


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


# --------------------------------------------------------------------------
# train: the LM training path (phase 18 on one card, phase 19 across ranks)
# --------------------------------------------------------------------------

TRAIN_ARCH = "qwen2.5-3b"
# (seq, global batch, microbatches, steps, lr): the card's run and the rehearsal's
TRAIN_RUN = dict(seq=2048, global_batch=8, microbatches=4, steps=5, lr=1e-3)
TRAIN_REHEARSAL = dict(seq=64, global_batch=8, microbatches=4, steps=5, lr=1e-3)
RESUME_LAYERS = 2             # crash and resume at full width, 2 layers
DIST_LAYERS = 4               # phase 19: full width, 4 layers
DIST_RUN = dict(seq=2048, global_batch=8, microbatches=2, steps=5, resume_at=3, lr=1e-3)
DIST_REHEARSAL = dict(DIST_RUN, seq=64)
DEEP_STEPS = 3                # phase 19 also times (2, 2) at full depth: its peak and steps
# Two bf16 runs of the same steps agree on their losses within this
# (relative): a sharded step groups its rows' gradient sums otherwise, and
# the embedding backward adds with atomics, so parameters differ by a bf16
# ulp (2^-8 relative) here and there from the first step on. Read on the
# card: phase 18's resume equal to the straight run bitwise, phase 19's
# meshes within 6.6e-6 of each other and of the unbroken run
TRAIN_LOSS_RTOL = 1e-4
# ... and on m and v, leaf by leaf, within this distance |got - want| /
# |want| (the largest over leaves). Read by tests/test_torch_launch.py::
# test_resumed_moments_match_the_unbroken_run on a 4-layer bf16 smoke
# model over 4 gloo ranks, where a bf16 ulp weighs most: an unbroken run
# on another mesh lies 2.6e-2 away, a resume 1.1e-2, and a restore whose
# m and v are zeroed 0.96 (its next loss within 2e-5 of the right one)
MOMENT_RTOL = 0.1
# the card's f32 step against the CPU's on the same weights
CARD_VS_CPU_RTOL = 1e-4


def bf16_params_close(got, want, lr):
    """Largest excess of |got - want| over 2.5·lr + 2^-7·|want| (<= 0: they
    agree): one AdamW step moves an element by about ±lr, so a near-zero
    gradient whose sign differs between two runs moves it 2·lr the other
    way, and bf16 rounds the result to 2^-8 of its size."""
    worst = float("-inf")
    for n, w in want.items():
        g, w = got[n].detach().float(), w.float()
        worst = max(worst, float(((g - w).abs() - (2.5 * lr + 2 ** -7 * w.abs())).max()))
    return worst


def moments_apart(got, want):
    """The largest relative distance |got - want| / |want| (Frobenius)
    between two optimizer states' m and v (group → name → tensor), leaf
    by leaf; an all-zero leaf must be matched exactly."""
    worst = 0.0
    for group in ("m", "v"):
        for n, w in want[group].items():
            w = w.float()
            d = float((got[group][n].to(w.device).float() - w).norm())
            ref = float(w.norm())
            worst = max(worst, d / ref if ref else (0.0 if d == 0 else float("inf")))
    return worst


def smi_line(on_card):
    if not on_card:
        return "cpu (rehearsal)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def train_phase(seed, dev, on_card, trace=False):
    """Phase 18: qwen2.5-3b trained at full width and depth through
    launch.train's pieces (5 steps, seq 2048, global batch 8 in 4
    microbatches, remat, impl="ref"); crash and resume at full width with
    2 layers through a checkpoint on disk; one f32 smoke step on the card
    against the CPU's; and the flash kernel refusing to run under grad.
    With `trace`, a sixth step under the profiler."""
    import copy
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as lt
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import init_state, make_train_step
    knobs = TRAIN_RUN if on_card else TRAIN_REHEARSAL
    seq, gb, mb, steps, lr = (knobs[k] for k in ("seq", "global_batch", "microbatches",
                                                 "steps", "lr"))
    cfg = ARCHS[TRAIN_ARCH] if on_card else ARCHS[TRAIN_ARCH].smoke()
    card = smi_line(on_card)
    if on_card:
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() if on_card else 0
    dc = lt.data_config(cfg, seq, gb)

    # 1. the full run
    t = time.perf_counter()
    model = build(cfg, device=dev, seed=seed)
    state = init_state(model)
    step_fn = make_train_step(model, lt.optimizer_config(cfg, steps, lr), microbatches=mb,
                              impl="ref", remat=True)
    sync(on_card)
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        before = {n: float(p.float().abs().sum()) for n, p in state.params.items()}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, lt.batch_for(cfg, dc, i, dev))
        losses.append(float(metrics["loss"]))        # waits for the step
        secs.append(time.perf_counter() - t)
    peak = (torch.cuda.max_memory_allocated() - held) if on_card else None
    with torch.no_grad():
        moved = {n for n, p in state.params.items() if float(p.float().abs().sum()) != before[n]}
    # every matrix must move; a norm scale of 1.0 may not, since an update
    # of lr = 1e-3 is below half a bf16 ulp there
    still = [n for n, p in state.params.items() if p.ndim >= 2 and n not in moved]
    step_s = sum(secs[1:]) / len(secs[1:])
    tokens = gb * seq
    info = dict(train="full", model=cfg.name, parameters=n_params, layers=cfg.n_layers,
                d_model=cfg.d_model, dtype=cfg.dtype, seq=seq, global_batch=gb,
                microbatches=mb, remat=True, impl="ref", card=card, build_s=build_s,
                losses=losses, step_s=secs, step_s_mean_2_to_5=step_s,
                tokens_per_s=tokens / step_s, model_flops_per_step=6 * n_params * tokens,
                mfu_vs_bf16_peak=6 * n_params * tokens / step_s / BF16_OPS_PER_S,
                bf16_peak_ops_per_s=BF16_OPS_PER_S, peak_above_held_bytes=peak,
                held_before_bytes=held if on_card else None,
                grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
                params_moved=f"{len(moved)}/{len(before)}")
    print("  " + json.dumps(info), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss in {losses}")
    if int(state.step) != steps:
        fail(f"train: state.step is {int(state.step)}, not {steps}")
    if still:
        fail(f"train: the matrices {still[:5]} did not move")
    if trace:
        batch = lt.batch_for(cfg, dc, steps, dev)
        tr = trace_run(lambda: step_fn(state, batch), top=16)
        tr.pop("kernels")
        print("  " + json.dumps(dict(call="train step", untraced_ms=step_s * 1e3, **tr)),
              flush=True)
    del model, state, step_fn, metrics
    if on_card:
        torch.cuda.empty_cache()

    # 2. crash and resume at full width, RESUME_LAYERS layers
    cfg2 = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    oc = lt.optimizer_config(cfg2, 3, lr)

    def fresh(s):
        m = build(cfg2, device=dev, seed=s)
        return m, init_state(m), make_train_step(m, oc, microbatches=mb, impl="ref")

    _, straight, step = fresh(seed)
    for i in range(3):
        straight, ms = step(straight, lt.batch_for(cfg2, dc, i, dev))
    want_loss = float(ms["loss"])
    want = {n: p.detach().clone() for n, p in straight.params.items()}
    want_opt = {g: {n: t.clone() for n, t in straight.opt[g].items()} for g in ("m", "v")}
    del straight, step
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        _, state, step = fresh(seed)
        for i in range(2):
            state, _ = step(state, lt.batch_for(cfg2, dc, i, dev))
        sync(on_card)
        t = time.perf_counter()
        path = ckpt.save(d, 2, state)
        save_s = time.perf_counter() - t
        written = dir_bytes(path)
        del state, step                                   # "crash"
        _, like, step = fresh(seed + 1)
        t = time.perf_counter()
        state = ckpt.restore(d, ckpt.latest_step(d), like)
        sync(on_card)
        restore_s = time.perf_counter() - t
        state, mr = step(state, lt.batch_for(cfg2, dc, 2, dev))
        excess = bf16_params_close(state.params, want, float(mr["lr"]))
        apart = moments_apart(state.opt, want_opt)
        resume = dict(train="crash-and-resume", layers=RESUME_LAYERS, card=card,
                      straight_loss_3=want_loss, resumed_loss_3=float(mr["loss"]),
                      checkpoint_bytes=written, save_s=save_s, restore_s=restore_s,
                      param_excess_over_bf16_tolerance=excess, moments_apart=apart,
                      disk_free_bytes=shutil.disk_usage(d).free)
        print("  " + json.dumps(resume), flush=True)
        if not math.isclose(resume["resumed_loss_3"], want_loss, rel_tol=TRAIN_LOSS_RTOL):
            fail(f"train: resumed loss {resume['resumed_loss_3']} vs straight {want_loss}")
        if excess > 0:
            fail(f"train: resumed parameters exceed the bf16 tolerance by {excess}")
        if not apart <= MOMENT_RTOL:
            fail(f"train: resumed m and v lie {apart} from the straight run's")
        del state, step, like, want, want_opt
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not on_card:
        return dict(info, resume=resume)

    # 3. one f32 smoke step on the card against the same step on the CPU
    cfg32 = dataclasses.replace(ARCHS[TRAIN_ARCH].smoke(), dtype="float32")
    dc32 = lt.data_config(cfg32, 64, 8)
    oc32 = lt.optimizer_config(cfg32, 10, lr)
    cpu_model = build(cfg32, device="cpu", seed=seed)
    card_model = copy.deepcopy(cpu_model).to(dev)
    out = []
    for m, where in ((cpu_model, "cpu"), (card_model, dev)):
        _, met = make_train_step(m, oc32, microbatches=2)(init_state(m),
                                                         lt.batch_for(cfg32, dc32, 0, where))
        out.append({k: float(v) for k, v in met.items()})
    versus = dict(train="card-vs-cpu", model=cfg32.name, dtype="float32", cpu=out[0],
                  card=out[1], card_name=card)
    print("  " + json.dumps(versus), flush=True)
    for k in ("loss", "grad_norm"):
        if not math.isclose(out[0][k], out[1][k], rel_tol=CARD_VS_CPU_RTOL):
            fail(f"train: the card's {k} {out[1][k]} vs the CPU's {out[0][k]}")

    # 4. the flash kernel has no backward: impl="kernel" under grad raises
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    launches = flash_attention.launches
    try:
        make_train_step(card_model, oc32, impl="kernel")(
            init_state(card_model), lt.batch_for(cfg32, dc32, 0, dev))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"  impl='kernel' under grad raises: {str(e)[:100]}...", flush=True)
    else:
        fail("train: impl='kernel' with grad enabled ran instead of raising")
    if flash_attention.launches != launches:
        fail("train: the refused kernel call counted a launch")
    return dict(info, resume=resume, card_vs_cpu=versus)


def train_dist_phase(seed, on_card):
    """Phase 19, inside `process_group`: qwen2.5-3b at full width with
    DIST_LAYERS layers (smoke size in the rehearsal), sharded by
    launch.sharding on meshes of the world's ranks. At four ranks: 3 steps
    on (2, 2) and a checkpoint, then from it 2 steps on (4, 1) and 2 on
    (1, 4), and an unbroken (2, 2) run of 5 steps; at one rank (1, 1) for
    each. Losses agree across meshes and with the unbroken run, so do the
    resumed runs' m and v at the last step (gathered, leaf by leaf), and
    every rank holds exactly the bytes of params + m + v its specs give.
    Then DEEP_STEPS steps on the first mesh at the config's full depth,
    for the peak and step times of the sharded path there."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.hlo_cost import Census
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import init_state, make_train_step
    knobs = DIST_RUN if on_card else DIST_REHEARSAL
    seq, gb, mb, steps, cut, lr = (knobs[k] for k in ("seq", "global_batch", "microbatches",
                                                      "steps", "resume_at", "lr"))
    base = ARCHS[TRAIN_ARCH] if on_card else ARCHS[TRAIN_ARCH].smoke()
    cfg = dataclasses.replace(base, n_layers=DIST_LAYERS)
    world, rank = tdist.get_world_size(), tdist.get_rank()
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if on_card else "cpu"
    show = shower(rank)
    grid = {4: ("2,2", "4,1", "1,4"), 1: ("1,1",) * 3}.get(world)
    if grid is None:
        fail(f"train-dist runs on 1 or 4 ranks, not {world}")
    oc = lt.optimizer_config(cfg, steps, lr)      # one schedule for every run
    dc = lt.data_config(cfg, seq, gb)
    card = smi_line(on_card)
    d = [tempfile.mkdtemp(prefix="chip_smoke_dist-") if rank == 0 else None]
    tdist.broadcast_object_list(d, src=0)
    d = d[0]

    def whole_moments(state):
        """m and v gathered leaf by leaf (a collective on every rank); rank 0
        keeps them, on the host."""
        out = {"m": {}, "v": {}}
        for group in out:
            for n, t in state.opt[group].items():
                w = state.layout.gather(n, t)
                if rank == 0:
                    out[group][n] = w.cpu()
        return out

    def train(spec, start, stop, restore=False, save=False, keep=None, against=None,
              c=cfg):
        mesh = lt.make_mesh(spec, device=dev)
        model = build(c, device=dev, seed=seed)
        whole = {n: (p.numel(), p.element_size()) for n, p in model.net.named_parameters()}
        state = lt.shard(init_state(model), mesh, gb)
        lay = state.layout
        if restore:
            state = ckpt.restore(d, cut, state, shardings=lay)
        step_fn = make_train_step(model, oc, microbatches=mb, impl="ref")
        rows = lay.rows(gb)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        losses, secs = [], []
        for i in range(start, stop):
            t = time.perf_counter()
            state, metrics = step_fn(state, lt.batch_for(c, dc, i, dev, rows))
            losses.append(float(metrics["loss"]))
            secs.append(time.perf_counter() - t)
        out = dict(mesh=spec, steps=[start, stop], losses=losses, step_s=secs,
                   held_bytes=sh.held_bytes(state),
                   spec_bytes=sum(n // math.prod(sh._axis_size(e, mesh.shape)
                                                 for e in lay.specs[name]) * (size + 8)
                                  for name, (n, size) in whole.items()),
                   whole_bytes=sum(n * (size + 8) for n, size in whole.values()),
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if on_card else None,
                   rows=[rows.start, rows.stop])
        if keep is not None or against is not None:
            moments = whole_moments(state)
            if keep is not None:
                keep.update(moments)
            elif rank == 0:
                out.update(moments_apart=moments_apart(moments, against))
            del moments
        if save:
            t = time.perf_counter()
            path = ckpt.save(d, stop, state)
            out.update(save_s=time.perf_counter() - t,
                       checkpoint_bytes=dir_bytes(path) if rank == 0 else None)
        del model, state, step_fn
        if on_card:
            torch.cuda.empty_cache()
        return out

    def census_step(spec):
        """One step of the first mesh under the census (every rank), against
        the dry run of the same cell on a fake world (rank 0)."""
        mesh = lt.make_mesh(spec, device=dev)
        model = build(cfg, device=dev, seed=seed)
        state = lt.shard(init_state(model), mesh, gb)
        step_fn = make_train_step(model, oc, microbatches=mb, impl="ref")
        census = Census()
        with census:
            step_fn(state, lt.batch_for(cfg, dc, 0, dev, state.layout.rows(gb)))
        sync(on_card)
        got = census.result()
        del model, state, step_fn
        if on_card:
            torch.cuda.empty_cache()
        if rank:
            return got
        dry = dry_run_of(TRAIN_ARCH, on_card, DIST_LAYERS, world, spec, seq, gb, mb)
        show(dict(train_dist="census", mesh=spec, layers=DIST_LAYERS, card=card,
                  collective_bytes=got["collective_bytes"],
                  dry_collective_bytes=dry["collective_bytes"], flops=got["flops"],
                  dry_flops=dry["flops"], collectives=got["collective_breakdown"]))
        if got["collective_bytes"] != dry["collective_bytes"] or (
                world > 1 and not got["collective_bytes"]):
            fail(f"train-dist census ({spec}): rank 0's collective bytes "
                 f"{got['collective_bytes']} != the dry run's {dry['collective_bytes']}")
        return got

    kept = {}
    try:
        runs = {"unbroken": train(grid[0], 0, steps, keep=kept),
                "first": train(grid[0], 0, cut, save=True),
                "resumed-a": train(grid[1], cut, steps, restore=True, against=kept),
                "resumed-b": train(grid[2], cut, steps, restore=True, against=kept)}
        del kept
        deep = train(grid[0], 0, DEEP_STEPS, c=dataclasses.replace(cfg, n_layers=base.n_layers))
        counted = census_step(grid[0])
    finally:
        tdist.barrier()
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
    every = [None] * world
    tdist.all_gather_object(every, dict(runs, full_depth=deep))
    show(dict(train_dist="runs", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
              seq=seq, global_batch=gb, microbatches=mb, world=world, card=card,
              runs={k: {x: v[x] for x in ("mesh", "steps", "losses", "held_bytes",
                                          "spec_bytes", "whole_bytes", "peak_bytes",
                                          "save_s", "checkpoint_bytes", "moments_apart")
                                 if x in v}
                    for k, v in runs.items()},
              step_s_by_rank=[{k: v["step_s"] for k, v in r.items()} for r in every],
              peak_bytes_by_rank=[{k: v["peak_bytes"] for k, v in r.items()} for r in every],
              full_depth=dict(layers=base.n_layers, mesh=deep["mesh"], losses=deep["losses"],
                              held_bytes=deep["held_bytes"], spec_bytes=deep["spec_bytes"],
                              whole_bytes=deep["whole_bytes"])))
    unbroken = runs["unbroken"]["losses"]
    for name, r in runs.items():
        if r["held_bytes"] != r["spec_bytes"]:
            fail(f"train-dist {name} ({r['mesh']}) rank {rank}: holds {r['held_bytes']} "
                 f"bytes, the specs give {r['spec_bytes']}")
        want = unbroken[r["steps"][0]:r["steps"][1]]
        if not all(math.isfinite(x) and math.isclose(x, w, rel_tol=TRAIN_LOSS_RTOL)
                   for x, w in zip(r["losses"], want)):
            fail(f"train-dist {name} ({r['mesh']}): losses {r['losses']} vs unbroken {want}")
    for name in ("resumed-a", "resumed-b"):
        apart = every[0][name]["moments_apart"]
        if not apart <= MOMENT_RTOL:
            fail(f"train-dist {name} ({runs[name]['mesh']}): m and v at step {steps} lie "
                 f"{apart} from the unbroken run's")
    if deep["held_bytes"] != deep["spec_bytes"] or not all(map(math.isfinite, deep["losses"])):
        fail(f"train-dist full depth ({deep['mesh']}) rank {rank}: holds {deep['held_bytes']} "
             f"bytes (the specs give {deep['spec_bytes']}), losses {deep['losses']}")
    for r in every:
        r.pop("full_depth")
        if [v["losses"] for v in r.values()] != [v["losses"] for v in runs.values()]:
            fail("train-dist: ranks disagree on the losses")
    return runs


# --------------------------------------------------------------------------
# offline: edge-list I/O, the analysis CLI, the census against the dry run
# --------------------------------------------------------------------------

IO_SCALE = 16                 # rmat(16) through save_edgelist / load_edgelist


def io_check(scale, seed, dev, on_card):
    """rmat(scale) written by save_edgelist and read back by load_edgelist
    onto the card: every edge array equal to the source graph's; the node
    arrays equal up to the largest id on an edge (the loader takes the node
    count n from it, as the reference's does), the vertices above it
    without edges in the source; the edge keys src·n + dst."""
    import tempfile
    import torch
    from repro_torch.graph import FIELDS, io, rmat
    g = rmat(scale, edge_factor=16, seed=seed, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io-") as d:
        path = os.path.join(d, "g.txt")
        t = time.perf_counter()
        io.save_edgelist(g, path)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        back = io.load_edgelist(path, device=None if on_card else dev)
        sync(on_card)
        load_s = time.perf_counter() - t
    n = back.num_nodes
    if back.num_edges != g.num_edges or back.indptr.device.type != g.indptr.device.type:
        fail(f"io: {back.num_edges} edges on {back.indptr.device}, not {g.num_edges} on "
             f"{g.indptr.device}")
    per_node = {"indptr": n + 1, "rev_indptr": n + 1, "out_degree": n, "in_degree": n}
    for f in FIELDS:
        want = getattr(g, f)
        if f in per_node:
            want = want[:per_node[f]]
        if f == "edge_key":                   # src·N + dst, wrapped to int32: N is n here
            want = (g.edge_src.long() * n + g.indices.long()).to(torch.int32)
        if not torch.equal(getattr(back, f), want):
            fail(f"io: {f} of the loaded graph differs from the source's")
    if int(g.out_degree[n:].abs().sum() + g.in_degree[n:].abs().sum()):
        fail(f"io: vertices from {n} on have edges, yet the loaded graph has {n} nodes")
    return dict(io=f"rmat({scale})", nodes=g.num_nodes, loaded_nodes=n,
                isolated_top_vertices_dropped=g.num_nodes - n, edges=g.num_edges,
                file_bytes=size, save_s=save_s, load_s=load_s)


def cli_check():
    """`python -m repro_torch.analyze` in a process of its own: the bundled
    programs strict-clean under --backend cuda, a racy program exits 1
    with SP101."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = {}
    for what, argv, code, text in (
            ("bundled", ["--bundled", "--strict", "--backend", "cuda"], 0,
             "0 error(s), 0 warning(s)"),
            ("race", [os.path.join(HERE, "tests", "programs_bad", "race_cross_write.sp")], 1,
             "SP101")):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.analyze", *argv],
                           capture_output=True, text=True, env=env, timeout=300)
        if r.returncode != code or text not in r.stdout:
            fail(f"analyze {what}: exit {r.returncode} (want {code}), output "
                 f"{r.stdout[-300:]!r} {r.stderr[-300:]!r}")
        out[what] = dict(exit=r.returncode, last_line=r.stdout.strip().splitlines()[-1],
                         seconds=time.perf_counter() - t)
    return out


def census_check(seed, dev, on_card, trained):
    """One more step of phase 18's cell under the census of launch.hlo_cost
    on the card, against the dry run's census of the same cell on meta:
    dot FLOPs and bytes equal exactly; the roofline terms of launch.roofline,
    the measured step over its bound, 6·N·T over the census FLOPs, and the
    dry run's predicted peak beside phase 18's measured one."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun, hlo_cost, roofline
    from repro_torch.launch import train as lt
    from repro_torch.models import build
    from repro_torch.train import init_state, make_train_step
    knobs = TRAIN_RUN if on_card else TRAIN_REHEARSAL
    seq, gb, mb = knobs["seq"], knobs["global_batch"], knobs["microbatches"]
    cfg = ARCHS[TRAIN_ARCH] if on_card else ARCHS[TRAIN_ARCH].smoke()
    t = time.perf_counter()
    dry = dryrun.train_census(cfg, seq=seq, global_batch=gb, microbatches=mb, impl="ref")
    dry_s = time.perf_counter() - t
    model = build(cfg, device=dev, seed=seed)
    state = init_state(model)
    step_fn = make_train_step(model, lt.optimizer_config(cfg, knobs["steps"], knobs["lr"]),
                              microbatches=mb, impl="ref", remat=True)
    batch = lt.batch_for(cfg, lt.data_config(cfg, seq, gb), 0, dev)
    census = hlo_cost.Census()
    t = time.perf_counter()
    with census:
        step_fn(state, batch)
    sync(on_card)
    card_s = time.perf_counter() - t
    card = census.result()
    del model, state, step_fn, batch
    if on_card:
        torch.cuda.empty_cache()
    terms = roofline.terms(card)
    n, tokens = trained["parameters"], gb * seq
    step_s = trained["step_s_mean_2_to_5"]
    predicted = dry["memory"]["argument_size_in_bytes"] + dry["memory"]["temp_size_in_bytes"]
    info = dict(census="train step", model=cfg.name, seq=seq, global_batch=gb,
                microbatches=mb, card=smi_line(on_card),
                card_flops=card["flops"], dry_flops=dry["flops"],
                card_dot_bytes=card["dot_bytes"], dry_dot_bytes=dry["dot_bytes"],
                card_ops=card["num_computations"], unknown_trip_bodies=dry["unknown_trip_bodies"],
                roofline=terms, measured_step_s=step_s,
                step_over_bound=step_s / terms["step_lower_bound_s"],
                model_flops_6NT=6 * n * tokens, useful_fraction=6 * n * tokens / card["flops"],
                dry_predicted_peak_bytes=predicted,
                dry_argument_bytes=dry["memory"]["argument_size_in_bytes"],
                dry_temp_bytes=dry["memory"]["temp_size_in_bytes"],
                phase18_peak_above_held_bytes=trained["peak_above_held_bytes"],
                census_step_s_on_card=card_s, dry_census_s=dry_s,
                dry_microbatches_run=dry["census"]["microbatches_run"])
    print("  " + json.dumps(info), flush=True)
    for k in ("flops", "dot_bytes"):
        if card[k] != dry[k] or not card[k]:
            fail(f"census: the card's {k} {card[k]} != the dry run's {dry[k]} on meta")
    if dry["unknown_trip_bodies"] or card["unknown_trip_bodies"]:
        fail(f"census: unknown trip counts {dry['unknown_trip_bodies']}")
    return info


def offline_phase(seed, dev, on_card, trained):
    """Phase 20: edge-list I/O, the analysis CLI standing alone, and the
    census of phase 18's step on the card against the dry run on meta."""
    io_info = io_check(IO_SCALE if on_card else 8, seed, dev, on_card)
    print("  " + json.dumps(io_info), flush=True)
    cli = cli_check()
    print("  " + json.dumps(dict(analyze=cli)), flush=True)
    return dict(io=io_info, analyze=cli, census=census_check(seed, dev, on_card, trained))


DRY_RUN_CELL = """\
import json, sys
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, train as lt
import dataclasses
a = json.loads(sys.argv[1])
cfg = ARCHS[a["arch"]] if a["full"] else ARCHS[a["arch"]].smoke()
cfg = dataclasses.replace(cfg, n_layers=a["layers"])
with dryrun.fake_world(a["world"]):
    mesh = lt.make_mesh(a["mesh"], device="meta")
    rec = dryrun.train_census(cfg, seq=a["seq"], global_batch=a["global_batch"],
                              microbatches=a["microbatches"], impl="ref", mesh=mesh)
print(json.dumps(rec))
"""


def dry_run_of(arch, full, layers, world, mesh, seq, global_batch, microbatches):
    """The dry run's census of a sharded train cell on a fake world of
    `world` ranks, in a process of its own (this one's default group is
    the real one): its record, rank 0's counts."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), CUDA_VISIBLE_DEVICES="")
    cell = dict(arch=arch, full=full, layers=layers, world=world, mesh=mesh, seq=seq,
                global_batch=global_batch, microbatches=microbatches)
    r = subprocess.run([sys.executable, "-c", DRY_RUN_CELL, json.dumps(cell)],
                       capture_output=True, text=True, env=env, timeout=600)
    if r.returncode:
        fail(f"the dry run of {cell} failed: {r.stderr[-1500:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def dist_only(args, on_card):
    """Phases 16, 17 and 19 alone (`--dist-only train`: phase 19 alone):
    every rank builds rmat(--scale) on its card (cuda:LOCAL_RANK under
    torchrun) and its cuda results, then runs the phases over all ranks in
    one process group."""
    import torch
    from repro_torch.graph import rmat
    t0 = time.perf_counter()
    dev = args.device
    graphs = args.dist_only == "all"
    if on_card:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        if int(os.environ.get("RANK", 0)) == 0:
            print(smi_line(on_card))
    if graphs:
        g = rmat(args.scale, edge_factor=16, seed=args.seed, device=dev)
        srcs = pick_sources(g, SET_SOURCES, args.seed)
        want = dist_baselines(g, srcs, on_card)
        phase("graph+cuda", t0, f"N={g.num_nodes} E={g.num_edges}")
    ranks = os.environ.get("WORLD_SIZE", 1)
    with process_group(on_card):
        if graphs:
            t0 = time.perf_counter()
            dist_infos = dist_phase(g, want, srcs, on_card, args.seed, 14 if on_card else 8,
                                    on_card and args.trace)
            phase("dist", t0, f"ranks {ranks}: backend='distributed' (dense, auto) == cuda; "
                  "distributed tc == scipy")
            t0 = time.perf_counter()
            grid_phase(g, want, srcs, on_card, args.seed, 16 if on_card else args.scale,
                       dist_infos)
            phase("grid", t0, f"ranks {ranks}: sssp_2d == cuda sssp, pagerank_2d == float64 "
                  "iteration, pod bc == cuda bc, distributed autotune agrees across ranks")
            del g, want
        t0 = time.perf_counter()
        train_dist_phase(args.seed, on_card)
        phase("train-dist", t0, f"ranks {ranks}: sharded qwen2.5-3b, resumed on other meshes "
              "== unbroken run; held bytes == the specs'")
    if int(os.environ.get("RANK", 0)) == 0:
        print("dist-only run finished: not a smoke run")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale (N = 2^scale)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: rehearse with the plain versions (not a smoke run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="profile one more call of each cuda run (phase 7)")
    ap.add_argument("--dist-only", nargs="?", const="all", choices=("all", "train"),
                    help="the graph, its cuda results and phases 16, 17 and 19 alone ('train': "
                         "phase 19 alone; under torchrun: one rank a card); not a smoke run")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"

    import torch
    if on_card and not torch.cuda.is_available():
        fail("no CUDA device is available (a --device cpu rehearsal is not a smoke run)")
    import_port()
    from repro_torch.core import get_context
    from repro_torch.graph import rmat
    from repro_torch.kernels import _build
    if args.dist_only:
        dist_only(args, on_card)
        return

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
    dist_ref = check_results(g, results, t0)
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

    # 11. delta; 12. serve; 13. update; 14. tune
    t0 = time.perf_counter()
    delta_infos = delta_phase(g, on_card, dist_ref)
    phase("delta", t0, "sssp under priority='delta' == default == Dijkstra; local == cuda; "
          "cc under delta == default")
    served = asyncio.run(serving_phase(g, args.seed, on_card, on_card and args.trace))
    t0 = time.perf_counter()
    tune_phase(16 if on_card else args.scale, args.seed, args.device)
    phase("tune", t0, "autotune -> TuningStore -> GraphService reloads the tuned schedule")

    # 16. dist; 17. grid
    want = {**results["cuda"], **set_results["cuda"]}
    with process_group(on_card):
        t0 = time.perf_counter()
        dist_infos = dist_phase(g, want, srcs, on_card, args.seed, 14 if on_card else 8,
                                on_card and args.trace)
        phase("dist", t0, "backend='distributed' at world size 1 (dense, auto) == cuda; "
              "distributed tc == scipy")
        t0 = time.perf_counter()
        grid_phase(g, want, srcs, on_card, args.seed, 16 if on_card else args.scale,
                   dist_infos)
        phase("grid", t0, "sssp_2d == cuda sssp, pagerank_2d == float64 iteration, pod bc "
              "== cuda bc, distributed autotune's winner == cuda")
    del want
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

    # 15. lm-families
    t0 = time.perf_counter()
    families = lm_families_phase(args.seed, dev, on_card, on_card and args.trace)
    phase("lm-families", t0, "; ".join(
        f"{f['model']} prefill {f['seq']} {f['prefill_s']:.3f} s, "
        f"{f['serve']['ms_per_decode_step']:.3f} ms per decode step" for f in families))

    # 18. train
    t0 = time.perf_counter()
    trained = train_phase(args.seed, dev, on_card, on_card and args.trace)
    phase("train", t0, f"{trained['model']} x{trained['layers']} layers: "
          f"{trained['step_s_mean_2_to_5']:.3f} s per step, "
          f"{trained['tokens_per_s']:.0f} tokens/s, 6NT at "
          f"{100 * trained['mfu_vs_bf16_peak']:.2f}% of the bf16 peak; resume == straight"
          + ("; card == cpu; flash refuses grad" if on_card else ""))

    # 20. offline
    t0 = time.perf_counter()
    offline = offline_phase(args.seed, dev, on_card, trained)
    c = offline["census"]
    phase("offline", t0, f"edge list == source graph; analyze CLI alone; census on the card "
          f"== dry run on meta ({c['card_flops']:.4e} FLOPs), step "
          f"{c['step_over_bound']:.2f}x its bound, 6NT / census {c['useful_fraction']:.4f}")

    if not on_card:
        print("rehearsal finished: plain versions on the CPU — not a smoke run")
        sys.exit(3)

    # the kernels of the path: the whole-view pull sweep of each semiring
    # (the rectangular per-bucket rows stay printed in phase 4), launches
    # from the main-path runs that use it and from the serving path's
    # (the delta runs, the lone queries, the refreshes)
    kernels = []
    for semiring, cname, progs in (("minplus", "minplus_i32", ("sssp", "sssp_pull")),
                                   ("plustimes", "plustimes_f32", ("pr", "ppr"))):
        sw = sweeps[semiring]
        mine = [r for r in shapes if r["semiring"] == semiring]
        kernels.append(dict(
            name=f"ell_spmv.{cname}", route="cuda", source=SOURCE, replaces=REPLACES,
            launches=sum(i["launches"] + i["sweep_launches"] for i in infos + set_infos
                         + delta_infos if i["backend"] == "cuda" and i["program"] in progs)
            + served[semiring],
            max_abs_err=max([sw["max_abs_err"]] + [r["max_abs_err"] for r in mine]),
            ms=sw["ms"], plain_ms=sw["plain_ms"], bound_ms=sw["bound_ms"],
            bound_by=sw["bound_by"], library_ms=sw["library_ms"],
            bound_l2_ms=sw["bound_l2_ms"]))
    flash["launches"] = lm["flash_launches"] + sum(
        f["flash_launches"] + f["serve"].get("flash_launches", 0) for f in families)
    kernels += [flash, tc]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
