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
               -Xptxas -v report;
  3. graph   — rmat(scale, edge_factor=16, seed=0) on the card (scale 22:
               4,194,304 vertices, 67,108,864 sampled edges before dedup,
               the size of the paper's soc-LiveJournal1) and its reverse
               sliced-ELL view;
  4. kernels — `ell_spmv` against its plain version `ell_spmv_ref` on every
               bucket shape of that view, for both semirings, in the SpMV
               form and the SpMM form (B = 32), plus random shapes: int32
               results equal, f32 at rtol 1e-5 (sums run in another order).
               Times with CUDA events (warm-up, then the mean of 20
               launches) beside the memory bound and, for plus-times,
               torch.sparse.mm on the same entries;
  5. main    — compile_bundled(name, backend="cuda").bind(g)(...) for sssp,
               sssp pinned to pull, sssp_pull and pr; the second call is
               timed (host clock ending in synchronize()), with the kernel's
               launch count reset just before it and read just after;
  6. check   — every result against the port's `local` backend on the same
               card (dist equal, pageRank at rtol 1e-4 and atol 1e-9: ranks
               are about 1/N), dist against scipy's Dijkstra and pageRank
               against a float64 power iteration of the same length (rtol
               1e-4);
  7. trace   — with --trace only: one more call of each `cuda` run under
               torch.profiler, printing the device time by kernel, the
               device-busy share of the traced call (kernel time over wall
               time; one stream, so kernels do not overlap) and the traced
               call's wall time beside the untraced one (the tracing cost).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the run fails; a
`--device cpu` rehearsal runs phases 3, 5 and 6 with the plain versions,
prints no result line and exits 3: it is not a smoke run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu"
REPLACES = "src/repro/kernels/ell_spmv/kernel.py:76"
TIMED_LAUNCHES = 20


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

def cuda_ms(fn, n=TIMED_LAUNCHES):
    import torch
    for _ in range(3):
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


# --------------------------------------------------------------------------
# main path + oracles
# --------------------------------------------------------------------------

RUNS = (("sssp", "auto", dict(src=0)),
        ("sssp", "pull", dict(src=0)),
        ("sssp_pull", "auto", dict(src=0)),
        ("pr", "auto", dict(beta=1e-4, delta=0.85, maxIter=100)))


def drive(g, backend, name, direction, params, on_card):
    """Compile, bind, call once to warm, then the timed call with the
    launch and step counters set to 0 just before it and read just after."""
    import torch
    from repro_torch.core import Schedule, compile_bundled
    from repro_torch.kernels.ell_spmv import ops
    from repro_torch.kernels.ell_spmv.kernel import ell_spmv
    bound = compile_bundled(name, backend=backend,
                            schedule=Schedule(direction=direction)).bind(g)
    bound(**params)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ell_spmv.launches = 0
    ops.relax_minplus.push_steps = ops.relax_minplus.pull_steps = 0
    t = time.perf_counter()
    out = bound(**params)
    sync()
    secs = time.perf_counter() - t
    info = dict(program=name, backend=backend, direction=direction, seconds=secs,
                launches=ell_spmv.launches,
                push_steps=ops.relax_minplus.push_steps,
                pull_steps=ops.relax_minplus.pull_steps,
                peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
    if name == "pr":
        info["iterations"] = int(out["iterCount"])
    else:
        info["iterations"] = info["push_steps"] + info["pull_steps"] if backend == "cuda" \
            else None
    return bound, out, info


def trace_run(bound, params, top=12):
    """One more call under torch.profiler: device time by kernel and the
    device-busy share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bound(**params)
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
                top=[dict(kernel=k[:90], ms=d / 1e3, calls=c) for d, k, c in rows[:top]])


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
        local = results["local"][(name, direction)]
        for key, want in local.items():
            got = out[key]
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
                fail(f"{name}/{direction}.{key}: {got.shape} {got.dtype} vs local "
                     f"{want.shape} {want.dtype}")
            if got.dtype.is_floating_point:
                if not bool(torch.isfinite(got).all()):
                    fail(f"{name}.{key}: non-finite values")
                # `diff` is an L1 sum of tiny differences: its own rounding
                # is not compared, only the ranks and the iteration count
                if key.startswith("pageRank"):
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-9)
            elif not torch.equal(got, want):
                fail(f"{name}/{direction}.{key}: cuda != local")
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
        for name, log in _build.build_all().items():
            print(f"  nvcc {name}: " + "\n  ".join(log.strip().splitlines()))
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
        phase("kernels", t0, f"{len(shapes)} shapes: kernel == plain version")

    # 5. main path (cuda backend) and the local backend beside it
    t0 = time.perf_counter()
    results, infos, bounds = {"cuda": {}, "local": {}}, [], {}
    for name, direction, params in RUNS:
        bound, out, info = drive(g, "cuda", name, direction, params, on_card)
        bounds[(name, direction)] = bound
        if on_card and info["launches"] == 0:
            fail(f"{name}/{direction}: the main path launched no ell_spmv kernel")
        results["cuda"][(name, direction)] = out
        infos.append(info)
        print("  " + json.dumps(info))
    for name, direction, params in RUNS:
        _, out, info = drive(g, "local", name, direction, params, on_card)
        results["local"][(name, direction)] = out
        infos.append(info)
        print("  " + json.dumps(info))
    phase("main", t0, "compile_bundled(..., backend='cuda').bind(g)(...)")

    # 6. check
    t0 = time.perf_counter()
    check_results(g, results, t0)

    if not on_card:
        print("rehearsal finished: plain versions on the CPU — not a smoke run")
        sys.exit(3)

    # 7. trace (optional)
    if args.trace:
        t0 = time.perf_counter()
        for (name, direction, params), info in zip(RUNS, infos):   # the cuda runs
            tr = trace_run(bounds[(name, direction)], params)
            print("  " + json.dumps(dict(program=name, direction=direction,
                                         untraced_ms=info["seconds"] * 1e3, **tr)))
        phase("trace", t0, "torch.profiler, one call per cuda run")

    # the kernels of the path: one full pull sweep of the SpMV form over the
    # reverse view's buckets (the sum of the per-bucket rows), launches from
    # the main-path runs that use each semiring
    kernels = []
    for semiring, cname, progs in (("minplus", "minplus_i32", ("sssp", "sssp_pull")),
                                   ("plustimes", "plustimes_f32", ("pr",))):
        sweep = [r for r in shapes if r["semiring"] == semiring
                 and r["name"].startswith("bucket") and r["B"] == 1]
        mine = [r for r in shapes if r["semiring"] == semiring]
        lib = [r["library_ms"] for r in sweep]
        kernels.append(dict(
            name=f"ell_spmv.{cname}", route="cuda", source=SOURCE, replaces=REPLACES,
            launches=sum(i["launches"] for i in infos
                         if i["backend"] == "cuda" and i["program"] in progs),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in sweep), plain_ms=sum(r["plain_ms"] for r in sweep),
            bound_ms=sum(r["bound_ms"] for r in sweep),
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in sweep)
                      else "operations"),
            library_ms=sum(lib) if None not in lib else None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
