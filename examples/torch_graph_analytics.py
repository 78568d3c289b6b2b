"""End-to-end run of the paper's workload on the PyTorch/CUDA port: all
four algorithms on the (scaled) ten-graph Table-2 suite, `local` and `cuda`
backends, with oracle verification.

    PYTHONPATH=src python examples/torch_graph_analytics.py [--backend local|cuda]
    PYTHONPATH=src python examples/torch_graph_analytics.py --device cpu --graphs GR,RM

`cuda` (the default) relaxes SSSP and gathers PageRank through the
hand-written `ell_spmv` kernel; the first graph's calls also build it.
Each time is read after the answer reaches the host.
"""
import argparse
import time

import numpy as np

from repro_torch.core import compile_bundled
from repro_torch.graph import load_suite, resolve_device
from repro_torch.graph.algorithms_ref import sssp_ref

VERIFY_MAX_NODES = 4096   # the Bellman-Ford oracle is a Python loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda", choices=["local", "cuda"])
    ap.add_argument("--graphs", default="TW,PK,US,GR,RM,UR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    graphs = load_suite(args.graphs.split(","), device=args.device)
    progs = {n: compile_bundled(n, backend=args.backend)
             for n in ["sssp", "pr", "tc", "bc"]}
    srcs = np.array([0, 3, 11, 17], np.int32)

    print(f"backend={args.backend} device={dev}"
          + (" (the first graph's calls also build the kernels)"
             if dev.type == "cuda" and args.backend == "cuda" else ""))
    print(f"{'graph':6s} {'algo':5s} {'ms':>10s}  result")
    results = {}
    for gname, g in graphs.items():
        res = results[gname] = {}
        t0 = time.perf_counter()
        dist = progs["sssp"](g, src=0)["dist"].cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        ok = (np.array_equal(dist, sssp_ref(g, 0).astype(np.int32))
              if g.num_nodes <= VERIFY_MAX_NODES else None)
        reached = int((dist < 2**30).sum())
        print(f"{gname:6s} sssp  {ms:10.1f}  reached={reached} "
              f"verified={ok if ok is not None else f'unchecked (N > {VERIFY_MAX_NODES})'}")
        res["sssp"] = dict(ms=ms, reached=reached, verified=ok, dist=dist)

        t0 = time.perf_counter()
        pr = progs["pr"](g, beta=1e-4, delta=0.85, maxIter=100)["pageRank"].cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{gname:6s} pr    {ms:10.1f}  sum={pr.sum():.4f} max={pr.max():.5f}")
        res["pr"] = dict(ms=ms, sum=float(pr.sum()), max=float(pr.max()), pageRank=pr)

        t0 = time.perf_counter()
        tc = int(progs["tc"](g)["triangle_count"])
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{gname:6s} tc    {ms:10.1f}  triangles={tc}")
        res["tc"] = dict(ms=ms, triangles=tc)

        t0 = time.perf_counter()
        bc = progs["bc"](g, sourceSet=srcs)["BC"].cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{gname:6s} bc    {ms:10.1f}  top_node={int(bc.argmax())} bc_max={bc.max():.2f}")
        res["bc"] = dict(ms=ms, top_node=int(bc.argmax()), bc_max=float(bc.max()), BC=bc)
    return results


if __name__ == "__main__":
    main()
