"""Multi-tenant graph query serving on the PyTorch/CUDA port:
`repro_torch.serve.GraphService` end to end.

This example drives the port's async serving layer: a server answering
SSSP and BC queries for many concurrent users, across several registered
graphs, must never re-parse DSL source, re-generate code, or rebuild
per-graph views on the query path, and should *coalesce* concurrent
compatible queries into one batched [B, N]-lane sweep. Everything
expensive happens at registration:

  * `register_graph(name, g)` fingerprints the graph, warm-reloads any
    persisted `TuningStore` record (tuned schedule without a measurement
    sweep), compiles the bundled programs through the compile cache,
    prepares the graph's derived views, and memoizes `prog.bind(g)`;
  * `await service.query(graph, kind, src=...)` is admission-checked,
    coalesced with concurrent lane-mates (up to `Schedule.batch_sources`
    per sweep, waiting at most `max_wait_ms`), and answered from one
    batched sweep's per-source rows, as host numpy arrays; a query with
    no lane-mate runs the bound program itself.

With `--autotune`, the server tunes the schedule per (program, graph)
before registering (`repro_torch.autotune`); `--tune-store PATH` persists
the records so the next server start warm-reloads instead of
re-measuring. Every served answer is verified against the port's NumPy
oracles (`repro_torch.graph.algorithms_ref`).

    PYTHONPATH=src python examples/torch_query_server.py [--smoke] [--autotune]
    PYTHONPATH=src python examples/torch_query_server.py --smoke --backend local --device cpu
"""
import argparse
import asyncio
import time

import numpy as np

from repro_torch.autotune import TuningStore, autotune
from repro_torch.core import compile_bundled
from repro_torch.graph import preferential_attachment, resolve_device
from repro_torch.graph.algorithms_ref import bc_ref, sssp_ref
from repro_torch.schedule import Schedule
from repro_torch.serve import GraphService, ServiceConfig


async def serve(args, svc: GraphService, graphs: dict, first_sweep: str) -> dict:
    rng = np.random.default_rng(0)

    # ---- fire concurrent SSSP queries across users AND graphs -----------
    queries = []   # (graph name, src)
    for name, g in graphs.items():
        for s in rng.integers(0, g.num_nodes, args.queries):
            queries.append((name, int(s)))
    rng.shuffle(queries)

    t0 = time.perf_counter()
    results = await asyncio.gather(
        *(svc.query(name, "sssp", src=s) for name, s in queries))
    total = time.perf_counter() - t0
    st = svc.stats()
    print(f"SSSP: {len(queries)} concurrent queries over {len(graphs)} "
          f"graphs in {total:.2f} s ({len(queries) / total:.1f} q/s; "
          f"first sweep {first_sweep})")
    print(f"  coalescing: {st['sweeps']} sweeps, mean lane occupancy "
          f"{st['mean_batch']:.1f}, max {st['max_batch']}")

    # verify EVERY served answer against the reference oracle
    oracle, wrong = {}, []
    for (name, s), dist in zip(queries, results):
        key = (name, s)
        if key not in oracle:
            oracle[key] = sssp_ref(graphs[name], s).astype(np.int32)
        if not np.array_equal(np.asarray(dist), oracle[key]):
            wrong.append(key)
    if wrong:
        raise RuntimeError(f"{len(wrong)} of {len(queries)} SSSP answers differ "
                           f"from the numpy oracle, first {wrong[0]}")
    print(f"  verified: all {len(queries)} answers == numpy oracle")

    # ---- a lone query is one sweep of the bound program (on `cuda`, of the
    # ell_spmv kernel) once its lane-mate wait runs out
    name, s = queries[0]
    t0 = time.perf_counter()
    lone = np.asarray(await svc.query(name, "sssp", src=s))
    lone_ms = 1e3 * (time.perf_counter() - t0)
    print(f"SSSP: a lone query on {name!r} in {lone_ms:.1f} ms (one sweep of the "
          "bound program)")
    if not np.array_equal(lone, oracle[(name, s)]):
        raise RuntimeError(f"the lone SSSP answer {(name, s)} differs from the numpy oracle")
    print("  verified: lone answer == numpy oracle")

    # ---- a BC request serves its own source set through the [B, N] lanes
    name, g = next(iter(graphs.items()))
    srcs = rng.integers(0, g.num_nodes, args.batch).astype(np.int32)
    t0 = time.perf_counter()
    bc = np.asarray(await svc.query(name, "bc", sourceSet=srcs))
    bc_ms = 1e3 * (time.perf_counter() - t0)
    print(f"BC: {len(srcs)}-source aggregate on {name!r} in {bc_ms:.1f} ms "
          f"(top node {int(bc.argmax())})")
    np.testing.assert_allclose(bc, bc_ref(g, srcs.tolist()), atol=1e-3)
    print("  verified: BC == numpy oracle")
    return {"sssp_queries": len(queries), "sssp_seconds": total,
            "queries_per_s": len(queries) / total, "sweeps": st["sweeps"],
            "mean_batch": st["mean_batch"], "max_batch": st["max_batch"],
            "sssp_verified": True, "lone_ms": lone_ms, "lone_verified": True,
            "bc_ms": bc_ms, "bc_top_node": int(bc.argmax()),
            "bc_verified": True}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda", choices=["local", "cuda"])
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16,
                    help="Schedule.batch_sources — lanes per coalesced sweep")
    ap.add_argument("--queries", type=int, default=64,
                    help="concurrent SSSP queries per graph")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="coalescing deadline for a partial lane")
    ap.add_argument("--smoke", action="store_true", help="CI-sized run")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the schedule per (program, graph) at startup")
    ap.add_argument("--tune-budget", type=int, default=8,
                    help="candidate schedules measured per program")
    ap.add_argument("--tune-store", default=None, metavar="PATH",
                    help="persist tuning records; later starts warm-reload "
                         "instead of re-measuring")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.nodes, args.batch, args.queries = 600, 8, 16
        args.tune_budget = min(args.tune_budget, 4)

    sched = Schedule(batch_sources=args.batch)
    graphs = {
        "social": preferential_attachment(args.nodes, m=6, seed=3, device=args.device),
        "web": preferential_attachment(max(args.nodes // 2, 200), m=4, seed=11,
                                       device=args.device),
    }
    for name, g in graphs.items():
        print(f"graph {name!r}: {g.num_nodes} nodes, {g.num_edges} edges")
    print(f"backend={args.backend} device={dev} | batch_sources={sched.batch_sources} | "
          f"max_wait_ms={args.max_wait_ms}")

    store = TuningStore(args.tune_store) if args.tune_store else None
    tuned = []
    if args.autotune:
        # tune once per (program, graph); the service then WARM-RELOADS the
        # records at registration (keyed source digest + graph fingerprint),
        # so a restarted server never re-measures. NB: `store or ...` would
        # discard an EMPTY path-backed store (TuningStore has __len__)
        if store is None:
            store = TuningStore()
        t0 = time.perf_counter()
        for pname in ("sssp", "bc"):
            prog = compile_bundled(pname, backend=args.backend, schedule=sched)
            for gname, g in graphs.items():
                res = autotune(prog, g, budget=args.tune_budget, seed=0,
                               store=store)
                how = ("warm-reloaded" if res.from_store
                       else f"{len(res.record.trials)} trials")
                print(f"autotune[{pname}/{gname}]: {how}, best "
                      f"{res.speedup:.2f}x -> {res.schedule}")
                tuned.append(dict(program=pname, graph=gname, from_store=res.from_store,
                                  speedup=res.speedup))
        print(f"autotune total: {time.perf_counter() - t0:.1f} s")

    svc = GraphService(
        ServiceConfig(backend=args.backend, schedule=sched,
                      max_wait_ms=args.max_wait_ms),
        tune_store=store)
    t0 = time.perf_counter()
    for name, g in graphs.items():
        h = svc.register_graph(name, g)
        note = f" (tuned: {', '.join(h.tuned)})" if h.tuned else ""
        print(f"register_graph({name!r}): "
              f"{1e3 * (time.perf_counter() - t0):.0f} ms — compiled, "
              f"prepared, bound{note}")
        t0 = time.perf_counter()

    first_sweep = ("pays the kernels' build" if dev.type == "cuda" and args.backend == "cuda"
                   else "runs the plain torch ops")

    async def run():
        async with svc:
            return await serve(args, svc, graphs, first_sweep)

    out = asyncio.run(run())
    return {**out, "autotune": tuned}


if __name__ == "__main__":
    main()
