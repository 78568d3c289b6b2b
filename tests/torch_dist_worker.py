"""Ranks of the port's distributed tests: `spawn_world` starts one process
per shard (the `spawn` start method), each on the CPU with gloo over a
`FileStore`; every rank runs every case of the payload and hands its
results back as a pickle.

This module runs inside the ranks, so it imports torch and `repro_torch`
only: no jax and nothing of the reference package. A rank that raises
writes its traceback and exits non-zero; the parent then kills the others
(which may be waiting in a collective) and fails. A world that outlives
its timeout is killed and fails the same way, so a deadlock costs one
test its timeout, never the suite its time.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

WORLD_TIMEOUT_S = 120


def spawn_world(world: int, payload: dict, workdir, timeout: float = WORLD_TIMEOUT_S):
    """Run `run_cases(payload, mesh)` on `world` gloo ranks; returns the
    ranks' results in rank order. Fails with the first rank's traceback,
    or when the world is still running after `timeout` seconds."""
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix=f"world{world}-", dir=workdir)   # a fresh store
    store = os.path.join(workdir, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, workdir, payload),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(p.is_alive() for p in procs) \
            and not any(p.exitcode not in (None, 0) for p in procs):
        time.sleep(0.02)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = [open(os.path.join(workdir, f"rank{r}.err")).read() for r in range(world)
              if os.path.exists(os.path.join(workdir, f"rank{r}.err"))]
    if errors:
        raise AssertionError(f"{world} ranks: a rank failed:\n{errors[0]}")
    if hung:
        raise AssertionError(f"{world} ranks: ranks {hung} still running after "
                             f"{timeout} s (killed)")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"{world} ranks: exit codes {bad}")
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(rank, world, store, workdir, payload):
    import torch.distributed as tdist
    torch.set_num_threads(1)
    try:
        tdist.init_process_group("gloo", store=tdist.FileStore(store, world), rank=rank,
                                 world_size=world,
                                 timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            from repro_torch.core import dist
            out = run_cases(payload, dist.make_mesh_1d(world, device="cpu"))
        finally:
            tdist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def host(x):
    """A result value as numpy (tensors) or as it is (Python scalars)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def build_graph(spec: dict):
    from repro_torch.graph import from_arrays
    return from_arrays(spec["arrays"], num_nodes=spec["num_nodes"],
                       num_edges=spec["num_edges"],
                       max_out_degree=spec["max_out_degree"],
                       max_in_degree=spec["max_in_degree"], device="cpu")


def run_programs(payload, mesh):
    """payload: {"graphs": {name: spec}, "cases": [(case_id, graph, program,
    Schedule kwargs, params)]}. Every rank runs every case in order."""
    from repro_torch.core import Schedule, compile_bundled
    graphs = {k: build_graph(v) for k, v in payload["graphs"].items()}
    out = {}
    for cid, gname, prog, sched, params in payload["cases"]:
        bound = compile_bundled(prog, backend="distributed",
                                schedule=Schedule(**sched)).bind(graphs[gname], mesh=mesh)
        out[cid] = {k: host(v) for k, v in bound(**params).items()}
    return out


def run_exchanges(payload, mesh):
    """payload: [(case_id, kind, args)]: `exchange` or `exchange_rows` on
    this rank's row of the stacked blocks, returning the full view and the
    element count."""
    from repro_torch.core import runtime_dist as rtd
    out = {}
    for cid, kind, a in payload:
        t = {k: torch.from_numpy(np.ascontiguousarray(v[mesh.rank] if k in a["per_rank"]
                                                      else v))
             for k, v in a["arrays"].items()}
        fn = rtd.exchange_rows if kind == "exchange_rows" else rtd.exchange
        full, elems = fn(t["full"], t["blk"], t["own"], a["frac"], mesh=mesh,
                         skip_empty=a["skip"],
                         **({"within": t["within"]} if "within" in t else {}))
        out[cid] = (host(full), elems)
    return out


def run_gathers(payload, mesh):
    """`gather_rows` of this rank's [S, B] block, and `gather` of a bool
    block (which travels as bytes)."""
    from repro_torch.core import runtime_dist as rtd
    s, b = payload
    r = mesh.rank
    blk = (torch.arange(s * b, dtype=torch.int32).reshape(s, b) * 100 + r)
    return (host(rtd.gather_rows(blk, mesh)),
            host(rtd.gather(torch.arange(b) % (r + 2) == 0, mesh)))


def run_cases(payload: dict, mesh) -> dict:
    """Each section of the payload ("programs", "exchanges", "gathers"),
    in that order on every rank."""
    jobs = {"programs": run_programs, "exchanges": run_exchanges, "gathers": run_gathers}
    return {k: jobs[k](payload[k], mesh) for k in jobs if k in payload}
