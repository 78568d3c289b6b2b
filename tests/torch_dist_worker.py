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
import hashlib
import json
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


def _meshes(names):
    """make_mesh(shape, names) per shape, made on first use: every rank
    runs the same cases in the same order, so every rank creates the same
    sub-groups in the same order."""
    from repro_torch.core import dist
    made = {}

    def get(shape):
        if shape not in made:
            made[shape] = dist.make_mesh(shape, names, device="cpu")
        return made[shape]
    return get


def padded_tile(g, mesh):
    """This rank's 2-D tile with its whole padded edge row, as the
    reference's `shard_map` takes it (the library keeps only real edges)."""
    from repro_torch.core import dist2d
    host = dist2d.prepare_graph_2d(g, mesh.shape["data"], mesh.shape["model"])
    tile = dict(dist2d.shard_tile(host, mesh.rank, "cpu"))
    i, j = divmod(mesh.rank, mesh.shape["model"])
    for k in ("src_local", "dst_local", "weight", "valid"):
        row = torch.from_numpy(np.ascontiguousarray(host[k][i, j]))
        tile[k] = row.long() if k.endswith("_local") else row
    return tile


def run_grid(payload, mesh):
    """payload: {"graphs": {name: spec}, "cases": [(case_id, graph, (R, C),
    what, kwargs)]}. `what`: "sssp" / "pagerank" (`dist2d.sssp_2d` /
    `pagerank_2d`, with the superstep or sweep count), "sssp_padded" /
    "pagerank_padded" (the tile bodies on the padded tile), "layout" (the
    own ids gathered over "data", the global gather, the tile's edge
    count and whether all its edges are real)."""
    from repro_torch.core import dist2d
    from repro_torch.core import runtime_dist as rtd
    graphs = {k: build_graph(v) for k, v in payload["graphs"].items()}
    grid = _meshes(("data", "model"))
    out = {}
    for cid, gname, shape, what, kw in payload["cases"]:
        g, m = graphs[gname], grid(shape)
        if what == "sssp":
            out[cid] = (host(dist2d.sssp_2d(g, m, **kw)), dist2d.sssp_2d.supersteps)
        elif what == "pagerank":
            out[cid] = (host(dist2d.pagerank_2d(g, m, **kw)), dist2d.pagerank_2d.iterations)
        elif what == "sssp_padded":
            piece, steps = dist2d.sssp_tile(padded_tile(g, m), m, **kw)
            out[cid] = (host(dist2d.gather_global(piece, m)[: g.num_nodes]), steps)
        elif what == "pagerank_padded":
            piece, its = dist2d.pagerank_tile(padded_tile(g, m), m, **kw)
            out[cid] = (host(dist2d.gather_global(piece, m)[: g.num_nodes]), its)
        elif what == "layout":
            tile = dist2d.prepare(g, m)
            out[cid] = dict(
                gathered=host(rtd.gather(tile["own_ids"], m.axis("data"))),
                whole=host(dist2d.gather_global(tile["own_ids"], m)),
                edges=int(tile["valid"].shape[0]), all_real=bool(tile["valid"].all()),
                coords=(m.axis("data").rank, m.axis("model").rank))
    return out


def run_pods(payload, mesh):
    """payload: {"graphs": {...}, "cases": [(case_id, graph, (pods, data),
    sources)]}: `dist.run_pod_parallel` of bc, and each pod's slice run
    alone on the "data" axis (every rank runs every slice), returning its
    `_gather_elems`; a source set that does not divide the pods returns
    the ValueError's message."""
    from repro_torch.core import compile_bundled, dist
    graphs = {k: build_graph(v) for k, v in payload["graphs"].items()}
    pods = _meshes(("pod", "data"))
    prog = compile_bundled("bc", backend="distributed")
    out = {}
    for cid, gname, shape, srcs in payload["cases"]:
        g, m = graphs[gname], pods(shape)
        if len(srcs) % shape[0]:
            try:
                dist.run_pod_parallel(prog, g, m, srcs)
            except ValueError as e:
                out[cid] = str(e)
            continue
        res = {k: host(v) for k, v in dist.run_pod_parallel(prog, g, m, srcs).items()}
        k = len(srcs) // shape[0]
        alone = prog.bind(g, mesh=m.axis("data"))
        res["per_pod_elems"] = [float(alone(sourceSet=srcs[p * k:(p + 1) * k])["_gather_elems"])
                                for p in range(shape[0])]
        out[cid] = res
    return out


def digest_cost(sched: dict, rank: int) -> float:
    """A deterministic measure that differs from rank to rank: one byte of
    a digest of the schedule's dict, picked by the rank (`hash()` of a
    string differs between spawned processes, a digest does not)."""
    h = hashlib.sha256(json.dumps(sched, sort_keys=True).encode()).digest()
    return 1.0 + h[rank] / 256.0


def run_tune(payload, mesh):
    """payload: {"graph": spec, "store": path, "budget": n}: distributed
    sssp tuned twice into one store under `digest_cost` (the second call
    must be a store hit), counting this rank's store writes; then the
    winner's sssp from 0."""
    from repro_torch.autotune import TuningStore, autotune, schedule_to_dict
    from repro_torch.core import compile_bundled
    g = build_graph(payload["graph"])
    saves = []
    save = TuningStore.save

    def counted(self, **kw):
        saves.append(1)
        return save(self, **kw)

    def measure(bound, params):
        return digest_cost(schedule_to_dict(bound.program.schedule), mesh.rank)
    prog = compile_bundled("sssp", backend="distributed")
    TuningStore.save = counted
    try:
        first = autotune(prog, g, budget=payload["budget"], seed=0, measure=measure,
                         store=payload["store"], mesh=mesh)
        again = autotune(prog, g, budget=payload["budget"], seed=0, measure=measure,
                         store=payload["store"], mesh=mesh)
    finally:
        TuningStore.save = save
    return dict(record=first.record.to_dict(), schedule=schedule_to_dict(first.schedule),
                from_store=(first.from_store, again.from_store),
                again=schedule_to_dict(again.schedule), saves=len(saves),
                dist=host(first.program.bind(g, mesh=mesh)(src=0)["dist"]))


def run_train(payload, mesh):
    """payload: [(case_id, args, kwargs)] of `launch.train.run(*args,
    device="cpu", **kwargs)`, in order. Each case returns its final loss,
    its per-step history (loss, held bytes, ...) and what it printed."""
    import contextlib
    import io
    from repro_torch.launch.train import run
    out = {}
    for cid, args, kw in payload:
        history, printed = [], io.StringIO()
        with contextlib.redirect_stdout(printed):
            loss = run(*args, device="cpu", history=history, **kw)
        out[cid] = {"loss": loss, "history": history, "stdout": printed.getvalue()}
    return out


def reduce_case_grad(shape, names, batch_axes, leaf, i, coords):
    """The gradient a rank at `coords` holds of leaf `i` before reduction:
    drawn from its coordinates along the batch axes only, since ranks
    that differ in another axis ran the same rows. A leaf named "*bf16"
    comes in bfloat16."""
    key = [int(c) for c, n in zip(coords, names) if n in batch_axes]
    g = torch.from_numpy(np.random.default_rng([i, *key]).standard_normal(shape)
                         .astype(np.float32))
    return g.bfloat16() if leaf.endswith("bf16") else g


def run_reduce(payload, mesh):
    """payload: [(case_id, mesh shape, axis names, batch axes, {leaf:
    (spec entries, shape)})]. Each case returns this rank's blocks from
    `Layout.reduce_grads` and the norm `Layout.global_norm` takes of them."""
    from repro_torch.core import dist
    from repro_torch.launch import sharding as sh
    out = {}
    for cid, shape, names, baxes, leaves in payload:
        m = dist.make_mesh(shape, names, device="cpu")
        coords = np.unravel_index(m.rank, shape)
        lay = sh.named(m, {n: sh.P(*spec) for n, (spec, _) in leaves.items()}, baxes)
        grads = {n: reduce_case_grad(s, names, baxes, n, i, coords)
                 for i, (n, (_, s)) in enumerate(leaves.items())}
        blocks = lay.reduce_grads(grads)
        out[cid] = {"blocks": {n: host(b) for n, b in blocks.items()},
                    "norm": float(lay.global_norm(blocks)), "left": len(grads),
                    "coords": [int(c) for c in coords]}
    return out


def run_moments(payload, mesh):
    """payload: [(case_id, arch, layers, mesh A, [mesh B, ...], steps,
    resume_at)]. Trains the arch's smoke config cut to `layers` layers
    (the sharded path of `launch.train`, its data and schedule): `steps`
    unbroken on A, and `resume_at` on A with a checkpoint; then on each B
    `steps` unbroken, resumed from the checkpoint, and resumed with m and
    v zeroed after the restore. Rank 0 returns, for each B, each run's
    losses and its largest per-leaf distance |x - u| / |u| of m and v at
    the last step from the unbroken A run's (gathered)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as lt
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import init_state, make_train_step
    out = {}
    for cid, arch, layers, spec_a, specs_b, steps, cut in payload:
        cfg = dataclasses.replace(ARCHS[arch].smoke(), n_layers=layers)
        oc, dc = lt.optimizer_config(cfg, steps, 1e-3), lt.data_config(cfg, 64, 8)
        d = [tempfile.mkdtemp(prefix="moments-") if mesh.rank == 0 else None]
        torch.distributed.broadcast_object_list(d, src=0)

        def train(spec, start, restore=False, drop=False, save=False):
            m = lt.make_mesh(spec, device="cpu")
            model = build(cfg, device="cpu", seed=0)
            state = lt.shard(init_state(model), m, 8)
            if restore:
                state = ckpt.restore(d[0], cut, state, shardings=state.layout)
            if drop:
                for g in ("m", "v"):
                    for t in state.opt[g].values():
                        t.zero_()
            step = make_train_step(model, oc, microbatches=2)
            losses = []
            for i in range(start, cut if save else steps):
                state, met = step(state, lt.batch_for(cfg, dc, i, "cpu",
                                                      state.layout.rows(8)))
                losses.append(float(met["loss"]))
            if save:
                ckpt.save(d[0], cut, state)
            whole = {g: {n: state.layout.gather(n, t) for n, t in state.opt[g].items()}
                     for g in ("m", "v")}
            return losses, whole

        ref_losses, ref = train(spec_a, 0)
        train(spec_a, 0, save=True)
        res = {"unbroken-a": ref_losses}
        for spec in specs_b:
            runs = {"unbroken": train(spec, 0), "resumed": train(spec, cut, restore=True),
                    "dropped": train(spec, cut, restore=True, drop=True)}
            res[spec] = {name: {"losses": losses, "apart": max(
                float((whole[g][n] - u).norm() / u.norm())
                for g in ("m", "v") for n, u in ref[g].items())}
                for name, (losses, whole) in runs.items()}
        out[cid] = res if mesh.rank == 0 else None
    return out


def run_cases(payload: dict, mesh) -> dict:
    """Each section of the payload ("programs", "exchanges", "gathers",
    "grid", "pods", "tune", "train", "reduce", "moments"), in that order on
    every rank."""
    jobs = {"programs": run_programs, "exchanges": run_exchanges, "gathers": run_gathers,
            "grid": run_grid, "pods": run_pods, "tune": run_tune, "train": run_train,
            "reduce": run_reduce, "moments": run_moments}
    return {k: jobs[k](payload[k], mesh) for k in jobs if k in payload}
