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
import types

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
    from repro_torch.train import make_train_step
    out = {}
    for cid, arch, layers, spec_a, specs_b, steps, cut in payload:
        cfg = dataclasses.replace(ARCHS[arch].smoke(), n_layers=layers)
        oc, dc = lt.optimizer_config(cfg, steps, 1e-3), lt.data_config(cfg, 64, 8)
        d = [tempfile.mkdtemp(prefix="moments-") if mesh.rank == 0 else None]
        torch.distributed.broadcast_object_list(d, src=0)

        def train(spec, start, restore=False, drop=False, save=False):
            m = lt.make_mesh(spec, device="cpu")
            model = build(cfg, device="cpu", seed=0)
            state = lt.init_sharded(model, m, 8)
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


def split_case_arrays(seed, shapes):
    """The f32 arrays of a collectives case, drawn from `seed` (the same on
    every rank and in the parent)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


SPLIT_CASE_SHAPES = {"x": (4, 3, 8), "w_gate": (8, 12), "w_up": (8, 12), "w_down": (12, 8),
                     "cot": (4, 3, 8), "table": (16, 8), "logits": (2, 3, 16)}


def run_split_functions(payload, mesh):
    """payload: [(case_id, seed)]. The world is one "model" axis for the
    split MLP (column-split w_gate and w_up, row-split w_down, `copy_to`
    and `reduce_from`), the vocab embedding and `vocab_cross_entropy`, and
    one "data" axis for `gather_over` (this rank's rows of x against the
    gathered rows of w_gate; summed, and unsummed on the same rows) and
    `gather_many` (w_gate's rows and w_down's columns in one gather).
    Each case returns this rank's outputs and gradients."""
    import torch.nn.functional as F
    from repro_torch.core import dist
    from repro_torch.launch import parallel as par
    out = {}
    for cid, seed in payload:
        a = {k: torch.from_numpy(v) for k, v in split_case_arrays(seed, SPLIT_CASE_SHAPES).items()}
        model = dist.make_mesh((1, mesh.size), ("data", "model"), device="cpu").axis("model")
        data = dist.make_mesh((mesh.size, 1), ("data", "model"), device="cpu").axis("data")
        res = {}

        def block(t, dim, ax):
            return par.block_of(t, dim, ax).clone().requires_grad_()

        x = a["x"].clone().requires_grad_()
        wg, wu, wd = block(a["w_gate"], 1, model), block(a["w_up"], 1, model), \
            block(a["w_down"], 0, model)
        xi = par.copy_to(x, model)
        y = par.reduce_from((F.silu(xi @ wg) * (xi @ wu)) @ wd, model)
        (y * a["cot"]).sum().backward()
        res["mlp"] = {k: host(v) for k, v in dict(y=y.detach(), x=x.grad, w_gate=wg.grad,
                                                   w_up=wu.grad, w_down=wd.grad).items()}

        table = block(a["table"], 0, model)
        tokens = torch.arange(12).reshape(4, 3) * 5 % 16
        e = par.vocab_embed(table, tokens, table.shape[0] * model.rank, model)
        (e * a["cot"]).sum().backward()
        res["embed"] = {"y": host(e.detach()), "table": host(table.grad)}

        logits = block(a["logits"], 2, model)
        labels = torch.arange(6).reshape(2, 3) * 3 % 16
        ce = par.vocab_cross_entropy(logits, labels, logits.shape[2] * model.rank, model)
        ce.backward()
        res["ce"] = {"loss": float(ce), "logits": host(logits.grad)}

        for summed in (True, False):
            w = block(a["w_gate"], 0, data)
            rows = par.block_of(a["x"], 0, data) if summed else a["x"]
            g = par.gather_over(w, data, 0, summed=summed)
            ((rows @ g) ** 2).sum().backward()
            res[f"gather_summed={summed}"] = {"w": host(g.detach()), "grad": host(w.grad)}
            w1, w2 = block(a["w_gate"], 0, data), block(a["w_down"], 1, data)
            g1, g2 = par.gather_many([w1, w2], data, [0, 1], summed=summed)
            (((rows @ g1) @ g2) ** 2).sum().backward()
            res[f"gather_many_summed={summed}"] = {
                "w1": host(g1.detach()), "w2": host(g2.detach()),
                "grad1": host(w1.grad), "grad2": host(w2.grad)}
        out[cid] = res
    return out


def run_split_steps(payload, mesh):
    """payload: [(case_id, arch, reference arrays, mesh spec, steps,
    microbatches, seq, global batch, plan)]. The arch's smoke config at 2
    layers in f32, holding the reference's weights (`from_reference`),
    placed on the mesh (plan None: the family's, the split plan;
    "gathered": the whole parameters gathered each step) and trained
    `steps` steps on its rows of the global batches of `launch.train`'s
    data; on the split plan first its split prefill's last-token logits
    (`impl="chunked"`) of step 0's tokens. Each rank returns the losses,
    grad norms and its held bytes, the plan's name, the logits and its
    plan's own-block choices (split plan), and (rank 0) every parameter
    gathered."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import effective_batch_axes
    from repro_torch.models.weights import from_reference
    from repro_torch.train import OptimizerConfig, init_state, make_train_step
    out = {}
    for cid, arch, arrays, spec, steps, mb, seq, gb, forced in payload:
        cfg = dataclasses.replace(ARCHS[arch].smoke(), n_layers=2, dtype="float32")
        m = lt.make_mesh(spec, device="cpu")
        model = from_reference(arrays, cfg, device="cpu")
        state = init_state(model)
        lay = sh.named(m, sh.param_specs(state.params, dict(m.shape)),
                       effective_batch_axes(m, gb))
        lay._plan = forced
        state = sh.place(state, lay)
        plan = model.net.plan
        dc = lt.data_config(cfg, seq, gb)
        rows = lay.rows(gb)
        prefill = None
        if plan is not None:
            with torch.no_grad():
                prefill, _ = model(lt.batch_for(cfg, dc, 0, "cpu", rows), impl="chunked",
                                   last_only=True)
        step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                               microbatches=mb)
        hist = []
        for i in range(steps):
            state, met = step(state, lt.batch_for(cfg, dc, i, "cpu", rows))
            hist.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                             lr=float(met["lr"]), held_bytes=sh.held_bytes(state)))
        whole = {n: host(lay.gather(n, p.detach())) for n, p in state.params.items()}
        choices = None if plan is None else dict(
            heads=plan.heads, ff=plan.ff, vocab=plan.vocab, own_q=plan.own_q,
            own_kv=plan.own_kv, q=plan.q, kv=plan.kv)
        out[cid] = dict(history=hist, prefill=None if prefill is None else host(prefill),
                        rows=[rows.start, rows.stop], ran=lay.plan_for(cfg), plan=choices,
                        params=whole if mesh.rank == 0 else None)
    return out


def run_split_decode(payload, mesh):
    """payload: [(case_id, arch, config overrides, reference arrays, mesh
    spec, tokens [B, T], max_len, new_tokens)]. The arch's smoke config at
    2 layers in f32 (with the overrides), holding the reference's weights
    (`from_reference`), placed on the mesh (the split plan) with
    `Layout.gather_params` made to raise, so no step gathers the
    parameters whole. new_tokens None: `decode_step` of each of the T
    tokens of the rank's rows from the plan's `init_cache(rows, max_len)`;
    each rank returns its logits a step [T, rows, V], its cache blocks
    (k, v a layer), their length and bytes, its slots and rows, the plan's
    name and the layout's batch axes. Else `ServeEngine(max_len=max_len)
    .generate` of the rank's rows of the prompts `tokens` and
    `new_tokens` more; each rank returns its tokens and rows."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import effective_batch_axes
    from repro_torch.models.weights import from_reference
    from repro_torch.serve import ServeEngine

    def refuse(self, params):
        raise AssertionError("a split decode gathered the parameters whole")
    out = {}
    for cid, arch, overrides, arrays, spec, tokens, max_len, new_tokens in payload:
        cfg = dataclasses.replace(ARCHS[arch].smoke(), n_layers=2, dtype="float32",
                                  **overrides)
        m = lt.make_mesh(spec, device="cpu")
        model = from_reference(arrays, cfg, device="cpu")
        gb = tokens.shape[0]
        lay = sh.named(m, sh.param_specs(dict(model.net.named_parameters()), dict(m.shape)),
                       effective_batch_axes(m, gb))
        lay.gather_params = types.MethodType(refuse, lay)
        ran = sh.place_model(model, lay)
        rows = lay.rows(gb)
        res = dict(ran=ran, rows=[rows.start, rows.stop], batch_axes=lay.batch_axes)
        with torch.inference_mode():
            if new_tokens is not None:
                got = ServeEngine(model, max_len=max_len, batch_size=rows.stop - rows.start) \
                    .generate(tokens[rows], new_tokens)
                out[cid] = dict(res, tokens=got.tokens)
                continue
            toks = torch.from_numpy(tokens[rows]).long()
            cache = model.init_cache(rows.stop - rows.start, max_len)
            logits = []
            for i in range(toks.shape[1]):
                lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
                logits.append(host(lg))
        kv = cache["kv"]
        out[cid] = dict(res, logits=np.stack(logits), slots=model.net.plan.cache_slots(max_len),
                        cache=[(host(lc["k"]), host(lc["v"])) for lc in kv],
                        length={lc["length"] for lc in kv},
                        cache_bytes=sum(lc[n].numel() * lc[n].element_size()
                                        for lc in kv for n in ("k", "v")))
    return out


def _model_collectives(group):
    """A counter of the collectives over `group` made while `counting[0]`
    is set: (counting, counts), with torch.distributed's all-reduce and
    `launch.parallel`'s all-gather and reduce-scatter wrapped until
    `restore()`."""
    import torch.distributed as tdist
    from repro_torch.launch import parallel as par
    counting, counts = [False], []
    saved = (tdist.all_reduce, par._ALL_GATHER, par._REDUCE_SCATTER)

    def counted(fn):
        def call(*a, **kw):
            if counting[0] and kw.get("group") is group:
                counts.append(fn.__name__)
            return fn(*a, **kw)
        return call
    tdist.all_reduce, par._ALL_GATHER, par._REDUCE_SCATTER = map(counted, saved)

    def restore():
        tdist.all_reduce, par._ALL_GATHER, par._REDUCE_SCATTER = saved
    return counting, counts, restore


def run_split_moe(payload, mesh):
    """payload: [dict(id, kind, arch, overrides, arrays, spec, steps,
    microbatches, seq, global_batch)]. The arch's smoke config at 2 layers
    in f32 (with the overrides), holding the reference's weights
    (`from_reference`), placed on the mesh by the specs (the family's
    plan) with `Layout.gather_params` made to raise. kind "steps": the
    split prefill's last-token logits of step 0's rows (`impl="chunked"`),
    counting the collectives over "model" made inside the MoE layers, then
    `steps` train steps of `launch.train`'s data; returns the losses, grad
    norms and held bytes, the plan's choices, the rank's blocks of the
    leaves "model" does not split (with its "data" coordinate) and (rank
    0) every parameter gathered. kind "layer": the same prefill, returning
    each MoE layer's input and output and its routing (`_dispatch`: the
    expert and slot of each assignment, the [E, C] dispatch)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import effective_batch_axes
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.weights import from_reference
    from repro_torch.train import OptimizerConfig, init_state, make_train_step

    def refuse(self, params):
        raise AssertionError("a split MoE step gathered the parameters whole")
    out = {}
    for c in payload:
        cfg = dataclasses.replace(ARCHS[c["arch"]].smoke(), n_layers=2, dtype="float32",
                                  **c["overrides"])
        m = lt.make_mesh(c["spec"], device="cpu")
        model = from_reference(c["arrays"], cfg, device="cpu")
        state = init_state(model)
        gb = c["global_batch"]
        lay = sh.named(m, sh.param_specs(state.params, dict(m.shape)),
                       effective_batch_axes(m, gb))
        lay.gather_params = types.MethodType(refuse, lay)
        state = sh.place(state, lay)
        plan = model.net.plan
        dc = lt.data_config(cfg, c["seq"], gb)
        rows = lay.rows(gb)
        res = dict(ran=lay.plan_for(cfg), rows=[rows.start, rows.stop],
                   plan=dict(heads=plan.heads, experts=plan.experts, shared=plan.shared,
                             e=plan.e, sf=plan.sf, q=plan.q))
        layers, dispatch = [], []
        hooks = [mod.register_forward_hook(
            lambda mod, args, o: layers.append((host(args[0]), host(o[0]))))
            for mod in model.net.modules() if isinstance(mod, moe_mod.MoE)]
        split_dispatch = moe_mod._dispatch

        def recorded(*a):
            got = split_dispatch(*a)
            dispatch.append(tuple(host(x) for x in got))
            return got
        moe_mod._dispatch = recorded
        counting, counts, restore = _model_collectives(plan.model.group)
        orig_forward = moe_mod.MoE.forward

        def counted_forward(self, *a, **kw):
            counting[0] = True
            try:
                return orig_forward(self, *a, **kw)
            finally:
                counting[0] = False
        moe_mod.MoE.forward = counted_forward
        try:
            with torch.no_grad():
                prefill, _ = model(lt.batch_for(cfg, dc, 0, "cpu", rows), impl="chunked",
                                   last_only=True)
        finally:
            moe_mod.MoE.forward = orig_forward
            moe_mod._dispatch = split_dispatch
            restore()
            for h in hooks:
                h.remove()
        res.update(prefill=host(prefill), moe_model_collectives=len(counts))
        if c["kind"] == "layer":
            out[c["id"]] = dict(res, layers=layers, dispatch=dispatch)
            continue
        step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                               microbatches=c["microbatches"])
        hist = []
        for i in range(c["steps"]):
            state, met = step(state, lt.batch_for(cfg, dc, i, "cpu", rows))
            hist.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                             lr=float(met["lr"]), held_bytes=sh.held_bytes(state)))
        unsplit = {n: host(p.detach()) for n, p in state.params.items()
                   if not any("model" in sh._axes(e) for _, e in lay._split(n))}
        whole = {n: host(lay.gather(n, p.detach())) for n, p in state.params.items()}
        out[c["id"]] = dict(res, history=hist, data_rank=lay.axis("data").rank,
                            not_model_split=unsplit,
                            params=whole if mesh.rank == 0 else None)
    return out


def _mutant_norms(kind):
    """A `SplitPlan._split_norm` with a fault of `kind`, to show that the
    tests see it: "scale_raw" applies the scale's slice without
    `copy_to` (each rank's gradient of it from its own channels only);
    "sum_no_backward" sums the squares over "model" with `reduce_from`
    alone (forward exact, the backward not summed); "local" normalises by
    the rank's own channels (no cross-rank sum)."""
    from repro_torch.launch import parallel as par
    from repro_torch.models.layers import rmsnorm

    def split_norm(self, norm, lo, hi):
        width, model = norm.scale.shape[0], self.model
        scale = (norm.scale if kind == "scale_raw" else par.copy_to(norm.scale, model)) \
            .narrow(0, lo, hi - lo)

        def apply(x, eps=1e-5):
            if kind == "local":
                return rmsnorm(scale, x, eps)
            xf = x.float()
            sq = par.reduce_from(torch.sum(xf * xf, dim=-1, keepdim=True), model)
            if kind != "sum_no_backward":
                sq = par.copy_to(sq, model)
            return (xf * torch.rsqrt(sq / width + eps) * scale.float()).to(x.dtype)
        return apply
    return split_norm


def leaf_bytes(node, path=""):
    """path → bytes of every tensor leaf of a decode cache (dicts and lists
    walked, other leaves left out)."""
    if isinstance(node, torch.Tensor):
        return {path: node.numel() * node.element_size()}
    items = node.items() if isinstance(node, dict) else enumerate(node) \
        if isinstance(node, list) else ()
    out = {}
    for k, v in items:
        out.update(leaf_bytes(v, f"{path}.{k}" if path else str(k)))
    return out


def run_split_ssm(payload, mesh):
    """payload: [dict(id, arch, layers, arrays, spec, steps, microbatches,
    seq, global_batch, tokens [B, T] or None, max_len, mutant)]. The arch's smoke
    config at `layers` layers in f32, holding the reference's weights
    (`from_reference`), placed on the mesh by the specs (the split plan)
    with `Layout.gather_params` made to raise; mutant (None, or a kind of
    `_mutant_norms`) swaps the plan's split RMSNorm for a faulty one.
    With tokens, first the split prefill's last-token logits of step 0's
    rows (`impl="chunked"`) and `decode_step` of each of the T tokens of
    the rank's rows from `init_cache(rows, max_len)` (its logits [T, rows,
    V] and the bytes of each cache leaf, by path); then `steps` train steps
    of `launch.train`'s data: the losses, grad norms and held bytes, the
    plan's choices, the rank's blocks of the leaves "model" does not
    split (with its "data" coordinate) and (rank 0) every parameter
    gathered."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import effective_batch_axes
    from repro_torch.models.weights import from_reference
    from repro_torch.train import OptimizerConfig, init_state, make_train_step

    def refuse(self, params):
        raise AssertionError("a split step gathered the parameters whole")
    out = {}
    plain_norm = sh.SplitPlan._split_norm
    for c in payload:
        cfg = dataclasses.replace(ARCHS[c["arch"]].smoke(), n_layers=c["layers"],
                                  dtype="float32")
        m = lt.make_mesh(c["spec"], device="cpu")
        model = from_reference(c["arrays"], cfg, device="cpu")
        state = init_state(model)
        gb = c["global_batch"]
        lay = sh.named(m, sh.param_specs(state.params, dict(m.shape)),
                       effective_batch_axes(m, gb))
        lay.gather_params = types.MethodType(refuse, lay)
        if c["mutant"]:
            sh.SplitPlan._split_norm = _mutant_norms(c["mutant"])
        try:
            state = sh.place(state, lay)
            plan = model.net.plan
            dc = lt.data_config(cfg, c["seq"], gb)
            rows = lay.rows(gb)
            res = dict(ran=lay.plan_for(cfg), rows=[rows.start, rows.stop],
                       batch_axes=lay.batch_axes,
                       plan={k: getattr(plan, k) for k in (
                           "heads", "q", "ff", "vocab", "mamba", "mamba_heads", "mlstm",
                           "mlstm_heads", "slstm", "channels")})
            toks = c["tokens"]
            if toks is not None:
                d_rows = lay.rows(toks.shape[0])
                with torch.inference_mode():
                    prefill, _ = model(lt.batch_for(cfg, dc, 0, "cpu", rows), impl="chunked",
                                       last_only=True)
                    cache = model.init_cache(d_rows.stop - d_rows.start, c["max_len"])
                    t = torch.from_numpy(toks[d_rows]).long()
                    dec = []
                    for i in range(t.shape[1]):
                        lg, cache = model.decode_step(t[:, i:i + 1], cache, i)
                        dec.append(host(lg))
                res.update(prefill=host(prefill), decode=np.stack(dec),
                           decode_rows=[d_rows.start, d_rows.stop],
                           cache_bytes=leaf_bytes(cache))
            step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                          total_steps=10),
                                   microbatches=c["microbatches"])
            hist = []
            for i in range(c["steps"]):
                state, met = step(state, lt.batch_for(cfg, dc, i, "cpu", rows))
                hist.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                                 lr=float(met["lr"]), held_bytes=sh.held_bytes(state)))
        finally:
            sh.SplitPlan._split_norm = plain_norm
        unsplit = {n: host(p.detach()) for n, p in state.params.items()
                   if not any("model" in sh._axes(e) for _, e in lay._split(n))}
        whole = {n: host(lay.gather(n, p.detach())) for n, p in state.params.items()}
        out[c["id"]] = dict(res, history=hist, data_rank=lay.axis("data").rank,
                            not_model_split=unsplit,
                            params=whole if mesh.rank == 0 else None)
    return out


def _mutant_cross(self, x, enc_out, impl, cfg, plan=None):
    """`DecLayer.cross` with the encoder output projected without
    `plan.enter`, to show that the tests see it: the forward is exact, but
    each rank's encoder gets only its own heads' part of the gradient."""
    from repro_torch.models.attention import attention_block
    p, q = self.cross_attn, self.ln_x(x, cfg.norm_eps)
    if plan is not None:
        p = plan.attention_weights(p)
        q = plan.enter(q, p.split)                  # enc_out does not pass `plan.enter`
    b, s, _ = enc_out.shape
    hkv = p.wk.shape[-1] // cfg.hd
    k = (enc_out @ p.wk).reshape(b, s, hkv, cfg.hd)
    v = (enc_out @ p.wv).reshape(b, s, hkv, cfg.hd)
    h = attention_block(p, q, None, causal=False, impl=impl, kv=(k, v))
    return x + (h if plan is None else plan.leave(h, p.split))


def run_split_encdec(payload, mesh):
    """payload: [dict(id, arch, layers, arrays, spec, steps, microbatches,
    seq, global_batch, frames [B, S, d] or None, tokens [B, T], enc_len,
    max_len, mutant)]. The arch's smoke config at `layers` encoder and
    `layers` decoder layers in f32, holding the reference's weights
    (`from_reference`), placed on the mesh by the specs (the split plan)
    with `Layout.gather_params` made to raise; mutant swaps
    `DecLayer.cross` for `_mutant_cross`. With frames, first the split
    prefill's last-token logits of step 0's rows (`impl="chunked"`), then
    the split encoder output of the rank's rows of `frames` written into
    `init_cache(rows, max_len, enc_len=S)` by `set_encoder_output` and
    `decode_step` of each of the T tokens: its logits [T, rows, V], the
    bytes of each cache leaf by path, its encoder slots and its block of
    the encoder output. Then `steps` train steps of `launch.train`'s
    data: the losses, grad norms and held bytes, the plan's choices, the
    rank's blocks of the leaves "model" does not split (with its "data"
    coordinate) and (rank 0) every parameter gathered."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import effective_batch_axes
    from repro_torch.models import encdec
    from repro_torch.models.weights import from_reference
    from repro_torch.train import OptimizerConfig, init_state, make_train_step

    def refuse(self, params):
        raise AssertionError("a split step gathered the parameters whole")
    out = {}
    plain_cross = encdec.DecLayer.cross
    for c in payload:
        cfg = dataclasses.replace(ARCHS[c["arch"]].smoke(), n_enc_layers=c["layers"],
                                  n_dec_layers=c["layers"], dtype="float32")
        m = lt.make_mesh(c["spec"], device="cpu")
        model = from_reference(c["arrays"], cfg, device="cpu")
        state = init_state(model)
        gb = c["global_batch"]
        lay = sh.named(m, sh.param_specs(state.params, dict(m.shape)),
                       effective_batch_axes(m, gb))
        lay.gather_params = types.MethodType(refuse, lay)
        if c["mutant"]:
            encdec.DecLayer.cross = _mutant_cross
        try:
            state = sh.place(state, lay)
            plan = model.net.plan
            dc = lt.data_config(cfg, c["seq"], gb)
            rows = lay.rows(gb)
            res = dict(ran=lay.plan_for(cfg), rows=[rows.start, rows.stop],
                       batch_axes=lay.batch_axes,
                       plan={k: getattr(plan, k) for k in (
                           "heads", "q", "kv", "own_q", "own_kv", "ff", "f", "vocab", "v")})
            frames = c["frames"]
            if frames is not None:
                d_rows = lay.rows(frames.shape[0])
                with torch.inference_mode():
                    prefill, _ = model(lt.batch_for(cfg, dc, 0, "cpu", rows), impl="chunked",
                                       last_only=True)
                    enc = model.net.encode(torch.from_numpy(frames[d_rows]))
                    cache = model.init_cache(d_rows.stop - d_rows.start, c["max_len"],
                                             enc_len=c["enc_len"])
                    model.net.set_encoder_output(cache, enc)
                    t = torch.from_numpy(c["tokens"][d_rows]).long()
                    dec = []
                    for i in range(t.shape[1]):
                        lg, cache = model.decode_step(t[:, i:i + 1], cache, i)
                        dec.append(host(lg))
                res.update(prefill=host(prefill), decode=np.stack(dec),
                           decode_rows=[d_rows.start, d_rows.stop],
                           cache_bytes=leaf_bytes(cache), enc_slots=plan.enc_slots(c["enc_len"]),
                           enc_block=host(cache["enc_out"]), enc_len=cache["enc_len"])
            step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                          total_steps=10),
                                   microbatches=c["microbatches"])
            hist = []
            for i in range(c["steps"]):
                state, met = step(state, lt.batch_for(cfg, dc, i, "cpu", rows))
                hist.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                                 lr=float(met["lr"]), held_bytes=sh.held_bytes(state)))
        finally:
            encdec.DecLayer.cross = plain_cross
        unsplit = {n: host(p.detach()) for n, p in state.params.items()
                   if not any("model" in sh._axes(e) for _, e in lay._split(n))}
        whole = {n: host(lay.gather(n, p.detach())) for n, p in state.params.items()}
        out[c["id"]] = dict(res, history=hist, data_rank=lay.axis("data").rank,
                            not_model_split=unsplit,
                            params=whole if mesh.rank == 0 and c["steps"] else None)
    return out


def _mutant_seq(kind):
    """(name, method) of a `SplitPlan` with a fault of `kind` in its
    sequence split, to show that the tests see it: "unsummed" gathers the
    attention weights over "model" with an unsummed backward (each rank's
    block of their gradient from its own rows only); "uncopied" cuts the
    rank's rows of x without `copy_to` (x's gradient from the rank's rows
    only)."""
    def seq_weights(self, attn):
        cfg = attn.cfg
        names = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if cfg.qkv_bias else [])
        return types.SimpleNamespace(
            cfg=cfg, q_norm=self._head_norm(getattr(attn, "q_norm", None), True),
            k_norm=self._head_norm(getattr(attn, "k_norm", None), True),
            **{n: self._take(getattr(attn, n), summed=False) for n in names})

    def seq_cut(self, x, lo, hi):
        return x[:, lo:hi]
    return {"unsummed": ("seq_weights", seq_weights), "uncopied": ("seq_cut", seq_cut)}[kind]


def run_split_seq(payload, mesh):
    """payload: [dict(id, arch, overrides, layers, arrays, spec, steps,
    microbatches, seq, global_batch, attn_shard, mutant)]. The arch's
    smoke config at `layers` layers (enc-dec: as many encoder and decoder
    layers) in f32 with the overrides, holding the reference's weights
    (`from_reference`), placed on the mesh by the specs (the split plan)
    with `Layout.gather_params` made to raise, the plan built with
    REPRO_ATTN_SHARD set to `attn_shard` (None: unset; the setting is
    restored after the case); mutant (None, or a kind of `_mutant_seq`)
    swaps a method of the plan for a faulty one. First the split
    prefill's last-token logits of step 0's rows (`impl="chunked"`),
    counting the attention calls that ran the sequence split
    (`SplitPlan.seq_join`) and the collectives over "model"; then `steps`
    train steps of `launch.train`'s data: the losses, grad norms and held
    bytes, the plan's mode, the rank's blocks of the leaves "model" does
    not split (with its "data" coordinate) and (rank 0) every parameter
    gathered."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import effective_batch_axes
    from repro_torch.models.weights import from_reference
    from repro_torch.train import OptimizerConfig, init_state, make_train_step

    def refuse(self, params):
        raise AssertionError("a split step gathered the parameters whole")
    out = {}
    plain = {n: getattr(sh.SplitPlan, n) for n in ("seq_weights", "seq_cut", "seq_join")}
    setting = os.environ.get("REPRO_ATTN_SHARD")
    for c in payload:
        layers = dict(n_enc_layers=c["layers"], n_dec_layers=c["layers"]) \
            if ARCHS[c["arch"]].family == "encdec" else dict(n_layers=c["layers"])
        cfg = dataclasses.replace(ARCHS[c["arch"]].smoke(), dtype="float32", **layers,
                                  **c["overrides"])
        m = lt.make_mesh(c["spec"], device="cpu")
        model = from_reference(c["arrays"], cfg, device="cpu")
        state = init_state(model)
        gb = c["global_batch"]
        lay = sh.named(m, sh.param_specs(state.params, dict(m.shape)),
                       effective_batch_axes(m, gb))
        lay.gather_params = types.MethodType(refuse, lay)
        joins = []

        def counted_join(self, o):
            joins.append(tuple(o.shape))
            return plain["seq_join"](self, o)
        sh.SplitPlan.seq_join = counted_join
        if c["mutant"]:
            name, method = _mutant_seq(c["mutant"])
            setattr(sh.SplitPlan, name, method)
        if c["attn_shard"] is None:
            os.environ.pop("REPRO_ATTN_SHARD", None)
        else:
            os.environ["REPRO_ATTN_SHARD"] = c["attn_shard"]
        try:
            state = sh.place(state, lay)
            plan = model.net.plan
            dc = lt.data_config(cfg, c["seq"], gb)
            rows = lay.rows(gb)
            counting, counts, restore = _model_collectives(plan.model.group)
            counting[0] = True
            try:
                with torch.inference_mode():
                    prefill, _ = model(lt.batch_for(cfg, dc, 0, "cpu", rows), impl="chunked",
                                       last_only=True)
            finally:
                counting[0] = False
                restore()
            res = dict(ran=lay.plan_for(cfg), rows=[rows.start, rows.stop], seq=plan.seq,
                       prefill=host(prefill), prefill_joins=list(joins),
                       model_collectives=list(counts), model_rank=plan.model.rank)
            step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                          total_steps=10),
                                   microbatches=c["microbatches"])
            hist = []
            for i in range(c["steps"]):
                state, met = step(state, lt.batch_for(cfg, dc, i, "cpu", rows))
                hist.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                                 lr=float(met["lr"]), held_bytes=sh.held_bytes(state)))
        finally:
            for n, f in plain.items():
                setattr(sh.SplitPlan, n, f)
            if setting is None:
                os.environ.pop("REPRO_ATTN_SHARD", None)
            else:
                os.environ["REPRO_ATTN_SHARD"] = setting
        unsplit = {n: host(p.detach()) for n, p in state.params.items()
                   if not any("model" in sh._axes(e) for _, e in lay._split(n))}
        whole = {n: host(lay.gather(n, p.detach())) for n, p in state.params.items()}
        out[c["id"]] = dict(res, history=hist, data_rank=lay.axis("data").rank,
                            not_model_split=unsplit,
                            step_joins=len(joins) - len(res["prefill_joins"]),
                            params=whole if mesh.rank == 0 and c["steps"] else None)
    return out


def run_gather_dtypes(payload, mesh):
    """payload: [(case_id, seed)]. One "data" axis of the world: a bf16
    leaf [8, 12] split by rows and an f32 leaf [12, 8] split by columns,
    gathered together by `gather_many` (summed: each rank its rows of x;
    not summed: all of x). Returns each whole leaf as it came (its dtype's
    name, its values in f32) and the rank's gradient blocks."""
    from repro_torch.core import dist
    from repro_torch.launch import parallel as par
    out = {}
    for cid, seed in payload:
        a = split_case_arrays(seed, SPLIT_CASE_SHAPES)
        data = dist.make_mesh((mesh.size, 1), ("data", "model"), device="cpu").axis("data")
        res = {}
        for summed in (True, False):
            w1 = par.block_of(torch.from_numpy(a["w_gate"]).bfloat16(), 0, data) \
                .clone().requires_grad_()
            w2 = par.block_of(torch.from_numpy(a["w_down"]), 1, data).clone().requires_grad_()
            x = torch.from_numpy(a["x"])
            rows = par.block_of(x, 0, data) if summed else x
            g1, g2 = par.gather_many([w1, w2], data, [0, 1], summed=summed)
            (((rows @ g1.float()) @ g2) ** 2).sum().backward()
            res[f"summed={summed}"] = dict(
                dtypes=(str(g1.dtype), str(g2.dtype), str(w1.grad.dtype), str(w2.grad.dtype)),
                w1=host(g1.detach().float()), w2=host(g2.detach()),
                grad1=host(w1.grad.float()), grad2=host(w2.grad))
        out[cid] = res
    return out


def run_cases(payload: dict, mesh) -> dict:
    """Each section of the payload ("programs", "exchanges", "gathers",
    "grid", "pods", "tune", "train", "reduce", "moments", "split_functions",
    "split_steps", "split_decode", "split_moe", "split_ssm", "split_encdec",
    "split_seq", "gather_dtypes"), in that order on every rank."""
    jobs = {"programs": run_programs, "exchanges": run_exchanges, "gathers": run_gathers,
            "grid": run_grid, "pods": run_pods, "tune": run_tune, "train": run_train,
            "reduce": run_reduce, "moments": run_moments,
            "split_functions": run_split_functions, "split_steps": run_split_steps,
            "split_decode": run_split_decode, "split_moe": run_split_moe,
            "split_ssm": run_split_ssm, "split_encdec": run_split_encdec,
            "split_seq": run_split_seq, "gather_dtypes": run_gather_dtypes}
    return {k: jobs[k](payload[k], mesh) for k in jobs if k in payload}
