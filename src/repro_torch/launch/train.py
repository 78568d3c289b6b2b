"""Production training entry point: sharded end-to-end loop with checkpointing.

PyTorch counterpart of `repro.launch.train`. Assembles mesh → sharded state
→ train step and runs it, with:
  * resume-from-latest on start (crash ⇒ relaunch ⇒ the same trajectory,
    because the data pipeline is stateless in the step number);
  * periodic atomic checkpoints, written by rank 0;
  * elastic re-mesh: a mesh other than the checkpoint's re-shards on
    restore (train/checkpoint.py restores through host numpy).

Every rank draws the global batch of a step and keeps its rows along the
batch axes, so a sharded run computes what a one-device run computes.

    python -m repro_torch.launch.train --mesh 1,1 --steps 20          # one card
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 \\
        --steps 20 --ckpt-dir /tmp/run1                              # four cards
    python -m repro_torch.launch.train --mesh 1,1 --device cpu        # the CPU

With no process group (a single process) a one-rank mesh runs unsharded;
under torchrun each rank takes cuda:LOCAL_RANK and NCCL (gloo with
--device cpu).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import torch
import torch.distributed as tdist

from ..configs import ARCHS
from ..core import dist
from ..graph.csr import resolve_device
from ..models import build
from ..train import OptimizerConfig, checkpoint as ckpt, init_state, make_train_step
from ..train.data import DataConfig, batch_at, embeds_batch_at
from . import sharding as sh
from .mesh import effective_batch_axes


def make_mesh(spec: str, *, device=None):
    """"4,2" → a ("data", "model") mesh over the default process group;
    three dims name ("pod", "data", "model")."""
    dims = tuple(int(x) for x in spec.split(","))
    names = ("pod", "data", "model")[-len(dims):]
    return dist.make_mesh(dims, names, device=device)


def model_config(arch: str, smoke: bool):
    """The config `run` trains: the arch's smoke config cut to 2 layers,
    or the full one."""
    cfg = ARCHS[arch]
    return dataclasses.replace(cfg.smoke(), n_layers=2) if smoke else cfg


def optimizer_config(cfg, steps: int, lr: float) -> OptimizerConfig:
    return OptimizerConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps,
                           schedule="wsd" if cfg.wsd_schedule else "cosine")


def data_config(cfg, seq: int, global_batch: int) -> DataConfig:
    return DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch, structure=8)


def batch_for(cfg, dc: DataConfig, step: int, device, rows=slice(None)) -> dict:
    """The global batch of `step` (frame embeddings too for the stub
    frontends), cut to `rows`."""
    if cfg.input_kind == "embeddings" or cfg.family == "encdec":
        batch = embeds_batch_at(dc, step, cfg.d_model, device)
    else:
        batch = batch_at(dc, step, device)
    return {k: v[rows] for k, v in batch.items()}


def init_sharded(model, mesh, global_batch: int):
    """A fresh train state of a whole `model` placed on `mesh` by the
    reference's specs: the parameters are placed first, so the zero m and
    v are made as this rank's blocks and no rank ever holds them whole (8
    bytes a parameter: 135 GB for deepseek-moe-16b)."""
    params = dict(model.net.named_parameters())
    layout = sh.named(mesh, sh.param_specs(params, dict(mesh.shape)),
                      effective_batch_axes(mesh, global_batch))
    sh.place_model(model, layout)
    state = init_state(model)
    state.layout = layout
    return state


def run(arch: str, mesh_spec: str, steps: int, *, smoke: bool = True,
        seq: int = 64, global_batch: int = 8, microbatches: int = 2,
        ckpt_dir: str | None = None, ckpt_every: int = 50, lr: float = 1e-3,
        log_every: int = 10, device=None, history: list | None = None):
    """Trains `arch` on `mesh_spec` up to step `steps` (resuming from the
    latest checkpoint in `ckpt_dir`) and returns the last step's loss.
    `device` is the card (None) or "cpu"; with a process group a mesh rank
    takes cuda:LOCAL_RANK. `history`, when given, receives one dict per
    step: its loss, lr and grad norm, the bytes of parameters, m and v this
    rank holds after it, and its seconds."""
    cfg = model_config(arch, smoke)
    dims = [int(x) for x in mesh_spec.split(",")]
    sharded = tdist.is_available() and tdist.is_initialized()
    if not sharded and math.prod(dims) != 1:
        raise RuntimeError(f"mesh {mesh_spec} needs {math.prod(dims)} ranks: start them "
                           "with torchrun (or init_process_group), or pass a one-rank mesh")
    mesh = make_mesh(mesh_spec, device=device) if sharded else None
    rank = mesh.rank if mesh else 0
    dev = mesh.device if mesh else resolve_device(device)
    model = build(cfg, dev)
    state = init_sharded(model, mesh, global_batch) if mesh else init_state(model)
    layout = state.layout
    start = 0
    if ckpt_dir and (latest := ckpt.latest_step(ckpt_dir)) is not None:
        state = ckpt.restore(ckpt_dir, latest, state, shardings=layout)
        start = latest
        if rank == 0:
            print(f"[train] resumed from step {start} (re-sharded onto {mesh_spec})",
                  flush=True)
    oc = optimizer_config(cfg, steps, lr)
    step_fn = make_train_step(model, oc, microbatches=microbatches, impl="ref")
    dc = data_config(cfg, seq, global_batch)
    rows = layout.rows(global_batch) if layout else slice(None)

    t0 = time.time()
    metrics = {}
    for i in range(start, steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch_for(cfg, dc, i, dev, rows))
        loss = float(metrics["loss"])          # waits for the step
        if history is not None:
            history.append(dict(step=i, loss=loss, lr=float(metrics["lr"]),
                                grad_norm=float(metrics["grad_norm"]),
                                held_bytes=sh.held_bytes(state),
                                seconds=time.perf_counter() - t))
        if rank == 0 and (i % log_every == 0 or i == steps - 1):
            print(f"[train] step {i:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, i + 1, state)
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, state)
    dt = time.time() - t0
    world = math.prod(mesh.shape.values()) if mesh else 1
    if rank == 0:
        print(f"[train] {steps - start} steps in {dt:.1f}s on mesh {mesh_spec} "
              f"({world} devices); final loss {float(metrics['loss']):.4f}", flush=True)
    return float(metrics["loss"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--mesh", default="4,2")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="the arch's smoke config at 2 layers (--no-smoke: full size)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    device = None if args.device == "cuda" else "cpu"
    under_launcher = "WORLD_SIZE" in os.environ
    if under_launcher:        # torchrun: its env names the rendezvous
        if device is None:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        tdist.init_process_group(dist.BACKEND_FOR[args.device])
    try:
        run(args.arch, args.mesh, args.steps, smoke=args.smoke, seq=args.seq,
            global_batch=args.batch, microbatches=args.microbatches,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=device)
    finally:
        if under_launcher:
            tdist.destroy_process_group()


if __name__ == "__main__":
    main()
