"""End-to-end LM training on the PyTorch/CUDA port: a reduced minicpm-style
model (WSD schedule, the arch's paper-of-record trick), with
checkpoint/restart fault tolerance demonstrated mid-run.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200     # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 6 --seq 16 --batch 4

Midway the state is saved through `repro_torch.train.checkpoint`, and a
fresh model, state and step (as a restarted process would build them)
restore it from `latest_step` and carry on. Training runs `impl="ref"`.
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.graph import resolve_device
from repro_torch.models import build
from repro_torch.train import (OptimizerConfig, checkpoint as ckpt, init_state,
                               make_train_step)
from repro_torch.train.data import DataConfig, batch_at


def fresh_run(cfg, oc, microbatches, device):
    """The model (seeded init), its state with zero moments and its step, as
    a process starting from nothing builds them."""
    model = build(cfg, device=device, seed=0)
    return model, init_state(model), make_train_step(model, oc, microbatches=microbatches,
                                                     impl="ref")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # reduced same-family config, slightly widened for a real loss curve
    cfg = dataclasses.replace(ARCHS[args.arch].smoke(), n_layers=4, vocab=1024)
    oc = OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps,
                         schedule="wsd" if cfg.wsd_schedule else "cosine")
    model, state, step_fn = fresh_run(cfg, oc, args.microbatches, args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} (reduced) params={n_params/1e6:.1f}M "
          f"schedule={'wsd' if cfg.wsd_schedule else 'cosine'}")
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                    structure=8)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    losses, restored = {}, None
    t0 = time.time()
    for i in range(args.steps):
        state, m = step_fn(state, batch_at(dc, i, device=args.device))
        if i % 20 == 0 or i == args.steps - 1:
            losses[i] = float(m["loss"])
            print(f"step {i:4d}  loss {losses[i]:.4f}  "
                  f"lr {float(m['lr']):.2e}  gnorm {float(m['grad_norm']):.2f}")
        if i == args.steps // 2:
            # mid-run checkpoint + simulated failure + restore
            ckpt.save(ckpt_dir, i + 1, state)
            print(f"--- checkpoint at step {i+1}; simulating failure+restart ---")
            model, like, step_fn = fresh_run(cfg, oc, args.microbatches, args.device)
            restored = ckpt.latest_step(ckpt_dir)
            state = ckpt.restore(ckpt_dir, restored, like)
    final = float(m["loss"])     # reads the last step's loss: the device is done
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"done: {args.steps} steps, {toks/dt:.0f} tok/s on {where}, "
          f"final loss {final:.4f}")
    return {"losses": losses, "final_loss": final, "restored_step": restored,
            "tokens_per_s": toks / dt, "seconds": dt, "device": where}


if __name__ == "__main__":
    main()
