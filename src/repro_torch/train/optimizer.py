"""AdamW with WSD (warmup-stable-decay) and cosine schedules.

PyTorch counterpart of `repro.train.optimizer`, written out leaf by leaf
rather than through `torch.optim.AdamW` (whose decay and bias correction
differ): the step counter is incremented before the schedule is read,
gradients are clipped by their global norm, and each update runs in f32
and is cast back to the parameter's dtype.

WSD is minicpm-2b's schedule (arXiv:2404.06395): the LR warms up, holds
at peak for most of training, then decays in the final fraction.

Parameters, gradients, m and v are dicts keyed by the model's parameter
names (`model.net.named_parameters()`); m and v are f32. Under
`launch.sharding` each rank holds only its block of every sharded leaf,
and the same update runs on the blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.weights import reference_path


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | wsd | constant
    wsd_decay_frac: float = 0.1       # last 10% decays (minicpm)
    min_lr_frac: float = 0.1


def lr_at(oc: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or a 0-d tensor), a 0-d f32
    tensor on the step's device, computed in f32 as the reference does."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    if oc.schedule == "constant":
        return oc.lr * warm
    if oc.schedule == "wsd":
        decay_start = oc.total_steps * (1.0 - oc.wsd_decay_frac)
        frac = torch.clamp((step - decay_start) / max(oc.total_steps - decay_start, 1), 0, 1)
        decay = 1.0 - (1.0 - oc.min_lr_frac) * frac
        return oc.lr * warm * decay
    # cosine
    frac = torch.clamp(step / oc.total_steps, 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return oc.lr * warm * (oc.min_lr_frac + (1 - oc.min_lr_frac) * cos)


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay goes to "matrices only" by the reference's leaf rank:
    its per-layer leaves carry a leading [L] axis, so a member of a
    layer stack counts one rank more than the port's unstacked tensor
    (a layer's [d] norm scale is [L, d] there, and decays)."""
    return p.ndim + (reference_path(name)[1] is not None) >= 2


def init_opt_state(params: dict) -> dict:
    """{"m", "v": f32 zeros shaped like each parameter, "step": int32 0-d}."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def adamw_update(oc: OptimizerConfig, params: dict, grads: dict, opt_state: dict, *,
                 grad_norm: torch.Tensor | None = None):
    """Updates `params` (name → parameter) and `opt_state` in place from
    `grads` (name → gradient, each leaf's shape). `grad_norm` is the global
    norm when the caller has it already (a sharded state's grads are
    blocks, whose own norm is not the global one). Returns (params,
    opt_state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
    scale = torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if oc.grad_clip else 1.0
    lr = lr_at(oc, step)
    b1, b2 = oc.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        if oc.weight_decay and decays(name, p):
            delta = delta + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
