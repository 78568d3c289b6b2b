"""Shared layers: norms, RoPE, SwiGLU MLP, embeddings.

PyTorch counterpart of `repro.models.layers`. Weights keep the reference's
`[in, out]` layout (`x @ W`), so a parameter carries over from the JAX
tree as a copy. Inits draw from a `torch.Generator` with the reference's
distributions (not its numbers: the two generators differ). `remat_call`
is the reference's `jax.checkpoint` on a layer body. The reference's
activation-sharding hooks (`set_constraint_mesh`, `maybe_constrain`)
become the split plan of a model (`launch.sharding.SplitPlan`), installed
per model by `Transformer.set_constraint_mesh` or
`EncDec.set_constraint_mesh`: `MLP` and
`Attention` take it as `plan` and run the rank's ff columns and heads
through it; with no plan they compute what they always did.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

def remat_call(remat: bool, fn, *args):
    """`fn(*args)`, its activations recomputed in the backward pass
    (`torch.utils.checkpoint`, non-reentrant) when `remat` is set and grad
    is enabled: the reference's `jax.checkpoint` on a layer body. Serving
    under `inference_mode` runs `fn` as it is."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --- init helpers -------------------------------------------------------------

class MetaInit:
    """The generator of an abstract build (`zoo.build(cfg, device="meta")`,
    the counterpart of `jax.eval_shape(model.init)`): it only names the
    device, since the meta device draws no numbers."""
    device = torch.device("meta")


def dense_init(shape, dtype, *, generator: torch.Generator | MetaInit,
               scale=None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) (or `scale`) drawn in f32, then cast. The
    tensor lands on the generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    gen = generator if isinstance(generator, torch.Generator) else None
    x = torch.randn(shape, generator=gen, device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def embed_init(vocab, d, dtype, *, generator: torch.Generator) -> torch.Tensor:
    return dense_init((vocab, d), dtype, generator=generator, scale=0.02)


def rmsnorm_init(d, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# --- RMSNorm -------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps=1e-5) -> torch.Tensor:
    """Computed in f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(rmsnorm_init(d, dtype, device))

    def forward(self, x, eps=1e-5):
        return rmsnorm(self.scale, x, eps)


# --- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The reference's frequencies, in f64, computed on `device`: a host
    array would reach the card as a copy from pageable memory, which
    synchronizes the stream on every call."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S]. Split halves (the first D/2
    channels rotate against the last D/2), computed in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device).float()
    ang = positions[..., :, None].float() * freqs               # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                          # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- SwiGLU MLP ------------------------------------------------------------------

class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as the reference writes it, x · (1 / (1 + exp(-x))), one
    op at a time, so bf16 rounds after each op as the reference's ops do.
    F.silu rounds once and lands one bf16 ulp away on many inputs: enough
    to flip a near-tied MoE routing choice a layer later, and to move a
    Mamba2 stack's bf16 logits past the parity tests' bound. The MoE and
    Mamba2 blocks use this; the dense MLPs keep F.silu (one kernel where
    this is five). Its gradient is jax's, g·s + (x·g)·(s·(1 - s)) with s
    the sigmoid: autograd through the ops above would give 0·inf, NaN,
    wherever exp(-x) overflows (x below -88)."""
    return _Silu.apply(x)


class MLP(nn.Module):
    """SwiGLU: act(x @ w_gate) * (x @ w_up) @ w_down; `act` F.silu or the
    reference-rounded `silu`."""

    def __init__(self, d, ff, dtype, *, generator: torch.Generator, act=F.silu):
        super().__init__()
        self.act = act
        self.w_gate = nn.Parameter(dense_init((d, ff), dtype, generator=generator))
        self.w_up = nn.Parameter(dense_init((d, ff), dtype, generator=generator))
        self.w_down = nn.Parameter(dense_init((ff, d), dtype, generator=generator))

    def forward(self, x, plan=None):
        """With `plan` (a split plan): the rank's ff columns, the output
        summed over "model"."""
        if plan is None:
            h = self.act(x @ self.w_gate) * (x @ self.w_up)
            return h @ self.w_down
        w_gate, w_up, w_down = plan.mlp_weights(self)
        x = plan.enter(x, plan.ff)
        h = self.act(x @ w_gate) * (x @ w_up)
        return plan.leave(h @ w_down, plan.ff)
