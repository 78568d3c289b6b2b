"""Mixture-of-Experts FFN: token-choice top-k routing with capacity and
optional always-on shared experts (deepseek-moe).

PyTorch counterpart of `repro.models.moe`. Capacity per expert is
C = max(int(cf · T · k / E), k); overflow assignments drop. Dispatch is an
explicit [E, C] token index and a gather, the expert products are batched
matmuls, and the combine adds each token's k slots as a [T, k, d] sum in a
fixed order: no atomics, so two calls on the same inputs are bitwise equal.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import MLP, dense_init, silu


class MoE(nn.Module):
    """router [d, E] f32, w_gate/w_up [E, d, ff], w_down [E, ff, d], and the
    `shared` MLP (ff · n_shared_experts wide) when the config has one."""

    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(dense_init((d, e), torch.float32, generator=generator,
                                              scale=0.02))
        self.w_gate = nn.Parameter(dense_init((e, d, ff), dtype, generator=generator))
        self.w_up = nn.Parameter(dense_init((e, d, ff), dtype, generator=generator))
        self.w_down = nn.Parameter(dense_init((e, ff, d), dtype, generator=generator))
        if cfg.n_shared_experts:
            self.shared = MLP(d, ff * cfg.n_shared_experts, dtype, generator=generator,
                              act=silu)

    def forward(self, x, cfg):
        return moe_ffn(self, cfg, x)


def route(p: MoE, cfg, xt):
    """xt: [T, d]. Returns (probs [T, E] f32, renormalised top-k gates
    [T, k] f32, their experts [T, k] int64, sorted by falling probability)."""
    logits = xt.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def moe_ffn(p: MoE, cfg, x):
    """x: [B, S, d] → ([B, S, d], the Switch load-balance aux loss, f32)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    # floor of k keeps tiny-T (decode) calls near-lossless
    cap = max(int(cfg.moe_capacity_factor * t * k / e), k)
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(p, cfg, xt)

    # slot of each (token, choice) in its expert, in (token, choice) order:
    # the reference's one-hot cumsum, as a stable sort by expert (a cumsum
    # down the [T·k, E] one-hot is a slow outer-dim scan on the card)
    flat_e = gate_idx.reshape(-1)                                     # [T*k]
    order = torch.argsort(flat_e, stable=True)
    starts = torch.searchsorted(flat_e[order], torch.arange(e + 1, device=x.device))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=x.device)
    pos = rank - starts[flat_e]
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_pos = torch.where(pos < cap, pos, cap)                       # cap = dropped
    # kept (expert, slot) pairs are distinct by construction; every dropped
    # one writes the pad row t into the spare column cap, sliced away
    disp = torch.full((e, cap + 1), t, dtype=torch.int64, device=x.device)
    disp[flat_e, flat_pos] = torch.where(flat_pos < cap, flat_t, t)
    disp = disp[:, :cap]                                              # [E, C]
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xe = x_pad[disp]                                                  # [E, C, d]
    h = silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    ye = torch.bmm(h, p.w_down)                                       # [E, C, d]

    # combine: each token owns its k consecutive slots of the flat order
    slot_ok = flat_pos < cap
    ye_flat = ye[flat_e, flat_pos.clamp(max=cap - 1)]                 # [T*k, d]
    wgt = (gate_vals.reshape(-1) * slot_ok).to(ye_flat.dtype)
    out = (ye_flat * wgt[:, None]).reshape(t, k, d).sum(dim=1)
    out = out.reshape(b, s, d).to(x.dtype)

    if cfg.n_shared_experts:
        out = out + p.shared(x)

    # load-balance aux loss (Switch): E · Σ_e f_e · p_e
    f = (starts[1:] - starts[:-1]).float() / t                        # choices per token
    pbar = probs.mean(dim=0)
    aux = e * (f * pbar).sum() * cfg.moe_aux_loss
    return out, aux
