"""Mixture-of-Experts FFN: token-choice top-k routing with capacity and
optional always-on shared experts (deepseek-moe).

PyTorch counterpart of `repro.models.moe`. Capacity per expert is
C = max(int(cf · T · k / E), k); overflow assignments drop. Dispatch is an
explicit [E, C] token index and a gather, the expert products are batched
matmuls, and the combine adds each token's k slots as a [T, k, d] sum in a
fixed order: no atomics, so two calls on the same inputs are bitwise equal.

Under a split plan (`launch.sharding.SplitPlan`, `plan.experts`) a rank
holds and runs its block of E/m experts over "model", the reference's
experts on the 'model' mesh axis. Routing is replicated: every rank of
"model" routes the same tokens (the plan keeps them whole on every rank)
from the same router, so probabilities, choices, capacity, slots and the
[E, C] dispatch are equal across "model", and a rank gathers its experts'
rows of the dispatch locally, with no collective. The all-to-all of the
reference's dispatch pays only once the tokens split over "model"
(sequence split, ROADMAP 15e); until then it would move nothing a rank
lacks. The combine weighs an assignment outside the rank's experts 0, sums
each token's k slots in f32 with the shared experts' partial product (the
rank's block of their ff columns), and makes one `reduce_from` over
"model" in f32 a layer, cast once to x's dtype.
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

    def forward(self, x, cfg, plan=None):
        return moe_ffn(self, cfg, x, plan)


def route(p: MoE, cfg, xt):
    """xt: [T, d]. Returns (probs [T, E] f32, renormalised top-k gates
    [T, k] f32, their experts [T, k] int64, sorted by falling probability)."""
    logits = xt.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _dispatch(gate_idx, t, e, k, cap):
    """The slot of each (token, choice) in its expert and the [E, C] token
    index of every expert's slots (the pad row t where a slot is empty):
    (flat_e, flat_pos [T·k] — cap where the assignment dropped —, starts
    [E + 1], disp [E, C])."""
    dev = gate_idx.device
    # slot of each (token, choice) in its expert, in (token, choice) order:
    # the reference's one-hot cumsum, as a stable sort by expert (a cumsum
    # down the [T·k, E] one-hot is a slow outer-dim scan on the card)
    flat_e = gate_idx.reshape(-1)                                     # [T*k]
    order = torch.argsort(flat_e, stable=True)
    starts = torch.searchsorted(flat_e[order], torch.arange(e + 1, device=dev))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)
    pos = rank - starts[flat_e]
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_pos = torch.where(pos < cap, pos, cap)                       # cap = dropped
    # kept (expert, slot) pairs are distinct by construction; every dropped
    # one writes the pad row t into the spare column cap, sliced away
    disp = torch.full((e, cap + 1), t, dtype=torch.int64, device=dev)
    disp[flat_e, flat_pos] = torch.where(flat_pos < cap, flat_t, t)
    return flat_e, flat_pos, starts, disp[:, :cap]                    # [E, C]


def _experts(w_gate, w_up, w_down, xt, rows):
    """The experts' outputs [E', C, d] on tokens `rows` [E', C] of xt (the
    pad row len(xt) reads zeros)."""
    x_pad = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))])
    xe = x_pad[rows]                                                  # [E', C, d]
    h = silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def moe_ffn(p: MoE, cfg, x, plan=None):
    """x: [B, S, d] → ([B, S, d], the Switch load-balance aux loss, f32).
    With `plan` (a split plan): the rank's experts and shared-expert
    columns (`plan.moe_weights`), the output whole on every rank."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    # floor of k keeps tiny-T (decode) calls near-lossless
    cap = max(int(cfg.moe_capacity_factor * t * k / e), k)
    xt = x.reshape(t, d)
    w = p if plan is None else plan.moe_weights(p)
    probs, gate_vals, gate_idx = route(w, cfg, xt)
    flat_e, flat_pos, starts, disp = _dispatch(gate_idx, t, e, k, cap)
    slot_ok = flat_pos < cap

    if plan is None:
        ye = _experts(p.w_gate, p.w_up, p.w_down, xt, disp)              # [E, C, d]
        # combine: each token owns its k consecutive slots of the flat order
        ye_flat = ye[flat_e, flat_pos.clamp(max=cap - 1)]                 # [T*k, d]
        wgt = (gate_vals.reshape(-1) * slot_ok).to(ye_flat.dtype)
        out = (ye_flat * wgt[:, None]).reshape(t, k, d).sum(dim=1)
        out = out.reshape(b, s, d).to(x.dtype)
        if cfg.n_shared_experts:
            out = out + p.shared(x)
    else:
        out = _split_combine(w, plan, x, gate_vals, flat_e, flat_pos, slot_ok, disp)

    # load-balance aux loss (Switch): E · Σ_e f_e · p_e
    f = (starts[1:] - starts[:-1]).float() / t                        # choices per token
    pbar = probs.mean(dim=0)
    aux = e * (f * pbar).sum() * cfg.moe_aux_loss
    return out, aux


def _split_combine(w, plan, x, gate_vals, flat_e, flat_pos, slot_ok, disp):
    """The MoE output of a rank under a split plan (`w`: its
    `moe_weights`), whole on every rank of "model". Only the dispatched
    tokens and the gates pass `copy_to` (`plan.enter`): their gradients are
    the sums of the ranks' parts. The routing input does not, or the router
    path's gradient would be added m times. A group the plan does not split
    runs whole on every rank, outside the one `plan.leave`."""
    t, k = gate_vals.shape
    d = x.shape[-1]
    cap = disp.shape[1]
    lo, hi = w.e
    # one `copy_to` where both groups split (one all-reduce in the backward)
    xin = plan.enter(x, w.experts).reshape(t, d)
    xsh = xin if w.shared_split == w.experts else plan.enter(x, w.shared_split).reshape(t, d)
    ye = _experts(w.w_gate, w.w_up, w.w_down, xin, disp[lo:hi]).reshape(-1, d)   # [E/m·C, d]
    mine = (slot_ok & (flat_e >= lo) & (flat_e < hi)).view(t, k)
    slot = ((flat_e - lo).clamp(0, hi - lo - 1) * cap + flat_pos.clamp(max=cap - 1)).view(t, k)
    wgt = plan.enter(gate_vals, w.experts) * mine                     # [T, k] f32
    # each token's k slots summed in f32 in order, one [T, d] slot at a time:
    # never the [T·k, d] rows in f32 (qwen3-moe at 64K tokens: 8.6 GB each)
    acc = ye[slot[:, 0]].float() * wgt[:, :1]
    for j in range(1, k):
        acc = acc + ye[slot[:, j]].float() * wgt[:, j:j + 1]
    parts, whole = ([acc], []) if w.experts else ([], [acc])
    if w.shared is not None:
        w_gate, w_up, w_down = w.shared
        hs = silu(xsh @ w_gate) * (xsh @ w_up)
        (parts if w.shared_split else whole).append((hs @ w_down).float())
    out = plan.leave(sum(parts), True) if parts else 0.0
    out = out + sum(whole) if whole else out
    return out.reshape(x.shape).to(x.dtype)
