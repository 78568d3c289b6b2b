"""SSM / linear-attention layers: Mamba2 (SSD chunked scan), mLSTM, sLSTM.

PyTorch counterpart of `repro.models.ssm`, in plain torch: the reference
runs all of it in XLA, outside any Pallas kernel. Mamba2 and mLSTM are
gated linear recurrences over an outer-product state,

    h_t = a_t · h_{t-1} + k_t ⊗ v_t          (state  [N, P])
    y_t = qᵗ_t · h_t                          (readout)

`chunked_linear_attention` evaluates it with intra-chunk matmuls and an
inter-chunk scan (a Python loop over chunks here, the reference's
`lax.scan`); `linear_attention_ref` is the sequential oracle. The sLSTM's
per-token recurrence is a Python loop over tokens. Every f32 state and
every dtype cast of the reference is kept, so bf16 rounds where it does.

Under a split plan (`launch.sharding.SplitPlan`, installed by
`Transformer.set_constraint_mesh`) each block takes `plan`: a rank runs
its Mamba2 or mLSTM heads, or its sLSTM channels, through the plan's
weights (`mamba2_weights`, `mlstm_weights`, `slstm_weights`), its input
entered and its output summed over "model". The block functions take
their head and channel counts from the weights they get, so the same
code runs a whole block and a rank's share of one; a state holds what
its weights compute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import RMSNorm, dense_init, silu


# --------------------------------------------------------------------------
# Core: chunked gated linear attention (SSD dual form)
# --------------------------------------------------------------------------

def chunked_linear_attention(q, k, v, log_a, chunk: int):
    """q,k: [B,S,H,N]; v: [B,S,H,P]; log_a: [B,S,H] (log decay ≤ 0), S a
    multiple of `chunk`. Returns y: [B,S,H,P] f32 where
    y_t = q_t · (Σ_{s≤t} (∏_{r=s+1..t} a_r) k_s v_sᵀ)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, h, n)
    kc = k.reshape(b, nc, chunk, h, n)
    vc = v.reshape(b, nc, chunk, h, p)
    cum = torch.cumsum(log_a.reshape(b, nc, chunk, h), dim=2)     # within-chunk
    total = cum[:, :, -1]                                         # [B,nc,H]

    # intra-chunk: scores[t1,t2] = q_t1·k_t2 · exp(cum_t1 - cum_t2), t2 ≤ t1
    sc = torch.einsum("bcthn,bcshn->bchts", qc.float(), kc.float())
    decay = (cum[..., :, None, :] - cum[..., None, :, :]).permute(0, 1, 4, 2, 3)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    # the mask goes inside the exp: above the diagonal the decay is the
    # positive sum of -log a over the span, whose exp overflows in f32 once
    # it passes 88, and where(mask, sc·inf, 0) has a NaN gradient (0·inf)
    w = sc * torch.exp(torch.where(causal, decay, -torch.inf))
    y_intra = torch.einsum("bchts,bcshp->bcthp", w.to(v.dtype), vc)

    # chunk summaries: S_c = Σ_t exp(total - cum_t) k_t ⊗ v_t
    wk = torch.exp(total[:, :, None, :] - cum)[..., None] * kc
    s_chunk = torch.einsum("bcthn,bcthp->bchnp", wk.to(v.dtype), vc).float()

    # inter-chunk scan h_c = exp(total_c) h_{c-1} + S_c; chunk c reads the
    # state BEFORE it
    decay_c = torch.exp(total)[..., None, None]                   # [B,nc,H,1,1]
    h_prevs = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=q.device)
    hcur = torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
    for c in range(nc):
        h_prevs[:, c] = hcur
        hcur = hcur * decay_c[:, c] + s_chunk[:, c]

    # inter-chunk readout: y_t += exp(cum_t) q_t · h_{c-1}
    qdec = torch.exp(cum)[..., None] * qc
    y_inter = torch.einsum("bcthn,bchnp->bcthp", qdec.float(), h_prevs)
    y = y_intra.float() + y_inter
    return y.reshape(b, s, h, p)


def linear_attention_ref(q, k, v, log_a):
    """Sequential oracle (and the decode recurrence), all in f32."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    q, k, v, log_a = (t.float() for t in (q, k, v, log_a))
    hcur = torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        hcur = hcur * torch.exp(log_a[:, t])[..., None, None] + \
            k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", q[:, t], hcur))
    return torch.stack(ys, dim=1)                                 # [B,S,H,P]


def _chunked_or_ref(q, k, v, log_a, chunk):
    s = q.shape[1]
    if s % chunk == 0 and s > 1:
        return chunked_linear_attention(q, k, v, log_a, chunk)
    return linear_attention_ref(q, k, v, log_a)


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

class Mamba2(nn.Module):
    """in_proj [d, 2d + 2N + H], conv_w [K, d + 2N], a_log/dt_bias/d_skip
    [H] f32 (A = -exp(a_log)), out_proj [d, d], norm."""

    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        heads = d // cfg.ssm_head_dim
        dev = generator.device
        self.in_proj = nn.Parameter(dense_init((d, 2 * d + 2 * n + heads), dtype,
                                               generator=generator))
        self.conv_w = nn.Parameter(dense_init((cfg.conv_width, d + 2 * n), dtype,
                                              generator=generator, scale=0.5))
        self.a_log = nn.Parameter(torch.zeros(heads, dtype=torch.float32, device=dev))
        self.dt_bias = nn.Parameter(torch.full((heads,), -2.0, dtype=torch.float32, device=dev))
        self.d_skip = nn.Parameter(torch.ones(heads, dtype=torch.float32, device=dev))
        self.out_proj = nn.Parameter(dense_init((d, d), dtype, generator=generator))
        self.norm = RMSNorm(d, dtype, dev)

    def forward(self, x, cfg, chunk=None, plan=None):
        if plan is None:
            return mamba2_block(self, cfg, x, chunk)
        plan = plan.gather_layer(self)
        w = plan.mamba2_weights(self)
        return plan.leave(mamba2_block(w, cfg, plan.enter(x, w.split), chunk), w.split)


def _causal_conv(x, w):
    """x: [B,S,C]; w: [K,C] depthwise causal conv, summed tap by tap in
    x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i]
    return out


def _split_in_proj(hin, cfg, heads):
    """z, x, B|C and dt of in_proj's product for `heads` heads."""
    c, n = heads * cfg.ssm_head_dim, cfg.ssm_state
    return torch.split(hin, [c, c, 2 * n, heads], dim=-1)


def mamba2_block(p: Mamba2, cfg, x, chunk=None):
    """x: [B,S,d] → [B,S,d] (the caller adds the residual); the heads
    are those of `p`'s a_log, whose channels its norm and out_proj take."""
    b, s, _ = x.shape
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    heads = p.a_log.shape[0]
    c = heads * pdim
    chunk = chunk or min(cfg.ssm_chunk, s)
    z, xin, bc, dt = _split_in_proj(x @ p.in_proj, cfg, heads)
    conv_out = silu(_causal_conv(torch.cat([xin, bc], dim=-1), p.conv_w))
    xin, bmat, cmat = torch.split(conv_out, [c, n, n], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)                       # [B,S,H] f32
    log_a = -torch.exp(p.a_log) * dt                              # [B,S,H]
    xh = xin.reshape(b, s, heads, pdim)
    k = bmat[:, :, None, :].expand(b, s, heads, n)
    q = cmat[:, :, None, :].expand(b, s, heads, n)
    v = xh * dt[..., None].to(xh.dtype)
    y = _chunked_or_ref(q, k, v, log_a, chunk)
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = y.reshape(b, s, c).to(x.dtype) * silu(z)
    return p.norm(y, cfg.norm_eps) @ p.out_proj


def mamba2_decode(p: Mamba2, cfg, x, state, plan=None):
    """One-token decode. x: [B,1,d]; state: dict(h: [B,H,N,P] f32,
    conv: [B,K-1,C]). Returns (out [B,1,d], new state). With `plan`: the
    rank's heads (`SplitPlan.mamba2_weights`), whose state `state` holds
    (h [B,Hr,N,P], conv [B,K-1,Hr·P+2N]: their x channels, then B and C)."""
    split = None
    if plan is not None:
        plan = plan.gather_layer(p)
        p = plan.mamba2_weights(p)
        split, x = p.split, plan.enter(x, p.split)
    b = x.shape[0]
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    heads = p.a_log.shape[0]
    c = heads * pdim
    z, xin, bc, dt = _split_in_proj(x @ p.in_proj, cfg, heads)
    hist = torch.cat([state["conv"], torch.cat([xin, bc], dim=-1)], dim=1)   # [B,K,C]
    conv_out = silu(torch.einsum("bkc,kc->bc", hist, p.conv_w))[:, None]
    xin, bmat, cmat = torch.split(conv_out, [c, n, n], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]                 # [B,H]
    decay = torch.exp(-torch.exp(p.a_log) * dt)                   # [B,H]
    xh = xin.reshape(b, heads, pdim)
    kt = bmat[:, 0, None, :].expand(b, heads, n)
    qt = cmat[:, 0, None, :].expand(b, heads, n)
    vt = xh * dt[..., None].to(xh.dtype)
    hnew = state["h"] * decay[..., None, None] + \
        kt.float()[..., :, None] * vt.float()[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", qt.float(), hnew)
    y = y + p.d_skip[None, :, None] * xh.float()
    y = y.reshape(b, 1, c).to(x.dtype) * silu(z)
    out = p.norm(y, cfg.norm_eps) @ p.out_proj
    if plan is not None:
        out = plan.leave(out, split)
    return out, {"h": hnew, "conv": hist[:, 1:]}


def mamba2_init_state(cfg, batch, dtype, device, heads=None):
    """The zero state of `heads` heads (all of them by default)."""
    heads = heads or cfg.d_model // cfg.ssm_head_dim
    return {"h": torch.zeros((batch, heads, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1,
                                 heads * cfg.ssm_head_dim + 2 * cfg.ssm_state),
                                dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# --------------------------------------------------------------------------

class MLSTM(nn.Module):
    """wq/wk/wv/wo_gate [d, H·hd], wf/wi [d, H] f32, out [H·hd, d], norm."""

    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        d, heads, hd = cfg.d_model, cfg.n_heads, cfg.hd
        g = generator
        self.wq = nn.Parameter(dense_init((d, heads * hd), dtype, generator=g))
        self.wk = nn.Parameter(dense_init((d, heads * hd), dtype, generator=g))
        self.wv = nn.Parameter(dense_init((d, heads * hd), dtype, generator=g))
        self.wf = nn.Parameter(dense_init((d, heads), torch.float32, generator=g, scale=0.02))
        self.wi = nn.Parameter(dense_init((d, heads), torch.float32, generator=g, scale=0.02))
        self.wo_gate = nn.Parameter(dense_init((d, heads * hd), dtype, generator=g))
        self.out = nn.Parameter(dense_init((heads * hd, d), dtype, generator=g))
        self.norm = RMSNorm(heads * hd, dtype, g.device)

    def forward(self, x, cfg, chunk=None, plan=None):
        if plan is None:
            return mlstm_block(self, cfg, x, chunk)
        plan = plan.gather_layer(self)
        w = plan.mlstm_weights(self)
        return plan.leave(mlstm_block(w, cfg, plan.enter(x, w.split), chunk), w.split)


def _mlstm_qkv(p: MLSTM, cfg, x):
    """q (scaled), k (times the input gate), v: [B,S,H,hd]; log forget
    gate [B,S,H] f32; H the heads of `p`'s wf."""
    b, s, _ = x.shape
    heads, hd = p.wf.shape[-1], cfg.hd
    q = (x @ p.wq).reshape(b, s, heads, hd) / (hd ** 0.5)
    k = (x @ p.wk).reshape(b, s, heads, hd)
    v = (x @ p.wv).reshape(b, s, heads, hd)
    logf = F.logsigmoid(x.float() @ p.wf)                         # ≤ 0
    i_gate = torch.exp(torch.clamp(x.float() @ p.wi, max=8.0))
    k = k * i_gate[..., None].to(k.dtype)
    return q, k, v, logf


def mlstm_block(p: MLSTM, cfg, x, chunk=None):
    """mLSTM ≈ gated linear attention with sigmoid forget / exp input gates."""
    b, s, _ = x.shape
    heads, hd = p.wf.shape[-1], cfg.hd
    chunk = chunk or min(cfg.ssm_chunk, s)
    q, k, v, logf = _mlstm_qkv(p, cfg, x)
    y = _chunked_or_ref(q, k, v, logf, chunk)
    o = torch.sigmoid(x @ p.wo_gate).reshape(b, s, heads, hd)
    y = (y.to(x.dtype) * o).reshape(b, s, heads * hd)
    return p.norm(y, cfg.norm_eps) @ p.out


def mlstm_decode(p: MLSTM, cfg, x, state, plan=None):
    """One-token decode. state: dict(h [B,H,hd,hd] f32, m [B,H], n [B,H,hd]);
    m and n pass through, as in the reference. With `plan`: the rank's
    heads (`SplitPlan.mlstm_weights`), whose h `state` holds; m and n whole."""
    split = None
    if plan is not None:
        plan = plan.gather_layer(p)
        p = plan.mlstm_weights(p)
        split, x = p.split, plan.enter(x, p.split)
    b = x.shape[0]
    heads, hd = p.wf.shape[-1], cfg.hd
    q, k, v, logf = (t[:, 0] for t in _mlstm_qkv(p, cfg, x))
    hnew = state["h"] * torch.exp(logf)[..., None, None] + \
        k.float()[..., :, None] * v.float()[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", q.float(), hnew)
    o = torch.sigmoid(x @ p.wo_gate).reshape(b, heads, hd)
    y = (y.to(x.dtype) * o).reshape(b, 1, heads * hd)
    out = p.norm(y, cfg.norm_eps) @ p.out
    if plan is not None:
        out = plan.leave(out, split)
    return out, {"h": hnew, "m": state["m"], "n": state["n"]}


def mlstm_init_state(cfg, batch, device, heads=None):
    """The zero state; h of `heads` heads (all of them by default), m and
    n of every head."""
    hd = cfg.hd
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, heads or cfg.n_heads, hd, hd), **f32),
            "m": torch.zeros((batch, cfg.n_heads), **f32),
            "n": torch.zeros((batch, cfg.n_heads, hd), **f32)}


class SLSTM(nn.Module):
    """wz/wo/out [d, d], wi/wf [d, d] f32, norm."""

    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        d, g = cfg.d_model, generator
        self.wz = nn.Parameter(dense_init((d, d), dtype, generator=g))
        self.wi = nn.Parameter(dense_init((d, d), torch.float32, generator=g, scale=0.02))
        self.wf = nn.Parameter(dense_init((d, d), torch.float32, generator=g, scale=0.02))
        self.wo = nn.Parameter(dense_init((d, d), dtype, generator=g))
        self.out = nn.Parameter(dense_init((d, d), dtype, generator=g))
        self.norm = RMSNorm(d, dtype, g.device)

    def forward(self, x, cfg, plan=None):
        if plan is None:
            return slstm_block(self, cfg, x)
        plan = plan.gather_layer(self)
        w = plan.slstm_weights(self)
        return plan.leave(slstm_block(w, cfg, plan.enter(x, w.split)), w.split)


def _slstm_gates(p: SLSTM, x):
    """z, i, log f and o pre-activations in f32 for every token of x."""
    z = torch.tanh(x @ p.wz).float()
    i_pre = x.float() @ p.wi
    logf = F.logsigmoid(x.float() @ p.wf)
    o = torch.sigmoid(x @ p.wo).float()
    return z, i_pre, logf, o


def _slstm_step(c, n, m, zt, it, logft, ot):
    m_new = torch.maximum(logft + m, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(logft + m - m_new)
    c = f_sc * c + i_sc * zt
    n = f_sc * n + i_sc
    return c, n, m_new, ot * c / torch.clamp(n, min=1.0)


def slstm_block(p: SLSTM, cfg, x):
    """Scalar-memory LSTM with exponential gating: inherently sequential,
    one step per token (the reference's lax.scan), over the channels of
    `p`'s wz."""
    b, s, _ = x.shape
    width = p.wz.shape[-1]
    z, i_pre, logf, o = _slstm_gates(p, x)
    c = torch.zeros((b, width), dtype=torch.float32, device=x.device)
    n = torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
    hs = torch.empty((b, s, width), dtype=torch.float32, device=x.device)
    for t in range(s):
        c, n, m, hs[:, t] = _slstm_step(c, n, m, z[:, t], i_pre[:, t], logf[:, t], o[:, t])
    return p.norm(hs.to(x.dtype), cfg.norm_eps) @ p.out


def slstm_decode(p: SLSTM, cfg, x, state, plan=None):
    """One sLSTM step with carried (c, n, m) state. x: [B, 1, d]. With
    `plan`: the rank's channels (`SplitPlan.slstm_weights`), whose state
    `state` holds."""
    split = None
    if plan is not None:
        plan = plan.gather_layer(p)
        p = plan.slstm_weights(p)
        split, x = p.split, plan.enter(x, p.split)
    z, i_pre, logf, o = (t[:, 0] for t in _slstm_gates(p, x))
    c, n, m, h = _slstm_step(state["c"], state["n"], state["m"], z, i_pre, logf, o)
    y = p.norm(h.to(x.dtype)[:, None], cfg.norm_eps) @ p.out
    if plan is not None:
        y = plan.leave(y, split)
    return y, {"c": c, "n": n, "m": m}


def slstm_init_state(cfg, batch, device, width=None):
    """The zero state of `width` channels (d by default)."""
    c = torch.zeros((batch, width or cfg.d_model), dtype=torch.float32, device=device)
    return {"c": c, "n": torch.zeros_like(c), "m": torch.full_like(c, -1e30)}
