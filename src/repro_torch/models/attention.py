"""GQA attention block: prefill (materialized, chunked or flash kernel) and
decode (KV cache) paths.

PyTorch counterpart of `repro.models.attention`. Implementation selection:
  * 'ref'     — materialized f32 scores; small shapes
  * 'chunked' — loops over query and kv chunks with online softmax: the
                plain-torch mirror of the flash kernel, O(chunk·S) memory
  * 'kernel'  — kernels/flash_attention (the card's prefill path)

The decode path updates its KV cache in place (the reference returns a new
cache; here the same dict comes back, written at its `length` slot).

Under a split plan (`launch.sharding.SplitPlan`, installed by
`Transformer.set_constraint_mesh`) a rank runs its own query heads and the
KV heads they read: `attention_block` and `_project_qkv` take the head
counts from the weights they get, so the same code runs a whole block and
a rank's share of one. Its decode (`split_attention_decode`) holds the
rank's block of the KV cache's sequence and combines the ranks' blocks in
one softmax across "model"; the enc-dec family's cross-attention decode
(`split_cross_decode`) does the same over the rank's block of the encoder
output's sequence. Under the plan's sequence split (the reference's
`REPRO_ATTN_SHARD=seq`) the train step's and the prefill's attention runs
the rank's rows of the sequence with every head instead
(`seq_attention`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention.ops import gqa_attention
from ..kernels.flash_attention.ref import attention_ref
from .layers import RMSNorm, apply_rope, dense_init

NEG_INF = -1e30
IMPLS = ("ref", "chunked", "kernel")


class Attention(nn.Module):
    """wq [d, H·hd], wk/wv [d, Hkv·hd], wo [H·hd, d]; bq/bk/bv with
    `cfg.qkv_bias`; q_norm/k_norm with `cfg.qk_norm`."""

    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dev = generator.device
        self.wq = nn.Parameter(dense_init((d, h * hd), dtype, generator=generator))
        self.wk = nn.Parameter(dense_init((d, hkv * hd), dtype, generator=generator))
        self.wv = nn.Parameter(dense_init((d, hkv * hd), dtype, generator=generator))
        self.wo = nn.Parameter(dense_init((h * hd, d), dtype, generator=generator))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(h * hd, dtype=dtype, device=dev))
            self.bk = nn.Parameter(torch.zeros(hkv * hd, dtype=dtype, device=dev))
            self.bv = nn.Parameter(torch.zeros(hkv * hd, dtype=dtype, device=dev))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dtype, dev)
            self.k_norm = RMSNorm(hd, dtype, dev)

    def forward(self, x, positions, *, causal=True, impl="ref", kv=None, plan=None):
        """With `plan`: the rank's heads, through the plan's weights, the
        output summed over "model" (`plan.leave`); under the plan's
        sequence split the rank's rows of the sequence (`seq_attention`)."""
        if plan is None:
            return attention_block(self, x, positions, causal=causal, impl=impl, kv=kv)
        if kv is None and plan.seq_rows(x.shape[1], impl) is not None:
            return seq_attention(self, x, positions, causal=causal, impl=impl, plan=plan)
        w = plan.attention_weights(self)
        o = attention_block(w, plan.enter(x, w.split), positions, causal=causal, impl=impl,
                            kv=kv)
        return plan.leave(o, w.split)


def _project_qkv(p: Attention, x, positions):
    cfg = p.cfg
    b, s, _ = x.shape
    hd = cfg.hd
    h, hkv = p.wq.shape[-1] // hd, p.wk.shape[-1] // hd     # the heads `p` holds
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = p.q_norm(q, cfg.norm_eps)
        k = p.k_norm(k, cfg.norm_eps)
    if positions is not None:   # rope (decoder); None for encoder w/o rope
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      k_chunk: int = 1024):
    """[B,H,S,D] online-softmax attention, O(chunk·S) live memory. Products
    in f32 (exact for bf16 operands), P cast to v's dtype before P·V, as
    the reference. SQ and SKV must be multiples of their chunks."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, skv)
    if sq % q_chunk or skv % k_chunk:
        raise ValueError(f"SQ={sq} and SKV={skv} must be multiples of the chunks "
                         f"{q_chunk} and {k_chunk}")
    scale = 1.0 / (d ** 0.5)
    offset = skv - sq
    out = torch.empty_like(q)
    for qi in range(sq // q_chunk):
        qb = q[:, :, qi * q_chunk:(qi + 1) * q_chunk].float()
        m = torch.full((b, h, q_chunk, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_chunk, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=q.device)
        for ki in range(skv // k_chunk):
            ks = k[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            vs = v[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            s = (qb @ ks.float().transpose(-1, -2)) * scale
            if causal:
                rows = qi * q_chunk + offset + torch.arange(q_chunk, device=q.device)[:, None]
                cols = ki * k_chunk + torch.arange(k_chunk, device=q.device)[None, :]
                s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pr = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pr.to(vs.dtype).float() @ vs.float()
            m = m_new
        out[:, :, qi * q_chunk:(qi + 1) * q_chunk] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


def _repeat_kv(k, groups):
    return k.repeat_interleave(groups, dim=1)


def project_kv(p: Attention, src):
    """Keys and values [B, S, Hkv, D] projected from `src` [B, S, d] with
    the KV heads `p` holds (bias added, no RoPE): cross-attention's, over
    the encoder output."""
    cfg = p.cfg
    b, s, _ = src.shape
    hkv = p.wk.shape[-1] // cfg.hd
    k = (src @ p.wk).reshape(b, s, hkv, cfg.hd)
    v = (src @ p.wv).reshape(b, s, hkv, cfg.hd)
    if cfg.qkv_bias:
        shape = (hkv, cfg.hd)
        k, v = k + p.bk.reshape(shape), v + p.bv.reshape(shape)
    return k, v


def attention_block(p: Attention, x, positions, *, causal=True, impl="ref", kv=None):
    """Self-attention. kv: optional (k_ext, v_ext) [B, S, Hkv, D] to attend
    over instead (cross-attention); x provides queries only in that case.
    The head counts are those of `p`'s weights."""
    q, k, v = _project_qkv(p, x, positions)
    if kv is not None:
        k, v = kv
    return _attend(p, q, k, v, causal=causal, impl=impl)


def _attend(p: Attention, q, k, v, *, causal, impl, k_chunk=1024):
    """Queries q [B, SQ, H, D] over k, v [B, SKV, Hkv, D] (causal: query i
    sees slot j <= i + SKV - SQ), through `p.wo`: [B, SQ, d]. `k_chunk` is
    `chunked_attention`'s."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    cfg = p.cfg
    b, s = q.shape[:2]
    q = q.transpose(1, 2)                       # [B,H,S,D]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    h = q.shape[1]
    groups = h // k.shape[1]
    if impl == "kernel":
        o = gqa_attention(q, k, v, causal=causal)   # handles GQA repeat
    else:
        k = _repeat_kv(k, groups)
        v = _repeat_kv(v, groups)
        if impl == "chunked":
            o = chunked_attention(q, k, v, causal=causal, k_chunk=k_chunk)
        else:
            bh = b * h
            o = attention_ref(q.reshape(bh, s, cfg.hd), k.reshape(bh, -1, cfg.hd),
                              v.reshape(bh, -1, cfg.hd), causal=causal)
            o = o.reshape(b, h, s, cfg.hd)
    o = o.transpose(1, 2).reshape(b, s, h * cfg.hd)
    return o @ p.wo


def prefix_chunk(n: int) -> int:
    """The largest divisor of `n` up to 1,024: a `chunked_attention` kv
    chunk that divides every multiple of `n` (each rank's causal prefix
    under the sequence split, which `min(1024, SKV)` often does not:
    1,280 slots at S 4,096 over 16 ranks)."""
    return next(c for c in range(min(n, 1024), 0, -1) if n % c == 0)


def seq_attention(p: Attention, x, positions, *, causal, impl, plan, enc=None):
    """Attention of a rank under the split plan's sequence split (the
    reference's `REPRO_ATTN_SHARD=seq`: q, k and v split over "model"
    along the sequence, every head on every rank).

    x: [B, S, d], whole on every rank of "model"; positions: [B, S] (None:
    no RoPE); enc (cross-attention): the encoder output [B, S_enc, d],
    whole, from which the keys and values are projected. The rank takes
    its rows [lo, hi) = `plan.seq_rows(S)` of x through `plan.seq_cut`
    (and of `enc`), projects them with the whole weights
    (`plan.seq_weights`), gathers k and v of every rank's rows over
    "model" (`plan.seq_gather`, one all-gather a layer) and attends: causal
    over the prefix [0, hi), whose bottom-right diagonal is exactly its
    rows' mask (`chunked_attention` then in chunks of `prefix_chunk(hi -
    lo)`, which divides every prefix), non-causal over every slot. Its
    output rows pass wo and are gathered over "model" (`plan.seq_join`):
    [B, S, d], whole on every rank."""
    w = plan.seq_weights(p)
    lo, hi = plan.seq_rows(x.shape[1], impl)
    rows = None if positions is None else positions[:, lo:hi]
    q, k, v = _project_qkv(w, plan.seq_cut(x, lo, hi), rows)
    if enc is not None:
        k, v = project_kv(w, plan.seq_cut(enc, *plan.seq_rows(enc.shape[1], impl)))
    k, v = plan.seq_gather(k, v)
    chunk = 1024
    if causal:
        k, v, chunk = k[:, :hi], v[:, :hi], prefix_chunk(hi - lo)
    return plan.seq_join(_attend(w, q, k, v, causal=causal, impl=impl, k_chunk=chunk))


def attention_decode(p: Attention, x, cache: dict, pos: int):
    """One-token decode with a static KV cache, updated in place.

    x: [B, 1, d]; cache: dict(k, v: [B, S_cache, Hkv, D], length: int);
    pos: the current position. Writes the new k, v at slot `length`,
    attends over slots 0..length and returns (out [B, 1, d], cache) with
    `length` advanced by one — the same dict."""
    cfg = p.cfg
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions)
    length = cache["length"]
    cache["k"][:, length] = k_new[:, 0]
    cache["v"][:, length] = v_new[:, 0]
    groups = cfg.n_heads // cfg.n_kv_heads
    qh = q.transpose(1, 2)                                     # [B,H,1,D]
    kh = _repeat_kv(cache["k"].transpose(1, 2), groups)         # [B,H,S,D]
    vh = _repeat_kv(cache["v"].transpose(1, 2), groups)
    scale = 1.0 / (cfg.hd ** 0.5)
    s = (qh.float() @ kh.float().transpose(-1, -2)) * scale
    valid = torch.arange(kh.shape[2], device=x.device) <= length
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(vh.dtype)
    o = w @ vh
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.hd)
    cache["length"] = length + 1
    return o @ p.wo, cache


def split_attention_decode(p: Attention, x, cache: dict, pos: int, plan):
    """`attention_decode` of a rank under a split plan
    (`launch.sharding.SplitPlan`), its block of the cache written in place.

    cache: dict(k, v: [B, hi - lo, Hkv, D], the rank's slots [lo, hi) of
    a cache of `max_len` slots (`plan.cache_slots`); length: the filled
    slots of the whole cache, the same on every rank; max_len). The new
    token's k and v, of every KV head, go to slot `length` on the rank
    that holds it. Where the sequence is split, every rank scores all H
    query heads (gathered over "model") against its slots and the ranks'
    blocks meet in one softmax (`_softmax_over_slots`); where it is not,
    every rank holds every slot and scores its own heads alone. The
    output of its heads passes its rows of wo and `plan.leave`. Returns
    (out [B, 1, d] whole, cache) with `length` advanced by one."""
    cfg = p.cfg
    b, hd = x.shape[0], cfg.hd
    length, max_len = cache["length"], cache.get("max_len")
    if max_len is None:
        raise ValueError("a split decode needs the plan's cache (init_cache with the plan "
                         "installed)")
    lo, hi = plan.cache_slots(max_len)
    if cache["k"].shape[1] != hi - lo or not 0 <= length < max_len:
        raise ValueError(f"slot {length} of a {max_len}-slot cache whose block holds "
                         f"{cache['k'].shape[1]} slots, not the plan's [{lo}, {hi})")
    split = hi - lo < max_len
    w = plan.attention_weights(p, all_kv=True)
    positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(w, plan.enter(x, w.split), positions)
    if w.kv_blocks:
        k_new, v_new = plan.gather_kv_heads(torch.stack([k_new, v_new]))
    if lo <= length < hi:
        cache["k"][:, length - lo] = k_new[:, 0]
        cache["v"][:, length - lo] = v_new[:, 0]
    if split:
        q, k, v = plan.gather_heads(q[:, 0]), cache["k"], cache["v"]
    else:
        klo, khi = plan.kv
        q, k, v = q[:, 0], cache["k"][:, :, klo:khi], cache["v"][:, :, klo:khi]
    nk = k.shape[2]
    qg = q.float().reshape(b, nk, q.shape[1] // nk, hd)        # [B, Hkv, G, D]
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * (1.0 / (hd ** 0.5))
    valid = lo + torch.arange(k.shape[1], device=x.device) <= length
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    o = _softmax_over_slots(s, v, plan if split else None).reshape(b, -1, hd)
    if split and w.split:
        o = o[:, plan.q[0]:plan.q[1]]
    cache["length"] = length + 1
    return plan.leave(o.reshape(b, 1, -1) @ w.wo, w.split), cache


def split_cross_decode(p: Attention, x, enc_out, enc_len: int, plan):
    """The cross-attention of one decoder token of a rank under a split
    plan (`launch.sharding.SplitPlan`) over its block of the encoder
    output, as the reference decodes it: K and V projected from the
    cached encoder output again at every step, no RoPE, every slot valid.
    Plain torch: the flash kernel returns no log-sum-exp to combine
    across ranks.

    x: [B, 1, d], the normed input; enc_out: [B, hi - lo, d], the rank's
    slots [lo, hi) of an encoder output of `enc_len` slots
    (`plan.enc_slots`). Where the slots are split, every rank projects
    its slots with wk and wv of every KV head (`plan.every_kv_head`),
    scores all H query heads (gathered over "model") against them, and
    the ranks' blocks meet in one softmax (`_softmax_over_slots`); where
    they are not, every rank holds every slot and attends with its own
    heads over the KV heads they read. The output of its heads passes its
    rows of wo and `plan.leave`. Returns out [B, 1, d], whole."""
    cfg = p.cfg
    b, hd = x.shape[0], cfg.hd
    lo, hi = plan.enc_slots(enc_len)
    if enc_out.shape[1] != hi - lo:
        raise ValueError(f"an encoder output block of {enc_out.shape[1]} slots, not the "
                         f"plan's [{lo}, {hi}) of {enc_len}")
    split = hi - lo < enc_len
    w = plan.attention_weights(p)
    q, _, _ = _project_qkv(w, plan.enter(x, w.split), None)
    kv = plan.every_kv_head(p) if split else vars(w)
    q = plan.gather_heads(q[:, 0]) if split else q[:, 0]          # [B, heads, D]
    nk = kv["wk"].shape[-1] // hd
    k = (enc_out @ kv["wk"]).reshape(b, hi - lo, nk, hd)
    v = (enc_out @ kv["wv"]).reshape(b, hi - lo, nk, hd)
    if cfg.qkv_bias:
        k, v = k + kv["bk"].reshape(nk, hd), v + kv["bv"].reshape(nk, hd)
    qg = q.float().reshape(b, nk, q.shape[1] // nk, hd)        # [B, Hkv, G, D]
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * (1.0 / (hd ** 0.5))
    o = _softmax_over_slots(s, v, plan if split else None).reshape(b, -1, hd)
    if split and w.split:
        o = o[:, plan.q[0]:plan.q[1]]
    return plan.leave(o.reshape(b, 1, -1) @ w.wo, w.split)


def _softmax_over_slots(s, v, plan=None):
    """Attention of f32 scores `s` [B, Hkv, G, T] over values `v` [B, T,
    Hkv, D] in the reference's roundings (an f32 softmax, the
    probabilities cast to v's dtype, their products with v summed in f32
    and cast once): [B, Hkv, G, D] in v's dtype. With `plan` the T slots
    are this rank's block of the cache: the row max, the sum of
    exponentials and the f32 partial products are each all-reduced over
    "model", so every rank gets the attention over every slot; a block
    with no valid slot (all NEG_INF) adds zeros."""
    top = s.amax(dim=-1, keepdim=True)
    if plan is not None:
        plan.max_over_model(top)
    e = torch.exp(s - top)
    total = e.sum(dim=-1, keepdim=True)
    if plan is not None:
        plan.sum_over_model(total)
    o = torch.einsum("bkgt,btkd->bkgd", (e / total).to(v.dtype).float(), v.float())
    if plan is not None:
        plan.sum_over_model(o)
    return o.to(v.dtype)


def init_kv_cache(cfg, batch, max_len, dtype, device):
    """dict(k, v: zeros [B, max_len, Hkv, D], length: 0)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}
