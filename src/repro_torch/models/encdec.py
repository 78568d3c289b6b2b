"""Encoder-decoder backbone (seamless-m4t-large-v2).

PyTorch counterpart of `repro.models.encdec`. The audio frontend is a
stub: the encoder consumes precomputed frame embeddings [B, S, d]. The
decoder is a causal stack with cross-attention into the encoder output.
Decoding keeps a self-attention KV cache per layer and the encoder output;
as in the reference, each step projects the cross K and V from
`cache["enc_out"]` again. With `remat` and grad enabled, each encoder and
decoder layer body runs under `layers.remat_call`.

`set_constraint_mesh(layout)` installs a layout's split plan
(`launch.sharding.SplitPlan`; `launch.sharding.place` does it), as
`Transformer.set_constraint_mesh` does: each encoder and decoder layer is
gathered over "data" inside its remat body and runs the rank's query
heads (encoder self-attention, decoder self-attention and
cross-attention), KV heads and ff columns over "model"; the embedding and
the logits run the rank's vocab rows. `init_cache` then holds the rank's
rows, its block of each self-attention cache's slots and its block of
the encoder output's slots (`SplitPlan.enc_slots`, the reference's
`cache_specs`), which `set_encoder_output` fills, and `decode_step`
combines the ranks' blocks in a softmax across "model"
(`models.attention.split_attention_decode`, `split_cross_decode`). Under
the plan's sequence split (`REPRO_ATTN_SHARD=seq`) the encoder's and the
decoder's self-attention and the cross-attention of the train step and
the prefill run the rank's rows of their sequences with every head
(`models.attention.seq_attention`).
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import (Attention, attention_block, attention_decode, init_kv_cache,
                        project_kv, seq_attention, split_attention_decode,
                        split_cross_decode)
from .layers import MLP, RMSNorm, embed_init, remat_call


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class EncLayer(nn.Module):
    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = RMSNorm(cfg.d_model, dtype, dev)
        self.attn = Attention(cfg, dtype, generator=generator)
        self.ln2 = RMSNorm(cfg.d_model, dtype, dev)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, generator=generator)


class DecLayer(nn.Module):
    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = RMSNorm(cfg.d_model, dtype, dev)
        self.self_attn = Attention(cfg, dtype, generator=generator)
        self.ln_x = RMSNorm(cfg.d_model, dtype, dev)
        self.cross_attn = Attention(cfg, dtype, generator=generator)
        self.ln2 = RMSNorm(cfg.d_model, dtype, dev)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, generator=generator)

    def cross(self, x, enc_out, impl, cfg, plan=None):
        """Cross-attention of x's queries over the projected encoder output
        (no RoPE on either side), the residual added. With `plan`: the
        rank's query heads over the KV heads they read, projected from
        `enc_out` through `plan.enter` (each rank's heads give a part of
        the encoder output's gradient), its rows of wo, then
        `plan.leave`; under the plan's sequence split, where it applies to
        both sequences, the rank's rows of x's over the keys and values of
        every rank's rows of `enc_out` (`seq_attention`)."""
        p, q = self.cross_attn, self.ln_x(x, cfg.norm_eps)
        if plan is not None and plan.seq_rows(q.shape[1], impl) is not None \
                and plan.seq_rows(enc_out.shape[1], impl) is not None:
            return x + seq_attention(p, q, None, causal=False, impl=impl, plan=plan,
                                     enc=enc_out)
        if plan is not None:
            p = plan.attention_weights(p)
            enc_out, q = plan.enter(enc_out, p.split), plan.enter(q, p.split)
        h = attention_block(p, q, None, causal=False, impl=impl, kv=project_kv(p, enc_out))
        return x + (h if plan is None else plan.leave(h, p.split))

    def decode(self, x, lc, cache, pos, impl, cfg, plan=None):
        """One token through the layer: self-attention over its KV cache
        `lc` (written in place), cross-attention over `cache["enc_out"]`,
        the MLP. With `plan`: the layer gathered over "data" first, then
        the rank's block of each cache (`split_attention_decode`,
        `split_cross_decode`: plain torch, whatever `impl`) and its ff
        columns."""
        if plan is None:
            h, _ = attention_decode(self.self_attn, self.ln1(x, cfg.norm_eps), lc, pos)
            x = self.cross(x + h, cache["enc_out"], impl, cfg)
            return x + self.mlp(self.ln2(x, cfg.norm_eps))
        plan = plan.gather_layer(self)
        h, _ = split_attention_decode(self.self_attn, self.ln1(x, cfg.norm_eps), lc, pos, plan)
        x = x + h
        x = x + split_cross_decode(self.cross_attn, self.ln_x(x, cfg.norm_eps), cache["enc_out"],
                                   cache["enc_len"], plan)
        return x + self.mlp(self.ln2(x, cfg.norm_eps), plan)


class EncDec(nn.Module):
    """embed [V, d] (tied: it also unembeds), enc_layers, dec_layers
    (ModuleLists), ln_enc and ln_f. The parameters land on the generator's
    device."""

    plan = None        # the installed split plan (`set_constraint_mesh`)

    def __init__(self, cfg, *, generator: torch.Generator):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec builds the 'encdec' family, not {cfg.family!r}")
        self.cfg = cfg
        dtype, g = _dt(cfg), generator
        self.embed = nn.Parameter(embed_init(cfg.vocab_padded, cfg.d_model, dtype, generator=g))
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dtype, generator=g)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, generator=g)
                                        for _ in range(cfg.n_dec_layers))
        self.ln_enc = RMSNorm(cfg.d_model, dtype, g.device)
        self.ln_f = RMSNorm(cfg.d_model, dtype, g.device)

    def set_constraint_mesh(self, layout):
        """Installs the split plan of `layout` (a `launch.sharding.Layout`
        whose blocks the parameters hold) on this model; None removes it."""
        if layout is None:
            self.plan = None
            return
        self.plan = layout.split_plan(self.cfg, dict(self.named_parameters()))

    def encode(self, embeds, *, impl="ref", remat=True):
        """embeds: [B, S, d] precomputed frame embeddings (the frontend
        stub). Non-causal self-attention with RoPE. Returns [B, S, d],
        whole on every rank of "model" under a plan."""
        cfg, plan = self.cfg, self.plan
        x = embeds.to(_dt(cfg))
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

        def body(x, lp):
            pl = None if plan is None else plan.gather_layer(lp)
            x = x + lp.attn(lp.ln1(x, cfg.norm_eps), positions, causal=False, impl=impl,
                            plan=pl)
            return x + lp.mlp(lp.ln2(x, cfg.norm_eps), pl)
        for lp in self.enc_layers:
            x = remat_call(remat, body, x, lp)
        return self.ln_enc(x, cfg.norm_eps)

    def decode_train(self, tokens, enc_out, *, impl="ref", remat=True, last_only=False):
        """Teacher-forced decoder pass over tokens [B, S]. Returns logits
        [B, S, V] f32 ([B, 1, V] with last_only). Under a split plan the
        logits of the rank's vocab block [B, S, V / m], and [B, 1, V]
        whole with last_only."""
        cfg, plan = self.cfg, self.plan
        x = self.embed[tokens] if plan is None else plan.embed(self.embed, tokens)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

        def body(x, lp):
            pl = None if plan is None else plan.gather_layer(lp)
            x = x + lp.self_attn(lp.ln1(x, cfg.norm_eps), positions, causal=True, impl=impl,
                                 plan=pl)
            x = lp.cross(x, enc_out, impl, cfg, pl)
            return x + lp.mlp(lp.ln2(x, cfg.norm_eps), pl)
        for lp in self.dec_layers:
            x = remat_call(remat, body, x, lp)
        x = self.ln_f(x, cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        if plan is None:
            return (x @ self.embed.T).float()
        logits = plan.logits(x, self)
        return plan.gather_vocab(logits) if last_only else logits

    def forward(self, embeds, tokens, *, impl="ref", remat=True, last_only=False):
        """Frame embeddings → target logits. Returns (logits, aux 0.0)."""
        enc_out = self.encode(embeds, impl=impl, remat=remat)
        logits = self.decode_train(tokens, enc_out, impl=impl, remat=remat,
                                   last_only=last_only)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def init_cache(self, batch: int, max_len: int, enc_len: int | None = None) -> dict:
        """{"kv": one self-attention KV cache per decoder layer, "enc_out":
        zeros [B, enc_len (default max_len), d] for `set_encoder_output`
        to fill}. Under a split plan `batch` is the rank's rows, each KV
        cache holds the rank's slots of `max_len` (`SplitPlan.cache_slots`)
        and records `max_len`, "enc_out" holds the rank's slots of
        `enc_len` (`SplitPlan.enc_slots`) and the cache records
        "enc_len"."""
        cfg, dev, dtype, plan = self.cfg, self.embed.device, _dt(self.cfg), self.plan
        enc_len = enc_len or max_len
        if plan is None:
            return {"kv": [init_kv_cache(cfg, batch, max_len, dtype, dev)
                           for _ in self.dec_layers],
                    "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=dtype,
                                           device=dev)}
        lo, hi = plan.cache_slots(max_len)
        elo, ehi = plan.enc_slots(enc_len)
        return {"kv": [dict(init_kv_cache(cfg, batch, hi - lo, dtype, dev), max_len=max_len)
                       for _ in self.dec_layers],
                "enc_out": torch.zeros((batch, ehi - elo, cfg.d_model), dtype=dtype, device=dev),
                "enc_len": enc_len}

    def set_encoder_output(self, cache: dict, enc_out) -> dict:
        """Writes the encoder output `enc_out` [B, enc_len, d] (of the
        cache's rows: a rank's rows under a plan, as `encode` of them gives
        it) into `cache` in place: whole, or the rank's block of its slots
        under a split plan. Returns the cache."""
        if self.plan is not None:
            if enc_out.shape[1] != cache["enc_len"]:
                raise ValueError(f"an encoder output of {enc_out.shape[1]} slots for a cache "
                                 f"of {cache['enc_len']}")
            lo, hi = self.plan.enc_slots(cache["enc_len"])
            enc_out = enc_out[:, lo:hi]
        cache["enc_out"].copy_(enc_out)
        return cache

    def decode_step(self, tokens, cache: dict, pos: int, *, impl="ref"):
        """One decoder token [B, 1] against the cached enc_out and the self
        KV caches (written in place). Returns (logits [B, V] f32, cache).
        Under a split plan tokens are the rank's rows and the cache its
        block (`init_cache` with the plan installed): the logits come back
        whole, equal on every rank of "model"."""
        cfg, plan = self.cfg, self.plan
        x = self.embed[tokens] if plan is None else plan.embed(self.embed, tokens)
        for lp, lc in zip(self.dec_layers, cache["kv"]):
            x = lp.decode(x, lc, cache, pos, impl, cfg, plan)
        x = self.ln_f(x, cfg.norm_eps)
        if plan is not None:
            return plan.gather_vocab(plan.logits(x, self))[:, 0], cache
        return (x[:, 0] @ self.embed.T).float(), cache
