"""Encoder-decoder backbone (seamless-m4t-large-v2).

PyTorch counterpart of `repro.models.encdec`. The audio frontend is a
stub: the encoder consumes precomputed frame embeddings [B, S, d]. The
decoder is a causal stack with cross-attention into the encoder output.
Decoding keeps a self-attention KV cache per layer and the encoder output;
as in the reference, each step projects the cross K and V from
`cache["enc_out"]` again. With `remat` and grad enabled, each encoder and
decoder layer body runs under `layers.remat_call`.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, attention_block, attention_decode, init_kv_cache
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

    def cross(self, x, enc_out, impl, cfg):
        """Cross-attention of x's queries over the projected encoder output
        (no RoPE on either side), the residual added."""
        p = self.cross_attn
        b, s, _ = enc_out.shape
        k = (enc_out @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        v = (enc_out @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        if cfg.qkv_bias:
            shape = (cfg.n_kv_heads, cfg.hd)
            k, v = k + p.bk.reshape(shape), v + p.bv.reshape(shape)
        h = attention_block(p, self.ln_x(x, cfg.norm_eps), None, causal=False, impl=impl,
                            kv=(k, v))
        return x + h


class EncDec(nn.Module):
    """embed [V, d] (tied: it also unembeds), enc_layers, dec_layers
    (ModuleLists), ln_enc and ln_f. The parameters land on the generator's
    device."""

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

    def encode(self, embeds, *, impl="ref", remat=True):
        """embeds: [B, S, d] precomputed frame embeddings (the frontend
        stub). Non-causal self-attention with RoPE. Returns [B, S, d]."""
        cfg = self.cfg
        x = embeds.to(_dt(cfg))
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

        def body(x, lp):
            x = x + lp.attn(lp.ln1(x, cfg.norm_eps), positions, causal=False, impl=impl)
            return x + lp.mlp(lp.ln2(x, cfg.norm_eps))
        for lp in self.enc_layers:
            x = remat_call(remat, body, x, lp)
        return self.ln_enc(x, cfg.norm_eps)

    def decode_train(self, tokens, enc_out, *, impl="ref", remat=True, last_only=False):
        """Teacher-forced decoder pass over tokens [B, S]. Returns logits
        [B, S, V] f32 ([B, 1, V] with last_only)."""
        cfg = self.cfg
        x = self.embed[tokens]
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

        def body(x, lp):
            x = x + lp.self_attn(lp.ln1(x, cfg.norm_eps), positions, causal=True, impl=impl)
            x = lp.cross(x, enc_out, impl, cfg)
            return x + lp.mlp(lp.ln2(x, cfg.norm_eps))
        for lp in self.dec_layers:
            x = remat_call(remat, body, x, lp)
        x = self.ln_f(x, cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        return (x @ self.embed.T).float()

    def forward(self, embeds, tokens, *, impl="ref", remat=True, last_only=False):
        """Frame embeddings → target logits. Returns (logits, aux 0.0)."""
        enc_out = self.encode(embeds, impl=impl, remat=remat)
        logits = self.decode_train(tokens, enc_out, impl=impl, remat=remat,
                                   last_only=last_only)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def init_cache(self, batch: int, max_len: int, enc_len: int | None = None) -> dict:
        """{"kv": one self-attention KV cache per decoder layer, "enc_out":
        zeros [B, enc_len (default max_len), d] for the caller to fill}."""
        cfg, dev, dtype = self.cfg, self.embed.device, _dt(self.cfg)
        return {"kv": [init_kv_cache(cfg, batch, max_len, dtype, dev) for _ in self.dec_layers],
                "enc_out": torch.zeros((batch, enc_len or max_len, cfg.d_model), dtype=dtype,
                                       device=dev)}

    def decode_step(self, tokens, cache: dict, pos: int, *, impl="ref"):
        """One decoder token [B, 1] against the cached enc_out and the self
        KV caches (written in place). Returns (logits [B, V] f32, cache)."""
        cfg = self.cfg
        x = self.embed[tokens]
        for lp, lc in zip(self.dec_layers, cache["kv"]):
            h, _ = attention_decode(lp.self_attn, lp.ln1(x, cfg.norm_eps), lc, pos)
            x = x + h
            x = lp.cross(x, cache["enc_out"], impl, cfg)
            x = x + lp.mlp(lp.ln2(x, cfg.norm_eps))
        x = self.ln_f(x, cfg.norm_eps)
        return (x[:, 0] @ self.embed.T).float(), cache
