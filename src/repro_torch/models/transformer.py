"""Model assembly: the dense decoder-only LM.

PyTorch counterpart of `repro.models.transformer` for the dense family:

    net = Transformer(cfg, generator=...)          the reference's init(key, cfg)
    logits, aux = net(tokens, impl=..., last_only=...)   prefill / training path
    cache = net.init_cache(batch, max_len)
    logits, cache = net.decode_step(tokens, cache, pos)

The reference's `jax.lax.scan` over `[L]`-stacked layer parameters becomes
an `nn.ModuleList` walked in Python. `remat` is accepted for the
reference's signature and has no effect: nothing here trains yet. The moe,
hybrid and ssm families are not ported (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, attention_decode, init_kv_cache
from .layers import MLP, RMSNorm, dense_init, embed_init

PORTED_FAMILIES = ("dense",)


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DenseLayer(nn.Module):
    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = RMSNorm(cfg.d_model, dtype, dev)
        self.attn = Attention(cfg, dtype, generator=generator)
        self.ln2 = RMSNorm(cfg.d_model, dtype, dev)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, generator=generator)

    def forward(self, x, positions, impl, cfg):
        scale = cfg.scale_depth / (cfg.n_layers ** 0.5) if cfg.scale_depth else 1.0
        h = self.attn(self.ln1(x, cfg.norm_eps), positions, causal=True, impl=impl)
        x = x + h * scale
        h = self.mlp(self.ln2(x, cfg.norm_eps))
        return x + h * scale


class Transformer(nn.Module):
    """embed [V, d], ln_f, layers (ModuleList of DenseLayer), and unembed
    [d, V] unless the embeddings are tied. The parameters land on the
    generator's device."""

    def __init__(self, cfg, *, generator: torch.Generator):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                "(ROADMAP queue 1, item 12: LM substrate)")
        self.cfg = cfg
        dtype = _dt(cfg)
        self.embed = nn.Parameter(embed_init(cfg.vocab_padded, cfg.d_model, dtype,
                                             generator=generator))
        self.ln_f = RMSNorm(cfg.d_model, dtype, generator.device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(dense_init((cfg.d_model, cfg.vocab_padded), dtype,
                                                   generator=generator))
        self.layers = nn.ModuleList(DenseLayer(cfg, dtype, generator=generator)
                                    for _ in range(cfg.n_layers))

    def _w_out(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def forward(self, tokens, *, impl="ref", remat: bool = True, last_only: bool = False):
        """tokens: [B, S] integer. Returns (logits [B, S, V] f32 — [B, 1, V]
        with last_only —, aux 0.0)."""
        cfg = self.cfg
        x = self.embed[tokens] * cfg.scale_emb
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        for layer in self.layers:
            x = layer(x, positions, impl, cfg)
        x = self.ln_f(x, cfg.norm_eps)
        if last_only:      # prefill: only the next-token logits are needed
            x = x[:, -1:]
        logits = (x @ self._w_out()).float()
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """{"kv": one `init_kv_cache` dict per layer}."""
        dev = self.embed.device
        return {"kv": [init_kv_cache(self.cfg, batch, max_len, _dt(self.cfg), dev)
                       for _ in self.layers]}

    def decode_step(self, tokens, cache: dict, pos: int):
        """tokens: [B, 1]; pos: the position. Returns (logits [B, V] f32,
        cache), the cache updated in place. As in the reference, the residual
        adds carry no `scale_depth` factor here."""
        cfg = self.cfg
        x = self.embed[tokens] * cfg.scale_emb
        for layer, lc in zip(self.layers, cache["kv"]):
            h, _ = attention_decode(layer.attn, layer.ln1(x, cfg.norm_eps), lc, pos)
            x = x + h
            x = x + layer.mlp(layer.ln2(x, cfg.norm_eps))
        x = self.ln_f(x, cfg.norm_eps)
        return (x[:, 0] @ self._w_out()).float(), cache

