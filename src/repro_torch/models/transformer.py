"""Model assembly: decoder-only LM (dense / MoE / hybrid / xLSTM stacks).

PyTorch counterpart of `repro.models.transformer`:

    net = Transformer(cfg, generator=...)          the reference's init(key, cfg)
    logits, aux = net(tokens, impl=..., last_only=...)   prefill / training path
    cache = net.init_cache(batch, max_len)
    logits, cache = net.decode_step(tokens, cache, pos)

The reference's `jax.lax.scan` over `[L]`-stacked layer parameters becomes
an `nn.ModuleList` walked in Python. Hybrid stacks (zamba2) run the Mamba
backbone and apply the ONE shared attention block after every
`attn_every`-th layer, each call site with its own KV cache. xLSTM stacks
run every mLSTM layer, then every sLSTM layer, as the reference does.
With `remat` (the default) and grad enabled, each layer body (a hybrid
layer with its shared-attention call, an mLSTM layer; not the sLSTM
blocks, as in the reference) runs under `layers.remat_call`: its
activations are recomputed in the backward pass instead of kept, the
reference's `jax.checkpoint` on its scan body. Serving runs under
`inference_mode`, where it has no effect.

`set_constraint_mesh(layout)` installs a layout's split plan on a model
whose parameters hold this rank's blocks (`launch.sharding.place` does
it): the counterpart of the reference's `set_constraint_mesh` and of its
constraint pinning the logits vocab-split. The forward then runs the
embedding, each layer (its heads, its ff columns or its experts and
shared-expert columns; a Mamba2 or mLSTM layer its heads, an sLSTM layer
its channels; the hybrid's shared attention block at each call site)
and the logits through the plan (each layer's gathers inside its remat
body, so the recompute gathers again) and returns the logits of the
rank's vocab block, or with `last_only` the whole last-token logits
gathered over "model". `init_cache` then allocates the rank's block of
the KV cache and of the recurrent states, and `decode_step` runs the plan
too. Under the plan's sequence split (`REPRO_ATTN_SHARD=seq`) each
attention layer of the forward (the shared attention block's too) runs
the rank's rows of the sequence with every head instead of its heads
(`models.attention.seq_attention`); decode keeps the heads.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, attention_decode, init_kv_cache, split_attention_decode
from .layers import MLP, RMSNorm, dense_init, embed_init, remat_call
from .moe import MoE
from .ssm import (MLSTM, SLSTM, Mamba2, mamba2_decode, mamba2_init_state, mlstm_decode,
                  mlstm_init_state, slstm_decode, slstm_init_state)

FAMILIES = ("dense", "moe", "hybrid", "ssm")


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DenseLayer(nn.Module):
    """ln1, attn, ln2 and the FFN: `moe` in the moe family, `mlp` else."""

    def __init__(self, cfg, dtype, *, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = RMSNorm(cfg.d_model, dtype, dev)
        self.attn = Attention(cfg, dtype, generator=generator)
        self.ln2 = RMSNorm(cfg.d_model, dtype, dev)
        if cfg.family == "moe":
            self.moe = MoE(cfg, dtype, generator=generator)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, generator=generator)

    def ffn(self, x, cfg, plan=None):
        """The FFN and its aux loss (0.0 without experts); with `plan` the
        rank's ff columns, or its experts and shared-expert columns."""
        if cfg.family == "moe":
            return self.moe(x, cfg, plan)
        return self.mlp(x, plan), 0.0

    def forward(self, x, positions, impl, cfg, plan=None):
        """Returns (x after the layer, the FFN's aux loss); with `plan` the
        rank's heads and ff columns run through it, the layer's weights
        gathered over "data" first (`SplitPlan.gather_layer`)."""
        if plan is not None:
            plan = plan.gather_layer(self)
        scale = cfg.scale_depth / (cfg.n_layers ** 0.5) if cfg.scale_depth else 1.0
        h = self.attn(self.ln1(x, cfg.norm_eps), positions, causal=True, impl=impl, plan=plan)
        x = x + h * scale
        h, aux = self.ffn(self.ln2(x, cfg.norm_eps), cfg, plan)
        return x + h * scale, aux

    def decode(self, x, lc, pos, cfg, plan=None):
        """One token through the layer, its KV cache `lc` written in place.
        As in the reference, the residual adds carry no `scale_depth`.
        With `plan`: the layer's weights gathered over "data" first, then
        the rank's heads over its block of the cache
        (`split_attention_decode`) and its ff columns."""
        if plan is None:
            h, _ = attention_decode(self.attn, self.ln1(x, cfg.norm_eps), lc, pos)
        else:
            plan = plan.gather_layer(self)
            h, _ = split_attention_decode(self.attn, self.ln1(x, cfg.norm_eps), lc, pos, plan)
        x = x + h
        h, _ = self.ffn(self.ln2(x, cfg.norm_eps), cfg, plan)
        return x + h


def _n_slstm(cfg) -> int:
    return cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0


def _attn_sites(cfg) -> list[int]:
    """The hybrid layers after which the shared attention block runs."""
    every = cfg.attn_every or (cfg.n_layers + 1)
    return [i for i in range(cfg.n_layers) if i % every == every - 1]


class Transformer(nn.Module):
    """embed [V, d], ln_f, unembed [d, V] unless the embeddings are tied,
    and the family's stack:
      dense, moe — layers (ModuleList of DenseLayer);
      hybrid     — layers (ModuleList of Mamba2) and shared_attn (a DenseLayer);
      ssm        — mlstm (ModuleList of MLSTM) and slstm (ModuleList of SLSTM).
    The parameters land on the generator's device."""

    plan = None        # the installed split plan (`set_constraint_mesh`)

    def __init__(self, cfg, *, generator: torch.Generator):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: Transformer builds the families {FAMILIES}, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        dtype = _dt(cfg)
        g = generator
        self.embed = nn.Parameter(embed_init(cfg.vocab_padded, cfg.d_model, dtype, generator=g))
        self.ln_f = RMSNorm(cfg.d_model, dtype, g.device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(dense_init((cfg.d_model, cfg.vocab_padded), dtype,
                                                   generator=g))
        if cfg.family in ("dense", "moe"):
            self.layers = nn.ModuleList(DenseLayer(cfg, dtype, generator=g)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":       # zamba2: mamba backbone + shared attn
            self.layers = nn.ModuleList(Mamba2(cfg, dtype, generator=g)
                                        for _ in range(cfg.n_layers))
            self.shared_attn = DenseLayer(cfg, dtype, generator=g)
        else:                              # xlstm: mLSTM stack + sLSTM blocks
            n_s = _n_slstm(cfg)
            self.mlstm = nn.ModuleList(MLSTM(cfg, dtype, generator=g)
                                       for _ in range(cfg.n_layers - n_s))
            self.slstm = nn.ModuleList(SLSTM(cfg, dtype, generator=g) for _ in range(n_s))

    def _w_out(self):
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def set_constraint_mesh(self, layout):
        """Installs the split plan of `layout` (a `launch.sharding.Layout`
        whose blocks the parameters hold) on this model; None removes it.
        The reference's `set_constraint_mesh`, per model."""
        if layout is None:
            self.plan = None
            return
        self.plan = layout.split_plan(self.cfg, dict(self.named_parameters()))

    def forward(self, tokens, *, impl="ref", remat: bool = True, last_only: bool = False):
        """tokens: [B, S] integer. Returns (logits [B, S, V] f32 — [B, 1, V]
        with last_only —, aux: the MoE layers' summed load-balance loss, a
        0-d f32 tensor, 0 for the other families). Under a split plan the
        logits are those of the rank's vocab block [B, S, V / m], and
        [B, 1, V] whole with last_only."""
        cfg, plan = self.cfg, self.plan
        x = (self.embed[tokens] if plan is None else plan.embed(self.embed, tokens)) \
            * cfg.scale_emb
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "moe"):
            for layer in self.layers:
                x, a = remat_call(remat, layer, x, positions, impl, cfg, plan)
                aux = aux + a
        elif cfg.family == "hybrid":
            sites = set(_attn_sites(cfg))

            def body(x, layer, attn):
                x = x + layer(x, cfg, plan=plan)
                if attn:
                    x, _ = self.shared_attn(x, positions, impl, cfg, plan)
                return x
            for i, layer in enumerate(self.layers):
                x = remat_call(remat, body, x, layer, i in sites)
        else:
            for layer in self.mlstm:
                x = remat_call(remat, lambda x, layer: x + layer(x, cfg, plan=plan), x, layer)
            for layer in self.slstm:
                x = x + layer(x, cfg, plan=plan)
        x = self.ln_f(x, cfg.norm_eps)
        if last_only:      # prefill: only the next-token logits are needed
            x = x[:, -1:]
        if plan is None:
            return (x @ self._w_out()).float(), aux
        logits = plan.logits(x, self)
        return (plan.gather_vocab(logits) if last_only else logits), aux

    def init_cache(self, batch: int, max_len: int) -> dict:
        """dense, moe: {"kv": one `init_kv_cache` dict per layer};
        hybrid: {"ssm": one Mamba2 state per layer, "kv": one KV cache per
        shared-attention call site (at least one)};
        ssm: {"mlstm": one state per mLSTM layer, "slstm": one (c, n, m)
        state per sLSTM layer}. Under a split plan `batch` is the rank's
        rows, each KV cache holds the rank's slots of `max_len`
        (`SplitPlan.cache_slots`) and records `max_len`, and each
        recurrent state the rank's heads (Mamba2: h, and conv's x
        channels beside B and C; mLSTM: h) or channels (sLSTM)."""
        cfg, dev, dtype, plan = self.cfg, self.embed.device, _dt(self.cfg), self.plan

        def count(group):        # the rank's heads or channels of a recurrent group
            if plan is None:
                return None
            lo, hi = getattr(plan, group)
            return hi - lo

        def kv(n):
            if self.plan is not None:
                lo, hi = self.plan.cache_slots(max_len)
                return [dict(init_kv_cache(cfg, batch, hi - lo, dtype, dev), max_len=max_len)
                        for _ in range(n)]
            return [init_kv_cache(cfg, batch, max_len, dtype, dev) for _ in range(n)]

        if cfg.family in ("dense", "moe"):
            return {"kv": kv(cfg.n_layers)}
        if cfg.family == "hybrid":
            return {"ssm": [mamba2_init_state(cfg, batch, dtype, dev, count("mamba_heads"))
                            for _ in self.layers],
                    "kv": kv(max(len(_attn_sites(cfg)), 1))}
        return {"mlstm": [mlstm_init_state(cfg, batch, dev, count("mlstm_heads"))
                          for _ in self.mlstm],
                "slstm": [slstm_init_state(cfg, batch, dev, count("channels"))
                          for _ in self.slstm]}

    def decode_step(self, tokens, cache: dict, pos: int):
        """tokens: [B, 1]; pos: the position. Returns (logits [B, V] f32,
        cache), the cache updated in place. Under a split plan tokens are
        the rank's rows and the cache its block (`init_cache` with the
        plan installed): the embedding, each layer (the hybrid's shared
        attention block at each call site) and the logits run through the
        plan, and the logits come back whole, equal on every rank of
        "model"."""
        cfg, plan = self.cfg, self.plan
        x = (self.embed[tokens] if plan is None else plan.embed(self.embed, tokens)) \
            * cfg.scale_emb
        if cfg.family in ("dense", "moe"):
            for layer, lc in zip(self.layers, cache["kv"]):
                x = layer.decode(x, lc, pos, cfg, plan)
        elif cfg.family == "hybrid":
            sites = _attn_sites(cfg)
            for i, layer in enumerate(self.layers):
                h, cache["ssm"][i] = mamba2_decode(layer, cfg, x, cache["ssm"][i], plan)
                x = x + h
                if i in sites:
                    x = self.shared_attn.decode(x, cache["kv"][sites.index(i)], pos, cfg, plan)
        else:
            for i, layer in enumerate(self.mlstm):
                h, cache["mlstm"][i] = mlstm_decode(layer, cfg, x, cache["mlstm"][i], plan)
                x = x + h
            for i, layer in enumerate(self.slstm):
                h, cache["slstm"][i] = slstm_decode(layer, cfg, x, cache["slstm"][i], plan)
                x = x + h
        x = self.ln_f(x, cfg.norm_eps)
        if plan is not None:
            return plan.gather_vocab(plan.logits(x, self))[:, 0], cache
        return (x[:, 0] @ self._w_out()).float(), cache
