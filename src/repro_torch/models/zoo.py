"""Architecture zoo: uniform entry points keyed by config.

PyTorch counterpart of `repro.models.zoo`. The reference's `Model` pairs a
config with pure functions over a separate parameter tree; here the model
owns its parameters:

    model = zoo.build(cfg)                        # on the card, seeded init
    logits, aux = model({"tokens": tokens}, impl="kernel", last_only=True)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.decode_step(tokens, cache, pos)

The encdec family takes {"embeds": [B, S, d], "tokens": [B, S']}, its
`init_cache` an `enc_len` and its `decode_step` an `impl`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..graph.csr import resolve_device
from .encdec import EncDec
from .transformer import Transformer


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, net: Transformer | EncDec):
        super().__init__()
        self.cfg = cfg
        self.net = net

    @property
    def device(self) -> torch.device:
        return self.net.embed.device

    def forward(self, batch: dict, impl="ref", remat=True, last_only=False):
        """batch: {"tokens": [B, S]}, for encdec also "embeds". Returns
        (logits, aux)."""
        kw = dict(impl=impl, remat=remat, last_only=last_only)
        if self.cfg.family == "encdec":
            return self.net(batch["embeds"], batch["tokens"], **kw)
        return self.net(batch["tokens"], **kw)

    def init_cache(self, batch: int, max_len: int, **kw) -> dict:
        return self.net.init_cache(batch, max_len, **kw)

    def decode_step(self, tokens, cache: dict, pos: int, **kw):
        return self.net.decode_step(tokens, cache, pos, **kw)


def build(cfg: ModelConfig, device=None, *, seed: int = 0) -> Model:
    """The model of `cfg` on `device` (None: the card; without one it
    raises), its weights drawn from a `torch.Generator` on that device
    seeded with `seed`."""
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    net = EncDec if cfg.family == "encdec" else Transformer
    return Model(cfg, net(cfg, generator=generator))
