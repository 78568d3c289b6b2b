"""Architecture zoo: uniform entry points keyed by config.

PyTorch counterpart of `repro.models.zoo`. The reference's `Model` pairs a
config with pure functions over a separate parameter tree; here the model
owns its parameters:

    model = zoo.build(cfg)                        # on the card, seeded init
    logits, aux = model({"tokens": tokens}, impl="kernel", last_only=True)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.decode_step(tokens, cache, pos)
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..graph.csr import resolve_device
from .transformer import Transformer


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, net: Transformer):
        super().__init__()
        self.cfg = cfg
        self.net = net

    @property
    def device(self) -> torch.device:
        return self.net.embed.device

    def forward(self, batch: dict, impl="ref", remat=True, last_only=False):
        """batch: {"tokens": [B, S]}. Returns (logits, aux)."""
        return self.net(batch["tokens"], impl=impl, remat=remat, last_only=last_only)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return self.net.init_cache(batch, max_len)

    def decode_step(self, tokens, cache: dict, pos: int):
        return self.net.decode_step(tokens, cache, pos)


def build(cfg: ModelConfig, device=None, *, seed: int = 0) -> Model:
    """The model of `cfg` on `device` (None: the card; without one it
    raises), its weights drawn from a `torch.Generator` on that device
    seeded with `seed`. The families other than dense are not ported yet."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the 'encdec' family is not ported yet "
            "(ROADMAP queue 1, item 12: LM substrate)")
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    return Model(cfg, Transformer(cfg, generator=generator))
