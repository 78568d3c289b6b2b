"""Carry a parameter tree of the JAX reference over into the port's model.

The reference keeps its parameters as nested dicts of arrays, with the
per-layer leaves of each layer stack stacked along a leading `[L]` axis
(`STACKED`; the hybrid family's `shared_attn` is one layer, unstacked);
the port keeps the same `[in, out]` weight layout, so each leaf is a copy.
Used by the parity tests; nothing on the card's path needs it.
"""
from __future__ import annotations

import numpy as np
import torch

from .zoo import Model, build

# the reference's layer stacks: groups whose leaves carry a leading [L] axis
STACKED = ("layers", "mlstm", "slstm", "enc_layers", "dec_layers")


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                  # a writable copy
    if a.dtype.name == "bfloat16":   # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(arrays: dict, cfg, device=None) -> Model:
    """arrays: the reference's parameter tree as nested dicts of numpy
    arrays. Returns the port's model of `cfg` on `device` (None: the card)
    holding exactly those values. Raises if a leaf is missing on either
    side or has another shape or dtype."""
    model = build(cfg, device)
    params = dict(model.net.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, leaf in _flatten(arrays):
            t = _tensor(leaf)
            group, _, rest = name.partition(".")
            if group in STACKED:
                targets = [(f"{group}.{i}.{rest}", t[i]) for i in range(t.shape[0])]
            else:
                targets = [(name, t)]
            for pname, val in targets:
                if pname not in params:
                    raise KeyError(f"the port's model has no parameter {pname!r}")
                p = params[pname]
                if tuple(p.shape) != tuple(val.shape) or p.dtype != val.dtype:
                    raise ValueError(f"{pname}: reference {tuple(val.shape)} {val.dtype}, "
                                     f"port {tuple(p.shape)} {p.dtype}")
                p.copy_(val)
                seen.add(pname)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"the reference tree has no value for {missing}")
    return model
