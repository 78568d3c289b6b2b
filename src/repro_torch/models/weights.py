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


def reference_path(name: str) -> tuple[str, int | None]:
    """A port parameter name → (the reference's key path, the layer index
    within its stack, or None): `layers.3.attn.wq` → (`layers/attn/wq`, 3)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def leaf_groups(names) -> dict:
    """reference key path → [(port name, layer index or None)], in the
    reference's flatten order (sorted paths), layers in index order. The
    one map between the two trees: the carry-over below, checkpoints,
    weight decay's rank and the sharding specs all go through it."""
    groups = {}
    for name in names:
        path, idx = reference_path(name)
        groups.setdefault(path, []).append((name, idx))
    return {p: sorted(groups[p], key=lambda x: x[1] or 0) for p in sorted(groups)}


def from_reference(arrays: dict, cfg, device=None) -> Model:
    """arrays: the reference's parameter tree as nested dicts of numpy
    arrays. Returns the port's model of `cfg` on `device` (None: the card)
    holding exactly those values. Raises if a leaf is missing on either
    side or has another shape or dtype."""
    model = build(cfg, device)
    params = dict(model.net.named_parameters())
    groups = leaf_groups(params)
    leaves = {name.replace(".", "/"): leaf for name, leaf in _flatten(arrays)}
    extra = sorted(set(leaves) - set(groups))
    if extra:
        raise KeyError(f"the port's model has no parameter for {extra}")
    missing = [n for p in groups if p not in leaves for n, _ in groups[p]]
    if missing:
        raise KeyError(f"the reference tree has no value for {missing}")
    with torch.no_grad():
        for path, members in groups.items():
            t = _tensor(leaves[path])
            stacked = members[0][1] is not None
            if stacked and t.shape[0] != len(members):
                raise ValueError(f"{path}: the reference stacks {t.shape[0]} layers, "
                                 f"the port has {len(members)}")
            for pname, idx in members:
                val, p = (t[idx] if stacked else t), params[pname]
                if tuple(p.shape) != tuple(val.shape) or p.dtype != val.dtype:
                    raise ValueError(f"{pname}: reference {tuple(val.shape)} {val.dtype}, "
                                     f"port {tuple(p.shape)} {p.dtype}")
                p.copy_(val)
    return model
