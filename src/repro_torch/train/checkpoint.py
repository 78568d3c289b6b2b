"""Checkpoint save/restore with fault-tolerance semantics, in the
reference's own format.

PyTorch counterpart of `repro.train.checkpoint`:

  * atomic: write to <dir>/tmp-<step>, fsync the manifest, rename to
    <dir>/step-<step> (a crash mid-save never corrupts the latest one);
  * retention: keep the newest `keep` checkpoints;
  * elastic restore: leaves are read as host numpy and placed by the
    *target* layout, so restoring onto another mesh or device count is the
    same code path;
  * resume: `latest_step(dir)` and the stateless data pipeline
    (train/data.py) make a restart a load and a continue.

The files are the reference's: `arrays.npz` and `manifest.json`, with the
keys a reference `TrainState` flattens to (`.params/embed`,
`.params/layers/attn/wq`, `.opt/m/layers/attn/wq`, `.opt/step`, ...).
The port's per-layer parameters are stacked to the reference's [L, ...]
leaves on save and split on restore, and bf16 is stored as f32, so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from ..models.weights import leaf_groups


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:        # numpy has no bfloat16: store as f32
        t = t.float()
    return t.cpu().numpy()


def _flatten(state, *, keep: bool = True) -> dict:
    """The state as the reference's {key: numpy array}. For a sharded
    state every rank gathers every leaf (a collective per leaf); only a
    rank that `keep`s them copies them to the host."""
    lay = state.layout
    whole = (lambda n, t: lay.gather(n, t)) if lay is not None else (lambda n, t: t)
    params = state.params
    out = {}

    def put(prefix, tensors):
        for path, members in leaf_groups(tensors).items():
            arrs = [whole(n, tensors[n]) for n, _ in members]
            if keep:
                arrs = [_host(t) for t in arrs]
                out[prefix + path] = np.stack(arrs) if members[0][1] is not None else arrs[0]

    put(".params/", params)
    put(".opt/m/", state.opt["m"])
    out[".opt/step"] = np.asarray(int(state.opt["step"]), np.int32)
    put(".opt/v/", state.opt["v"])
    return out


def save(ckpt_dir: str, step: int, state, *, keep: int = 3) -> str:
    """Writes `state` as step `step`. A sharded state is gathered on every
    rank and written by rank 0; every rank returns once it is published."""
    lay = state.layout
    writer = lay is None or lay.mesh.rank == 0
    flat = _flatten(state, keep=writer)
    final = os.path.join(ckpt_dir, f"step-{step}")
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"tmp-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step,
                    "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                               for k, v in flat.items()}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        _gc(ckpt_dir, keep)
    if lay is not None:
        lay.barrier()
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for d in os.listdir(ckpt_dir)
            if (m := re.fullmatch(r"step-(\d+)", d))]


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like, *, shardings=None):
    """Restores step `step` into the train state `like` (its model's
    parameters and its optimizer state, replaced in place) and returns it.
    With `shardings` (a `launch.sharding.Layout`) each rank keeps only its
    block of every leaf and the state carries that layout: the elastic
    re-mesh path. Without, every leaf is whole. Raises on a missing key or
    a shape that is not the model's."""
    params = like.params
    lay = like.layout
    shapes = {n: lay.full_shape(n, p) if lay is not None else tuple(p.shape)
              for n, p in params.items()}

    def place(name, arr, dtype, device):
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        if shardings is not None:
            t = shardings.block(name, t)
        return t.to(device)

    def load(prefix, names, dtype_of, device_of, assign):
        for path, members in leaf_groups(names).items():
            key = prefix + path
            if key not in arrays:
                raise KeyError(f"checkpoint {ckpt_dir}/step-{step} has no leaf {key!r}")
            arr = arrays[key]
            stacked = members[0][1] is not None
            want = ((len(members),) if stacked else ()) + shapes[members[0][0]]
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint/model shape mismatch at {key}: "
                                 f"{tuple(arr.shape)} vs {want}")
            for name, idx in members:
                assign(name, place(name, arr[idx] if stacked else arr, dtype_of(name),
                                   device_of(name)))

    def set_param(name, t):
        params[name].data = t

    with np.load(os.path.join(ckpt_dir, f"step-{step}", "arrays.npz")) as arrays:
        load(".params/", params, lambda n: params[n].dtype, lambda n: params[n].device,
             set_param)
        for group in ("m", "v"):
            load(f".opt/{group}/", params, lambda n: torch.float32,
                 lambda n: params[n].device, like.opt[group].__setitem__)
        like.opt["step"] = torch.as_tensor(arrays[".opt/step"].astype(np.int32),
                                           device=like.opt["step"].device)
    like.layout = shardings
    return like
