"""Production mesh construction.

PyTorch counterpart of `repro.launch.mesh`. A function, not a module
constant: importing this module touches no process group.
"""
from __future__ import annotations

from ..core import dist


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16×16 ("data", "model") pod, or 2×16×16 ("pod", "data",
    "model"), over the initialized default process group (`dist.make_mesh`,
    ranks laid out as `jax.make_mesh` lays out devices). Raises unless the
    world has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dist.make_mesh(shape, axes, device=device)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over (pure DP on 'pod' + FSDP 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def effective_batch_axes(mesh, global_batch: int) -> tuple:
    """Largest prefix of the batch axes whose product divides the batch —
    batch=1 long-context decode replicates instead of failing to tile."""
    axes = []
    prod = 1
    for a in batch_axes(mesh):
        if global_batch % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    return tuple(axes)
