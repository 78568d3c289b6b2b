"""Entry points of the distributed backend: run a generated per-rank body over a
1-D mesh of `torch.distributed` ranks on a partitioned graph.

SPMD, one process per shard, as under `mpirun` (the paper) or `torchrun`:
every rank builds the same graph and makes the same call.

    torch.distributed.init_process_group("nccl")     # torchrun's env
    mesh = dist.make_mesh_1d()                       # cuda:LOCAL_RANK
    prog = compile_bundled("sssp", backend="distributed")
    out  = prog.bind(g, mesh=mesh)(src=0)            # the local result dict

The collective backend follows the device: NCCL for a mesh on the card,
gloo for `device="cpu"`. Nothing here starts a process group, falls back
from one backend or device to another, or catches a collective's error.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as tdist

from ..graph.csr import CSRGraph
from . import runtime_dist as rtd

# the collective backend each device type runs on
BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh1D:
    """The 1-D mesh of the default process group: this process is shard
    `rank` of `size`, computing on `device`."""
    group: object
    size: int
    rank: int
    device: torch.device


def _backend_for(device_type: str, group) -> str:
    """The backend `group` runs collectives of `device_type` tensors on;
    `"cpu:gloo,cuda:nccl"`-style backend strings name one per device."""
    name = str(tdist.get_backend(group))
    if ":" not in name:
        return name
    per = dict(part.split(":", 1) for part in name.split(","))
    return per.get(device_type, "")


def make_mesh_1d(num_shards: int | None = None, *, device=None) -> Mesh1D:
    """A 1-D mesh over the initialized default process group.

    `device` defaults to `cuda:{LOCAL_RANK}` (the rank when LOCAL_RANK is
    unset). Raises when no process group is initialized, when
    `num_shards` is not the world size, when the card is asked for and
    absent, and when the group's backend does not serve the device (NCCL
    for the card, gloo for the CPU)."""
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(
            "make_mesh_1d needs an initialized default process group: start "
            "the ranks with torchrun and call torch.distributed."
            "init_process_group('nccl'), or init_process_group('gloo', ...) "
            "for a mesh on the CPU")
    group = tdist.group.WORLD
    size, rank = tdist.get_world_size(), tdist.get_rank()
    if num_shards is not None and num_shards != size:
        raise ValueError(f"make_mesh_1d({num_shards}): the process group has "
                         f"{size} ranks, one per shard")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh_1d: {dev} asked for, but no CUDA device is "
                           "available (a mesh on the CPU takes device='cpu' and gloo)")
    want = BACKEND_FOR.get(dev.type)
    have = _backend_for(dev.type, group)
    if want is None or have != want:
        raise ValueError(f"make_mesh_1d: a mesh on {dev.type} runs its collectives "
                         f"on {want}, but the process group's backend is "
                         f"{tdist.get_backend(group)!r}")
    return Mesh1D(group=group, size=size, rank=rank, device=dev)


def prepare(g: CSRGraph, mesh: Mesh1D, *, ell: bool = False) -> dict:
    """This rank's partitioned arrays of `g`, memoized in the graph's
    `GraphContext` (by shard count, rank and device)."""
    from .context import get_context
    return get_context(g).dist_arrays(mesh.size, ell=ell, rank=mesh.rank,
                                      device=mesh.device)


def run(prog, g: CSRGraph, mesh: Mesh1D, **params):
    """Partition `g`, run the generated body on every rank, return the
    global results (property arrays trimmed to the true vertex count).
    Equivalent to `prog.bind(g, mesh=mesh)(**params)`."""
    meta = prog.dist_meta or {}
    gd = prepare(g, mesh, ell=meta.get("needs_ell", False))
    return run_prepared(prog, gd, mesh, num_nodes=g.num_nodes, **params)


def run_prepared(prog, gd: dict, mesh: Mesh1D, *, num_nodes: int | None = None,
                 **params):
    """Run the generated body on already-prepared rank arrays over `mesh`.
    Each output property is all-gathered from its blocks on
    every rank ([N_pad], the reference's sharded output, whole) and trimmed to
    `num_nodes` when it is given; scalars are replicated as they are.

    The reference caches a jitted `shard_map` runner per program and
    parameter signature; eager torch has nothing to trace, so the body is
    called directly."""
    props = (prog.dist_meta or {}).get("out_props", ())
    kw = {n: v for n, v in params.items() if v is not None}
    out = prog.fn(gd, mesh, **kw)
    out = {k: (rtd.gather(v, mesh) if k in props else v) for k, v in out.items()}
    if num_nodes is not None:
        out = {k: (v[:num_nodes] if k in props else v) for k, v in out.items()}
    return out
