"""Entry points of the distributed backend: run a generated per-rank body over a
1-D mesh of `torch.distributed` ranks on a partitioned graph.

SPMD, one process per shard, as under `mpirun` (the paper) or `torchrun`:
every rank builds the same graph and makes the same call.

    torch.distributed.init_process_group("nccl")     # torchrun's env
    mesh = dist.make_mesh_1d()                       # cuda:LOCAL_RANK
    prog = compile_bundled("sssp", backend="distributed")
    out  = prog.bind(g, mesh=mesh)(src=0)            # the local result dict

A mesh of named axes (`make_mesh`, the counterpart of `jax.make_mesh`)
lays the ranks out row-major over sub-groups: the 2-D grid of
`core.dist2d` takes axes ("data", "model"), `run_pod_parallel` takes
("pod", "data") and runs the 1-D body over each pod's "data" axis.

The collective backend follows the device: NCCL for a mesh on the card,
gloo for `device="cpu"`. Nothing here starts a process group, falls back
from one backend or device to another, or catches a collective's error.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as tdist

from ..graph.csr import CSRGraph
from . import runtime_dist as rtd

# the collective backend each device type runs on
# the meta device is the dry run's (`launch.dryrun`): an in-process fake
# process group whose collectives move nothing
BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


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


def _world(who: str, device):
    """The default group, its size, this rank and the mesh device, after
    the checks every mesh makes: a group is initialized, the card asked
    for is there, and the group's backend serves the device."""
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(
            f"{who} needs an initialized default process group: start "
            "the ranks with torchrun and call torch.distributed."
            "init_process_group('nccl'), or init_process_group('gloo', ...) "
            "for a mesh on the CPU")
    group = tdist.group.WORLD
    size, rank = tdist.get_world_size(), tdist.get_rank()
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: {dev} asked for, but no CUDA device is "
                           "available (a mesh on the CPU takes device='cpu' and gloo)")
    want = BACKEND_FOR.get(dev.type)
    have = _backend_for(dev.type, group)
    if want is None or have != want:
        raise ValueError(f"{who}: a mesh on {dev.type} runs its collectives "
                         f"on {want}, but the process group's backend is "
                         f"{tdist.get_backend(group)!r}")
    return group, size, rank, dev


def make_mesh_1d(num_shards: int | None = None, *, device=None) -> Mesh1D:
    """A 1-D mesh over the initialized default process group.

    `device` defaults to `cuda:{LOCAL_RANK}` (the rank when LOCAL_RANK is
    unset). Raises when no process group is initialized, when
    `num_shards` is not the world size, when the card is asked for and
    absent, and when the group's backend does not serve the device (NCCL
    for the card, gloo for the CPU)."""
    group, size, rank, dev = _world("make_mesh_1d", device)
    if num_shards is not None and num_shards != size:
        raise ValueError(f"make_mesh_1d({num_shards}): the process group has "
                         f"{size} ranks, one per shard")
    return Mesh1D(group=group, size=size, rank=rank, device=dev)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of named axes over the default process group (the counterpart
    of a `jax.make_mesh` mesh): `shape` maps each axis name to its size, in
    order; this process is `rank` of the world, computing on `device`.
    `axis(name)` is the 1-D mesh of this rank's sub-group along that axis."""
    shape: dict
    rank: int
    device: torch.device
    axes: dict

    def axis(self, name: str) -> Mesh1D:
        return self.axes[name]


def make_mesh(shape, names, *, device=None) -> Mesh:
    """A mesh of `shape` with axes `names` over the initialized default
    process group, ranks laid out row-major as `jax.make_mesh` lays out
    devices: rank r sits at the coordinates `np.unravel_index(r, shape)`.
    The sub-group of an axis holds the ranks that differ only in that
    coordinate, in the order of that coordinate (for a 2-D grid
    ("data", "model") of R×C, the "data" group of column j is
    {i·C + j : i} in i order). Every rank creates every sub-group, in the
    same order. Raises as `make_mesh_1d` does, and when the shape's
    product is not the world size."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"make_mesh({shape}, {names}): one distinct name per axis")
    _, size, rank, dev = _world("make_mesh", device)
    if math.prod(shape) != size:
        raise ValueError(f"make_mesh({shape}, {names}): the process group has "
                         f"{size} ranks, the shape {math.prod(shape)}")
    ranks = np.arange(size).reshape(shape)
    axes = {}
    for a, name in enumerate(names):
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        mine, _ = tdist.new_subgroups_by_enumeration(lines.tolist())
        axes[name] = Mesh1D(group=mine, size=shape[a], rank=int(np.unravel_index(
            rank, shape)[a]), device=dev)
    return Mesh(shape=dict(zip(names, shape)), rank=rank, device=dev, axes=axes)


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


def run_pod_parallel(prog, g: CSRGraph, mesh: Mesh, source_set, **params):
    """Source-parallel run over the "pod" axis of a ("pod", "data") mesh
    (multi-pod BC): every pod holds the same 1-D partition over its "data"
    axis and runs the generated body there for its slice of `source_set`
    (pod p takes sources [p·k, (p+1)·k), the reference's `P("pod")`
    split); the output properties and `_gather_elems` are summed over the
    "pod" sub-group, the other scalars returned as they are. Inter-pod
    traffic is that one sum. Properties are trimmed to the true vertex
    count, as `run` trims them."""
    data, pod = mesh.axis("data"), mesh.axis("pod")
    meta = prog.dist_meta or {}
    gd = prepare(g, data, ell=meta.get("needs_ell", False))
    srcs = np.asarray(source_set, np.int32)
    if len(srcs) % pod.size:
        raise ValueError("source set must divide the pod count for now")
    per_pod = len(srcs) // pod.size
    set_param = next(p.name for p in prog.ir.params if p.kind == "set_n")
    kw = {n: v for n, v in params.items() if v is not None and n != set_param}
    kw[set_param] = srcs[pod.rank * per_pod:(pod.rank + 1) * per_pod]
    props = meta.get("out_props", ())
    out = prog.fn(gd, data, **kw)
    summed = set(props) | {"_gather_elems"}
    out = {k: (rtd.psum(v, pod) if k in summed else v) for k, v in out.items()}
    return {k: (rtd.gather(v, data)[: g.num_nodes] if k in props else v)
            for k, v in out.items()}


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
