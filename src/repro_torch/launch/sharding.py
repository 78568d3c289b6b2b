"""Sharding rules (parameter / optimizer / batch / cache specs) and the
placement of a train state on a mesh.

PyTorch counterpart of `repro.launch.sharding`. The rules are the
reference's, computed on its key paths and stacked shapes, so they give
its specs leaf for leaf (a per-layer tensor of the port drops the leading
None of the reference's [L] axis):

  * FSDP: every matrix shards its d_model-sided dim over 'data' (ZeRO:
    m and v mirror the params, so they shard the same way);
  * TP: head/ff/expert/vocab dims shard over 'model';
  * KV caches shard batch over 'data' and sequence over 'model';
  * batches shard over ('pod', 'data');
  * an axis whose size does not divide its dim degrades to replication.

A spec is a `P`: one entry per dim, each None, an axis name or a tuple of
names (the dim splits over their product, row-major). `named(mesh,
specs, batch_axes)` gives the `Layout` that `place` puts a train state on,
the counterpart of `jax.device_put(state, named(mesh, specs))`: each rank
then holds only its block of every sharded parameter, of m and of v, and
replicated leaves whole. The train step gathers the whole parameters over
the axes that split them, runs this rank's rows of the batch,
reduce-scatters each gradient into this rank's block (`reduce_grads`) and
updates its blocks: hand-written collectives over the mesh's per-axis
sub-groups. The gather is of the whole model, not one layer at a time, so
a rank's peak holds every parameter and every gradient whole (ROADMAP,
performance items). Compute is split over
the batch axes only; the reference's GSPMD also splits it over "model",
where the port gathers the weights instead (ROADMAP, performance items).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as tdist

from ..models.weights import STACKED, leaf_groups

# param dims that shard over ('data' side, 'model' side)
_IN_OUT = {"wq", "wk", "wv", "wz", "wi", "wf", "wo_gate", "in_proj",
           "w_gate", "w_up"}            # [d, X] → P(data, model)
_OUT_IN = {"wo", "out", "out_proj", "w_down"}   # [X, d] → P(model, data)
_STACKED = set(STACKED)
_REDUCE_SCATTER = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor


class P(tuple):
    """A partition spec: one entry per dim (None, an axis name, or a tuple
    of axis names). As jax's PartitionSpec, a tuple of one name is that
    name and an empty tuple is None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(axes, axis_sizes):
    n = 1
    for a in _axes(axes):
        n *= axis_sizes.get(a, 1)
    return n


def _guard(spec_entries, shape, axis_sizes):
    """Keep an axis only when its size divides the dim (e.g. 4 gate heads on
    a 16-way model axis → replicate instead of failing to tile)."""
    return [ax if _axis_size(ax, axis_sizes) <= 1
            or dim % _axis_size(ax, axis_sizes) == 0 else None
            for dim, ax in zip(shape, spec_entries)]


def _param_rule(path_keys, shape, axis_sizes):
    name = path_keys[-1]
    rank = len(shape)
    stacked = path_keys[0] in _STACKED
    base = rank - 1 if stacked else rank

    def wrap(*spec):
        spec = tuple(spec) + (None,) * (base - len(spec))
        spec = (((None,) if stacked else ()) + spec)
        return P(*_guard(spec, shape, axis_sizes))

    if name == "embed":
        return wrap("model", "data")
    if name == "unembed":
        return wrap("data", "model")
    if name == "router":
        return wrap("data", None)
    if name == "conv_w":
        return wrap(None, "model")
    if base == 3 and name in ("w_gate", "w_up"):    # MoE experts [E, d, ff]
        return wrap("model", "data", None)
    if base == 3 and name == "w_down":              # [E, ff, d]
        return wrap("model", None, "data")
    if base == 2 and name in _IN_OUT:
        return wrap("data", "model")
    if base == 2 and name in _OUT_IN:
        return wrap("model", "data")
    return wrap()          # biases, norms, gates: replicated


DEFAULT_AXES = {"pod": 2, "data": 16, "model": 16}


def param_specs(params, axis_sizes=None) -> dict:
    """name → P for a parameter dict (name → tensor, e.g. a model built on
    the meta device, or name → shape). A member of a layer stack gets the
    reference's spec of the stacked leaf without its leading [L] entry."""
    axis_sizes = axis_sizes or DEFAULT_AXES
    shapes = {n: tuple(getattr(t, "shape", t)) for n, t in params.items()}
    out = {}
    for path, members in leaf_groups(shapes).items():
        stacked = members[0][1] is not None
        shape = shapes[members[0][0]]
        spec = _param_rule(path.split("/"), ((len(members),) if stacked else ()) + shape,
                           axis_sizes)
        for name, _ in members:
            out[name] = P(*spec[1:]) if stacked else spec
    return out


def opt_specs(opt, pspecs) -> dict:
    """Optimizer m/v mirror params; step is replicated."""
    return {"m": pspecs, "v": pspecs, "step": P()}


def state_specs(state, axis_sizes=None) -> dict:
    """{"params": name → P, "opt": `opt_specs`} of a train state."""
    pspecs = param_specs(state.params, axis_sizes)
    return {"params": pspecs, "opt": opt_specs(state.opt, pspecs)}


def batch_specs(batch, baxes) -> dict:
    """Token batches shard the leading (batch) dim over pod+data."""
    b = baxes if baxes else None
    return {k: P(b, *([None] * (x.ndim - 1))) for k, x in batch.items()}


def _cache_rule(name, shape, b, axis_sizes):
    """The reference's rule for a cache leaf of its (stacked) `shape`."""
    ndim = len(shape)
    if name in ("k", "v") and ndim == 5:        # stacked kv cache
        spec = (None, b, "model", None, None)
    elif name in ("k", "v") and ndim == 4:
        spec = (b, "model", None, None)
    elif name == "enc_out":
        spec = (b, "model", None)
    elif name == "h" and ndim == 5:             # stacked ssm state
        spec = (None, b, "model", None, None)
    elif name == "conv" and ndim == 4:
        spec = (None, b, None, "model")
    elif name in ("m", "n") and ndim >= 3:
        spec = (None, b) + (None,) * (ndim - 2)
    else:
        spec = (None,) * ndim
    return P(*_guard(spec, shape, axis_sizes))


def cache_specs(cache, baxes, axis_sizes=None):
    """The spec of every tensor of a decode cache (`model.init_cache(...)`),
    in the cache's own structure. The port keeps one cache per layer in a
    list where the reference stacks them along a leading [L] axis: a leaf
    in a list gets the rule of the stacked leaf without its leading entry.
    Non-tensor leaves (a cache's `length`) are left out."""
    axis_sizes = axis_sizes or DEFAULT_AXES
    b = baxes if baxes else None

    def walk(node, name, stacked):
        if isinstance(node, dict):
            return {k: walk(v, k, stacked) for k, v in node.items()
                    if isinstance(v, (dict, list, torch.Tensor))}
        if isinstance(node, list):
            return [walk(v, name, True) for v in node]
        # every rule leaves the [L] entry None, so its length does not matter
        shape = ((1,) if stacked else ()) + tuple(node.shape)
        spec = _cache_rule(name, shape, b, axis_sizes)
        return P(*spec[1:]) if stacked else spec

    return walk(cache, None, False)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

class Layout:
    """Where each leaf of a train state lives on `mesh` (a `dist.Mesh`):
    `specs` maps a parameter name to its P (m and v share it), and
    `batch_axes` are the axes the batch's rows split over. A dim whose
    entry names axes (a, b, ...) splits into their product of equal
    blocks, row-major over those axes, as a jax NamedSharding lays it out."""

    def __init__(self, mesh, specs: dict, batch_axes=()):
        self.mesh = mesh
        self.specs = specs
        self.batch_axes = tuple(batch_axes)

    def _split(self, name):
        """[(dim, axes)] for every dim of `name` split over more than one rank."""
        return [(i, _axes(e)) for i, e in enumerate(self.specs[name])
                if _axis_size(e, self.mesh.shape) > 1]

    def full_shape(self, name, block) -> tuple:
        shape = list(block.shape)
        for i, axes in self._split(name):
            shape[i] *= _axis_size(axes, self.mesh.shape)
        return tuple(shape)

    def block(self, name, t):
        """This rank's block of the whole tensor `t` (a contiguous copy; `t`
        itself where nothing splits it)."""
        split = self._split(name)
        for i, axes in split:
            n, idx = 1, 0
            for a in axes:                       # row-major block index
                size = self.mesh.shape[a]
                n, idx = n * size, idx * size + self.mesh.axis(a).rank
            step = t.shape[i] // n
            t = t.narrow(i, idx * step, step)
        return t.contiguous().clone() if split else t

    def gather(self, name, block):
        """The whole tensor from every rank's block: an all-gather over each
        axis that splits it, innermost axis first."""
        t = block
        for i, axes in self._split(name):
            for a in reversed(axes):
                ax = self.mesh.axis(a)
                if ax.size == 1:
                    continue
                parts = [torch.empty_like(t) for _ in range(ax.size)]
                tdist.all_gather(parts, t.contiguous(), group=ax.group)
                t = torch.cat(parts, dim=i)
        return t

    def gather_params(self, params: dict):
        """Each parameter's data becomes the whole tensor (the step's compute)."""
        with torch.no_grad():
            for name, p in params.items():
                p.data = self.gather(name, p.data)

    def shard_params(self, params: dict):
        """Each parameter's data becomes this rank's block (between steps)."""
        with torch.no_grad():
            for name, p in params.items():
                p.data = self.block(name, p.data)

    def _batch_sum(self, t):
        for a in self.batch_axes:
            ax = self.mesh.axis(a)
            if ax.size > 1:
                tdist.all_reduce(t, group=ax.group)
        return t

    @property
    def batch_shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    def reduce_grads(self, grads: dict) -> dict:
        """This rank's block of each gradient of the global batch's mean
        loss, in f32, from each rank's whole gradient of the mean over its
        rows. Over an axis that splits the leaf the gradient is cut to its
        block: reduce-scattered over a batch axis (the sum of the ranks'
        rows), narrowed over any other (whose ranks ran the same rows). It
        is then summed over the batch axes that do not split the leaf and
        divided by the batch's shard count. `grads` is emptied as it goes,
        so each whole gradient is freed once its block is cut."""
        out = {}
        for name in list(grads):
            g = grads.pop(name).float()
            summed = set()
            for i, axes in self._split(name):
                for a in axes:                   # row-major: outer axis first
                    ax = self.mesh.axis(a)
                    if ax.size == 1:
                        continue
                    if a in self.batch_axes:
                        g = _reduce_scatter(g, i, ax)
                        summed.add(a)
                    else:
                        step = g.shape[i] // ax.size
                        g = g.narrow(i, ax.rank * step, step)
            if not g.is_contiguous() or g.untyped_storage().nbytes() != g.nbytes:
                g = g.clone(memory_format=torch.contiguous_format)   # a block of its own
            for a in self.batch_axes:
                ax = self.mesh.axis(a)
                if a not in summed and ax.size > 1:
                    tdist.all_reduce(g, group=ax.group)
            out[name] = g.div_(self.batch_shards)
        return out

    def global_norm(self, blocks: dict):
        """The norm of the whole gradients from this rank's blocks (of
        `reduce_grads`): each block's sum of squares over the number of
        ranks that hold the same block, summed over the world in one
        all-reduce."""
        world = math.prod(self.mesh.shape.values())
        sq = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        for name, g in blocks.items():
            ways = math.prod(_axis_size(e, self.mesh.shape) for e in self.specs[name])
            sq = sq + torch.sum(torch.square(g)) * (ways / world)
        tdist.all_reduce(sq)
        return torch.sqrt(sq)

    def mean(self, x):
        """A 0-d metric averaged over the batch axes."""
        return self._batch_sum(torch.as_tensor(x, dtype=torch.float32,
                                               device=self.mesh.device).clone()) \
            / self.batch_shards

    def barrier(self):
        flag = torch.zeros(1, device=self.mesh.device)
        tdist.all_reduce(flag)

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of the global batch: a block along the batch
        axes (row-major), the same rows on every rank of the other axes."""
        n, idx = 1, 0
        for a in self.batch_axes:
            size = self.mesh.shape[a]
            n, idx = n * size, idx * size + self.mesh.axis(a).rank
        per = global_batch // n
        return slice(idx * per, (idx + 1) * per)


def _reduce_scatter(t, dim, ax):
    """The sum of `t` over the ranks of axis `ax`, each keeping its block of
    dim `dim` (the block at its coordinate)."""
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // ax.size,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    _REDUCE_SCATTER(out, src, group=ax.group)
    return out.movedim(0, dim)


def named(mesh, specs: dict, batch_axes=()) -> Layout:
    """The layout of a train state on `mesh` by its parameter specs (the
    counterpart of the reference's NamedSharding tree)."""
    return Layout(mesh, specs, batch_axes)


def place(state, layout: Layout):
    """Keeps only this rank's block of every parameter, m and v of a whole
    train state (every rank holds the same whole state before), and
    returns the state carrying `layout`."""
    layout.shard_params(state.params)
    for group in ("m", "v"):
        state.opt[group] = {n: layout.block(n, t) for n, t in state.opt[group].items()}
    state.layout = layout
    return state


def held_bytes(state) -> int:
    """Bytes of the parameters, m and v this rank holds."""
    tensors = list(state.params.values()) + list(state.opt["m"].values()) \
        + list(state.opt["v"].values())
    return sum(t.numel() * t.element_size() for t in tensors)
