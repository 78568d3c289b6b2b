"""Sharding rules (parameter / optimizer / batch / cache specs), the
placement of a train state on a mesh, and the plan by which a rank
computes with what it holds.

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
replicated leaves whole, between steps and during them.

How a rank computes with its blocks is the layout's plan
(`Layout.plan_for`), what GSPMD derives from the same specs in the
reference:

  * "split" (every family: dense, MoE, hybrid, xLSTM and enc-dec,
    `SplitPlan`): each rank runs its block of query heads (the enc-dec
    family's encoder self-attention, decoder self-attention and
    cross-attention alike), of ff columns, of experts (an MoE layer's
    [E, ...] leaves, E/m a rank; its shared experts' ff columns), of
    Mamba2 and mLSTM heads, of sLSTM channels and of vocab rows over
    "model" and its rows of the batch over the batch axes; each layer's
    weights are gathered over "data" when the layer runs, in one
    all-gather a dtype (inside its remat, so the recompute gathers
    again), and freed after it, and each gradient is reduce-scattered
    into the rank's block by the backward of that gather
    (`launch.parallel`). A leaf the guard replicated over "model" is
    computed replicated. Decode runs it too: the rank holds its block of
    the KV cache by `cache_specs` (its rows, and its block of the
    sequence over "model"), and attention combines the ranks' blocks in a
    softmax across "model" (`models.attention.split_attention_decode`);
    a recurrent state holds the rank's heads or channels; the enc-dec
    cache's encoder output holds the rank's block of the encoder
    sequence, and cross-attention combines those blocks the same way
    (`models.attention.split_cross_decode`). Under the reference's
    `REPRO_ATTN_SHARD=seq` (context parallelism) the train step's and the
    prefill's attention runs instead the rank's block of the sequence
    over "model", with every head (`SplitPlan.seq_rows`).
  * "gathered" (no family by default; `Layout._plan = "gathered"` puts a
    model on it, to compare the two): the step gathers every parameter
    whole over the axes that split it, runs this rank's rows,
    reduce-scatters each gradient into this rank's block
    (`reduce_grads`) and updates its blocks. Every rank of a "model"
    group then computes the same rows, and its peak holds the whole
    model.

The collectives are hand-written over the mesh's per-axis sub-groups.
"""
from __future__ import annotations

import copy
import math
import os
import types

import torch
import torch.distributed as tdist

from ..core.dist import Mesh1D
from ..models.layers import rmsnorm
from ..models.weights import STACKED, leaf_groups
from .parallel import (all_gather, all_reduce, copy_to, gather_many, gather_over,
                       reduce_from, reduce_scatter, vocab_cross_entropy, vocab_embed)

# param dims that shard over ('data' side, 'model' side)
_IN_OUT = {"wq", "wk", "wv", "wz", "wi", "wf", "wo_gate", "in_proj",
           "w_gate", "w_up"}            # [d, X] → P(data, model)
_OUT_IN = {"wo", "out", "out_proj", "w_down"}   # [X, d] → P(model, data)
_STACKED = set(STACKED)
_ONE = Mesh1D(group=None, size=1, rank=0, device=None)     # an axis of one rank: no collective
SPLIT_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec")  # the families a rank computes split


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

    _plan = None    # "gathered" runs a split-family model on the gathered plan: to compare the two

    def __init__(self, mesh, specs: dict, batch_axes=()):
        self.mesh = mesh
        self.specs = specs
        self.batch_axes = tuple(batch_axes)

    def plan_for(self, cfg) -> str:
        """How a model of `cfg` computes on this layout: "split" for the
        families of `SPLIT_FAMILIES` (`SplitPlan`), "gathered" for any
        other, or where the layout's `_plan` says "gathered"."""
        return self._plan or ("split" if cfg.family in SPLIT_FAMILIES else "gathered")

    def split_plan(self, cfg, params: dict) -> "SplitPlan":
        """The split plan of a model of `cfg` (a family of
        `SPLIT_FAMILIES`) with parameters `params` (name → parameter,
        holding this rank's blocks)."""
        return SplitPlan(self, cfg, params)

    def axis(self, name) -> Mesh1D:
        """The mesh's axis `name`; an axis the mesh lacks has one rank."""
        return self.mesh.axis(name) if name in self.mesh.shape else _ONE

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
                        g = reduce_scatter(g, i, ax)
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

    def sum_blocks(self, blocks: dict) -> dict:
        """The split plan's gradients, each this rank's block in f32 of the
        gradient of its rows' mean loss, made the blocks of the global
        batch's mean: the backward has already summed a leaf split over a
        "data" that splits the batch (`parallel.gather_over`), so each
        block is summed over the batch axes that remain, then divided by
        the batch's shard count. In place; returns `blocks`."""
        for name, g in blocks.items():
            summed = "data" in self.batch_axes and any(
                "data" in axes for _, axes in self._split(name))
            for a in self.batch_axes:
                ax = self.mesh.axis(a)
                if ax.size > 1 and not (summed and a == "data"):
                    tdist.all_reduce(g, group=ax.group)
            g.div_(self.batch_shards)
        return blocks

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


def named(mesh, specs: dict, batch_axes=()) -> Layout:
    """The layout of a train state on `mesh` by its parameter specs (the
    counterpart of the reference's NamedSharding tree)."""
    return Layout(mesh, specs, batch_axes)


def place(state, layout: Layout):
    """Keeps only this rank's block of every parameter, m and v of a whole
    train state (every rank holds the same whole state before), and
    returns the state carrying `layout`; a model on the split plan gets
    it installed (`place_model`)."""
    place_model(state.model, layout)
    for group in ("m", "v"):
        state.opt[group] = {n: layout.block(n, t) for n, t in state.opt[group].items()}
    state.layout = layout
    return state


def place_model(model, layout: Layout) -> str:
    """Keeps only this rank's block of every parameter of a whole model
    (`models.build`'s `Model`) and, on the split plan, installs the plan
    (`set_constraint_mesh`); returns the plan's name. A model on the
    gathered plan computes only after `layout.gather_params`."""
    params = dict(model.net.named_parameters())
    layout.shard_params(params)
    plan = layout.plan_for(model.cfg)
    if plan == "split":
        model.net.set_constraint_mesh(layout)
    return plan


def held_bytes(state) -> int:
    """Bytes of the parameters, m and v this rank holds."""
    tensors = list(state.params.values()) + list(state.opt["m"].values()) \
        + list(state.opt["v"].values())
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------
# the split plan: how a rank of a model computes with its blocks
# --------------------------------------------------------------------------

def _kv_heads(cfg, lo, hi):
    """The KV heads [klo, khi) that query heads [lo, hi) read (head h reads
    h // (H / Hkv)). They must share them in equal runs, as a GQA block's
    query heads do (true of every dense config over 2 to 32 model ranks):
    else it raises."""
    group = cfg.n_heads // cfg.n_kv_heads
    klo, khi = lo // group, (hi - 1) // group + 1
    n, nk = hi - lo, khi - klo
    if n % nk or any((lo + j) // group - klo != j // (n // nk) for j in range(n)):
        raise ValueError(f"{cfg.name}: query heads [{lo}, {hi}) read KV heads [{klo}, {khi}) "
                         "unevenly; the split plan cannot run on this many model ranks")
    return klo, khi


class SplitPlan:
    """The compute plan of a model on a `Layout` (the counterpart of what
    GSPMD derives from the reference's specs and its activation
    constraints), leaf by leaf:

      wq, bq          column split: the rank's query heads [lo, hi) of
                      H, H·r//m to H·(r+1)//m on "model" rank r of m
                      (its own block of wq when m divides H; else wq is
                      gathered over "model" for the layer and sliced);
      wk, wv, bk, bv  the KV heads its query heads read (head h reads
                      h // (H / Hkv)): its own block when m divides H and
                      Hkv, else gathered over "model" and sliced;
      wo              row split over the same heads, then `reduce_from`;
      q_norm, k_norm  replicated; where the heads split, the scale passes
                      `copy_to`, so the ranks' parts of its gradient (each
                      from its own heads) add into the whole;
      w_gate, w_up /  column / row split over the rank's ff block, then
      w_down          `reduce_from`;
      moe.w_gate,     the rank's experts [E·r/m, E·(r+1)/m), its own
      w_up, w_down    blocks of the [E, ...] leaves (`moe_weights`);
      moe.router      whole (gathered over "data"), routing computed
                      alike on every rank of "model";
      moe.shared      the shared experts' MLP: column / row split over the
                      rank's block of their ff columns, its partial
                      product joining the experts' before one
                      `reduce_from` in f32 (`models.moe.moe_ffn`);
      Mamba2          the rank's heads [Hs·r/m, Hs·(r+1)/m) of Hs = d / P
                      (`mamba2_weights`) and their channels: in_proj and
                      conv_w gathered over "model" and sliced to its z, x
                      and dt columns and the B and C columns whole (each
                      rank's part of their gradient adds in the gather's
                      reduce-scatter); a_log, dt_bias, d_skip its heads
                      through `copy_to`; out_proj its own rows, then
                      `reduce_from`; the norm over d a split RMSNorm
                      (`_split_norm`);
      mLSTM           the rank's heads of H: wq, wk, wv, wo_gate, wf, wi
                      its own column blocks, out its own rows, then
                      `reduce_from`; the norm over H·hd a split RMSNorm
                      (`mlstm_weights`);
      sLSTM           the rank's channels [d·r/m, d·(r+1)/m): wz, wi, wf
                      its own column blocks; wo (whose spec splits its
                      rows, by its name) gathered over "model" and sliced
                      to its columns; out its own rows, then
                      `reduce_from`; the norm a split RMSNorm; no
                      collective inside the per-token loop
                      (`slstm_weights`);
      embed / unembed vocab split: `vocab_embed` on the rank's vocab rows
                      and the logits of its vocab block
                      (`vocab_cross_entropy`; `gather_vocab` for whole
                      logits);
      norms           replicated;
      enc-dec         the encoder's attention, the decoder's self- and
                      cross-attention and both stacks' MLPs take the rows
                      above (`SplitPlan` reads them under `enc_layers.0`
                      and checks that `dec_layers.0` splits alike);
                      cross-attention's wk, wv (bk, bv) of the rank's KV
                      heads project the encoder output through `enter`,
                      so the ranks' parts of its gradient (each from its
                      own heads) add into the encoder's; the embedding
                      also unembeds (the family ties) through the vocab
                      split;
      KV cache        the rank's rows of the batch, and its slots
                      [S·r/m, S·(r+1)/m) of a cache of S slots where m
                      divides S, else all S (`cache_slots`: the rule of
                      `cache_specs`, guard included);
      encoder output  (the enc-dec decode cache) the rank's rows and its
                      slots [S·r/m, S·(r+1)/m) of an encoder sequence of
                      S where m divides S, else all S (`enc_slots`, the
                      rule of `cache_specs`); decode's cross-attention
                      projects them with wk and wv of every KV head,
                      gathered over "model" (`every_kv_head`);
      recurrent state the rank's rows and: Mamba2's h its heads and conv
                      its x channels with B and C whole; mLSTM's h its
                      heads, m and n whole; sLSTM's c, n, m its channels
                      (`models.transformer.Transformer.init_cache`; where
                      they part from `cache_specs` is ROADMAP §3's
                      deliberate differences);
      sequence split  with `REPRO_ATTN_SHARD=seq` set when the plan is
                      built (`seq`; the reference's context parallelism,
                      its constraint of q, k and v to the sequence over
                      "model"), the train step's and the prefill's
                      attention (every `Attention.forward` and
                      `DecLayer.cross`) runs the rank's rows [S·r/m,
                      S·(r+1)/m) of the sequence with every head: wq, wk,
                      wv, wo gathered over "model" (the backward summing
                      the ranks' parts, each from its own rows), bq, bk,
                      bv and the qk-norm scales through `copy_to`; the
                      rows cut from `copy_to(x)`; k and v of the rank's
                      rows gathered over "model" along the sequence in one
                      all-gather a layer (the backward summed: every
                      rank's queries read every slot); causal attention
                      over the prefix [0, S·(r+1)/m), non-causal over all
                      of it; the output rows through wo, then gathered
                      over "model" (the backward the rank's block), so the
                      residual stays whole. Where m does not divide S or
                      S/m breaks the attention's block rule the layer
                      keeps the head split (`seq_rows`). The MLP, MoE,
                      recurrent layers, vocab and decode are unchanged.

    A replicated leaf used as a slice (bq to bv, a_log to d_skip, a split
    norm's scale) passes `copy_to` first, so its slices' gradients add
    into the whole leaf over "model". A group (the heads, the ff columns,
    the experts, the shared experts' columns, the vocab, a recurrent
    layer's heads or channels) whose leaves the guard put back to
    replication over "model", or whose heads are fewer than the "model"
    ranks or not a multiple of them (a recurrent layer's), is computed
    replicated: its leaves whole, no collective over "model". Before any
    of that a leaf split over "data" is gathered over "data", a layer's
    leaves in one all-gather a dtype (`gather_layer`), the backward
    summing each gradient into the rank's block when "data" splits the
    batch. The hybrid family's shared attention block runs the dense
    rows above at every call site, gathered over "data" at each.

    Every rank of an axis makes the same collectives in the same order:
    which leaves are gathered follows from the config and the mesh, never
    from a rank's coordinates or from the routing."""

    def __init__(self, layout: Layout, cfg, params: dict):
        if cfg.family not in SPLIT_FAMILIES:
            raise ValueError(f"{cfg.name}: the split plan covers the families "
                             f"{SPLIT_FAMILIES}, not {cfg.family!r}")
        self.layout, self.cfg = layout, cfg
        self.names = {id(p): n for n, p in params.items()}
        self._gathered = {}          # id(leaf) → the leaf gathered over "data" (`gather_layer`)
        self.model, self.data = layout.axis("model"), layout.axis("data")
        self.data_summed = "data" in layout.batch_axes
        # read once, here: every rank of a group builds its plan under the same setting
        self.seq = os.environ.get("REPRO_ATTN_SHARD") == "seq"
        m, r = self.model.size, self.model.rank
        specs = layout.specs

        def split(name, dim):
            return name in specs and m > 1 and "model" in _axes(specs[name][dim])

        def block(n):
            return n * r // m, n * (r + 1) // m

        h, hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        dense = {"hybrid": "shared_attn", "encdec": "enc_layers.0"}.get(cfg.family,
                                                                         "layers.0")
        if cfg.family == "encdec":
            self._check_encdec(specs, m)
        self.heads = split(f"{dense}.attn.wq", 1) and h >= m
        self.ff = split(f"{dense}.mlp.w_gate", 1)
        self.vocab = split("embed", 0)
        self.q, self.kv = (0, h), (0, hkv)
        self.own_q = self.own_kv = False
        if self.heads:
            for i in range(m):       # every rank checks every rank: all raise or none
                _kv_heads(cfg, h * i // m, h * (i + 1) // m)
            self.q = block(h)
            self.kv = _kv_heads(cfg, *self.q)
            self.own_q = h % m == 0
            self.own_kv = self.own_q and hkv % m == 0
        self.f = block(ff) if self.ff else (0, ff)
        self.v = block(cfg.vocab_padded) if self.vocab else (0, cfg.vocab_padded)
        # an MoE layer: its experts [E, ...] and its shared experts' ff columns
        e, sff = cfg.n_experts, cfg.d_ff * cfg.n_shared_experts
        self.experts = split("layers.0.moe.w_gate", 0)
        self.shared = split("layers.0.moe.shared.w_gate", 1)
        for name, dim, n in (("layers.0.moe.w_gate", 0, e), ("layers.0.moe.w_up", 0, e),
                             ("layers.0.moe.w_down", 0, e),
                             ("layers.0.moe.shared.w_gate", 1, sff),
                             ("layers.0.moe.shared.w_up", 1, sff),
                             ("layers.0.moe.shared.w_down", 0, sff)):
            if split(name, dim) != (self.experts if ".shared." not in name else self.shared) \
                    or (split(name, dim) and n % m):
                raise ValueError(f"{cfg.name}: {name} splits over {m} model ranks unlike its "
                                 "group, or unevenly; the split plan cannot run its MoE layers")
        self.e = block(e) if self.experts else (0, e)
        self.sf = block(sff) if self.shared else (0, sff)
        # the recurrent layers: Mamba2 heads, mLSTM heads, sLSTM channels
        hs = cfg.d_model // cfg.ssm_head_dim
        self.mamba = split("layers.0.out_proj", 0) and hs % m == 0
        self.mamba_heads = block(hs) if self.mamba else (0, hs)
        self.mlstm = split("mlstm.0.out", 0) and h % m == 0
        self.mlstm_heads = block(h) if self.mlstm else (0, h)
        self.slstm = split("slstm.0.out", 0)
        self.channels = block(cfg.d_model) if self.slstm else (0, cfg.d_model)

    def _check_encdec(self, specs, m):
        """Raises unless the decoder's self-attention, cross-attention and
        MLP split over "model" as the encoder's attention and MLP do: the
        plan takes one block of heads and of ff columns for all of them."""
        def model_dims(name):
            return [m > 1 and "model" in _axes(e) for e in specs[name]]
        pairs = [(f"enc_layers.0.attn.{n}", f"dec_layers.0.{block}.{n}")
                 for block in ("self_attn", "cross_attn")
                 for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")]
        pairs += [(f"enc_layers.0.mlp.{n}", f"dec_layers.0.mlp.{n}")
                  for n in ("w_gate", "w_up", "w_down")]
        for enc, dec in pairs:
            if enc in specs and (dec not in specs or model_dims(enc) != model_dims(dec)):
                raise ValueError(f"{self.cfg.name}: {dec} splits over {m} model ranks unlike "
                                 f"{enc}; the split plan cannot run its decoder")

    # -- leaves ----------------------------------------------------------------
    def _data_dim(self, p):
        """The dim of leaf `p` split over "data", None if none is."""
        spec = self.layout.specs[self.names[id(p)]]
        return next((i for i, e in enumerate(spec) if "data" in _axes(e)), None)

    def gather_layer(self, module) -> "SplitPlan":
        """The plan for one layer (`module`): its leaves split over "data"
        gathered in one all-gather, whose backward reduce-scatters their
        gradients in one collective (`parallel.gather_many`)."""
        if self.data.size == 1:
            return self
        leaves = [p for p in module.parameters() if self._data_dim(p) is not None]
        whole = gather_many(leaves, self.data, [self._data_dim(p) for p in leaves],
                            summed=self.data_summed)
        bound = copy.copy(self)
        bound._gathered = {id(p): t for p, t in zip(leaves, whole)}
        return bound

    def _take(self, p, dim=None, lo=0, hi=0, own=False, summed=False):
        """`p`'s block with its "data" split gathered (by `gather_layer`,
        else here). With `dim`: the slice [lo, hi) along `dim` of the leaf
        whole over "model" (`own`: the rank's own block is that slice);
        without: the whole leaf (a replicated group), its gradient the
        rank's own (every rank computes the same) or, `summed`, the sum of
        the ranks' (each ran other rows: gathered with a summed backward,
        or a leaf "model" does not split through `copy_to`)."""
        spec = self.layout.specs[self.names[id(p)]]
        t = self._gathered.get(id(p), p)
        mdim = None
        for i, e in enumerate(spec):
            if t is p and "data" in _axes(e) and self.data.size > 1:
                t = gather_over(t, self.data, i, summed=self.data_summed)
            if "model" in _axes(e) and self.model.size > 1:
                mdim = i
        if dim is None:
            if mdim is None:
                return copy_to(t, self.model) if summed else t
            return gather_over(t, self.model, mdim, summed=summed)
        if own:
            return t
        t = copy_to(t, self.model) if mdim is None else gather_over(t, self.model, mdim)
        return t.narrow(dim, lo, hi - lo)

    def _parts(self, p, dim, ranges):
        """The slices `ranges` [(lo, hi), ...] along `dim` of leaf `p`
        whole over "model", joined in order: one gather (or `copy_to`) for
        all of them, whose backward adds the ranks' parts of the gradient."""
        t = self._take(p, dim, 0, self.layout.full_shape(self.names[id(p)], p)[dim])
        return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim=dim)

    def attention_weights(self, attn, all_kv=False):
        """The rank's weights of an `Attention` block, in its attribute names
        (`models.attention.attention_block` takes the head counts from
        them), with `split` (the output needs `leave`). With `all_kv`
        (decode writes every KV head of the new token): wk, wv, bk and bv
        of every KV head, or of the rank's own block of them with
        `kv_blocks` set, their products then gathered over "model"
        (`gather_kv_heads`)."""
        cfg, hd = attn.cfg, attn.cfg.hd
        names = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if cfg.qkv_bias else [])
        if not self.heads:
            w = {n: self._take(getattr(attn, n)) for n in names}
        else:
            (lo, hi), (klo, khi) = self.q, self.kv
            if all_kv and not self.own_kv:
                klo, khi = 0, cfg.n_kv_heads
            q, kv = (lo * hd, hi * hd, self.own_q), (klo * hd, khi * hd, self.own_kv)
            cols = {"wq": (1, *q), "wk": (1, *kv), "wv": (1, *kv), "wo": (0, *q),
                    "bq": (0, lo * hd, hi * hd, False), "bk": (0, klo * hd, khi * hd, False),
                    "bv": (0, klo * hd, khi * hd, False)}
            w = {n: self._take(getattr(attn, n), *cols[n]) for n in names}
        return types.SimpleNamespace(cfg=cfg, split=self.heads,
                                     kv_blocks=all_kv and self.heads and self.own_kv,
                                     q_norm=self._head_norm(getattr(attn, "q_norm", None),
                                                            self.heads),
                                     k_norm=self._head_norm(getattr(attn, "k_norm", None),
                                                            self.heads), **w)

    def _head_norm(self, norm, parts):
        """A qk-norm for the rank's heads or rows: where each rank's use
        gives a part of its gradient (`parts`: its own heads, or its own
        rows of the sequence), one that applies the scale through
        `copy_to`, so the backward sums the ranks' parts into the whole
        scale; else the module itself."""
        if norm is None or not parts:
            return norm
        scale = copy_to(norm.scale, self.model)
        return lambda x, eps=1e-5: rmsnorm(scale, x, eps)

    # -- the sequence split (REPRO_ATTN_SHARD=seq) --------------------------------
    def seq_rows(self, s: int, impl: str):
        """The rank's rows [lo, hi) of a sequence of `s` under the sequence
        split, or None where the attention keeps the head split: the mode
        off, "model" of one rank, m not dividing `s` (the specs' rule: an
        axis that does not divide its dim degrades to replication), or s/m
        breaking the block rule of `impl` (the kernel's: SQ = s/m and every
        rank's causal prefix a multiple of min(128, itself); chunked's: s/m
        a multiple of min(512, s/m), its query chunk). It reads `s`, `impl`
        and the mesh alone, so every rank of "model" decides alike."""
        m = self.model.size
        if not self.seq or m == 1 or s % m:
            return None
        n = s // m
        if impl == "kernel" and any(p % min(128, p) for p in range(n, s + 1, n)):
            return None
        if impl == "chunked" and n % min(512, n):
            return None
        r = self.model.rank
        return n * r, n * (r + 1)

    def seq_weights(self, attn):
        """The weights of an `Attention` block whole, for the rank's rows
        of the sequence: every rank uses every leaf whole and each rank's
        gradient comes from its own rows, so the backward sums them over
        "model": wq, wk, wv, wo (split over "model") gathered with a summed
        backward, a reduce-scatter into the rank's block; bq, bk, bv and
        the qk-norm scales (replicated) through `copy_to`."""
        cfg = attn.cfg
        names = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if cfg.qkv_bias else [])
        return types.SimpleNamespace(
            cfg=cfg, q_norm=self._head_norm(getattr(attn, "q_norm", None), True),
            k_norm=self._head_norm(getattr(attn, "k_norm", None), True),
            **{n: self._take(getattr(attn, n), summed=True) for n in names})

    def seq_cut(self, x, lo, hi):
        """Rows [lo, hi) of x [B, S, ...], whole on every rank of "model",
        cut after `copy_to`: each rank's rows give a part of x's gradient,
        all-reduced over "model" into the whole."""
        return copy_to(x, self.model)[:, lo:hi]

    def seq_gather(self, k, v):
        """k and v [B, S/m, Hkv, D] of every rank's rows, joined along the
        sequence in one all-gather; the backward sums the ranks' gradients
        into the rank's block (every rank's queries read every slot)."""
        return gather_many([k, v], self.model, [1, 1])

    def seq_join(self, o):
        """The output [B, S/m, d] of every rank's rows, whole on every rank
        of "model"; the backward keeps the rank's block of the gradient
        (what follows runs alike on every rank)."""
        return gather_over(o, self.model, 1, summed=False)

    def _columns(self, mlp, split, cols):
        """(w_gate, w_up, w_down) of a SwiGLU `mlp`: the rank's own block
        `cols` of its ff columns and rows where `split`, else whole."""
        if not split:
            return tuple(self._take(w) for w in (mlp.w_gate, mlp.w_up, mlp.w_down))
        lo, hi = cols
        return (self._take(mlp.w_gate, 1, lo, hi, True), self._take(mlp.w_up, 1, lo, hi, True),
                self._take(mlp.w_down, 0, lo, hi, True))

    def mlp_weights(self, mlp):
        """(w_gate, w_up, w_down): the rank's ff columns and rows."""
        return self._columns(mlp, self.ff, self.f)

    def moe_weights(self, moe):
        """The rank's weights of an `MoE` block: `router` whole (gathered
        over "data", replicated over "model"); `w_gate`, `w_up`, `w_down`
        the rank's own blocks of experts [elo, ehi) = `e` where `experts`,
        else every expert; `shared` the shared experts' (w_gate, w_up,
        w_down), the rank's block of their ff columns where
        `shared_split`, else whole (None without shared experts)."""
        lo, hi = self.e
        names = ("w_gate", "w_up", "w_down")
        if self.experts:
            w = {n: self._take(getattr(moe, n), 0, lo, hi, True) for n in names}
            if w["w_gate"].shape[0] != hi - lo:
                raise ValueError(f"{self.cfg.name}: an MoE layer holds {w['w_gate'].shape[0]} "
                                 f"experts, not the plan's block [{lo}, {hi})")
        else:
            w = {n: self._take(getattr(moe, n)) for n in names}
        shared = getattr(moe, "shared", None)
        return types.SimpleNamespace(
            router=self._take(moe.router), experts=self.experts, e=self.e,
            shared=None if shared is None else self._columns(shared, self.shared, self.sf),
            shared_split=self.shared, **w)

    # -- the recurrent layers ----------------------------------------------------
    def _split_norm(self, norm, lo, hi):
        """An RMSNorm over a width split over "model", applied to the
        rank's channels [lo, hi) of it: the f32 sum of squares of the
        rank's channels summed over "model" (all-reduced forward and, since
        every rank normalises its own channels by it, backward), divided
        by the whole width; the scale's slice taken through `copy_to`."""
        width = norm.scale.shape[0]
        scale = self._take(norm.scale, 0, lo, hi)
        model = self.model

        def apply(x, eps=1e-5):
            xf = x.float()
            sq = copy_to(reduce_from(torch.sum(xf * xf, dim=-1, keepdim=True), model), model)
            out = xf * torch.rsqrt(sq / width + eps)
            return (out * scale.float()).to(x.dtype)
        return apply

    def _whole(self, module, names, split):
        return types.SimpleNamespace(split=split, norm=module.norm,
                                     **{n: self._take(getattr(module, n)) for n in names})

    def mamba2_weights(self, p):
        """The rank's weights of a `Mamba2` block, in its attribute names
        (`models.ssm.mamba2_block` takes the head count from a_log), with
        `split`: in_proj's columns z, x of its heads' channels, B and C
        whole and dt of its heads; conv_w's x channels and B, C; a_log,
        dt_bias, d_skip of its heads; out_proj's rows of its channels; the
        norm a split RMSNorm. Without `mamba` every leaf whole."""
        names = ("in_proj", "conv_w", "a_log", "dt_bias", "d_skip", "out_proj")
        if not self.mamba:
            return self._whole(p, names, False)
        cfg = self.cfg
        d, n, pd = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
        h0, h1 = self.mamba_heads
        c0, c1 = h0 * pd, h1 * pd
        dt = 2 * d + 2 * n
        return types.SimpleNamespace(
            split=True,
            in_proj=self._parts(p.in_proj, 1, ((c0, c1), (d + c0, d + c1), (2 * d, dt),
                                               (dt + h0, dt + h1))),
            conv_w=self._parts(p.conv_w, 1, ((c0, c1), (d, d + 2 * n))),
            a_log=self._take(p.a_log, 0, h0, h1), dt_bias=self._take(p.dt_bias, 0, h0, h1),
            d_skip=self._take(p.d_skip, 0, h0, h1),
            out_proj=self._take(p.out_proj, 0, c0, c1, True),
            norm=self._split_norm(p.norm, c0, c1))

    def mlstm_weights(self, p):
        """The rank's weights of an `MLSTM` block (`models.ssm.mlstm_block`
        takes the head count from wf), with `split`: its heads' columns of
        wq, wk, wv, wo_gate, wf, wi, their rows of out, the norm a split
        RMSNorm. Without `mlstm` every leaf whole."""
        names = ("wq", "wk", "wv", "wf", "wi", "wo_gate", "out")
        if not self.mlstm:
            return self._whole(p, names, False)
        h0, h1 = self.mlstm_heads
        hd = self.cfg.hd
        w = {n: self._take(getattr(p, n), 1, h0 * hd, h1 * hd, True)
             for n in ("wq", "wk", "wv", "wo_gate")}
        return types.SimpleNamespace(
            split=True, wf=self._take(p.wf, 1, h0, h1, True), wi=self._take(p.wi, 1, h0, h1, True),
            out=self._take(p.out, 0, h0 * hd, h1 * hd, True),
            norm=self._split_norm(p.norm, h0 * hd, h1 * hd), **w)

    def slstm_weights(self, p):
        """The rank's weights of an `SLSTM` block (`models.ssm.slstm_block`
        takes the channel count from wz), with `split`: its channels'
        columns of wz, wi, wf and of wo (gathered over "model": its spec
        splits the rows), their rows of out, the norm a split RMSNorm.
        Without `slstm` every leaf whole."""
        names = ("wz", "wi", "wf", "wo", "out")
        if not self.slstm:
            return self._whole(p, names, False)
        lo, hi = self.channels
        w = {n: self._take(getattr(p, n), 1, lo, hi, True) for n in ("wz", "wi", "wf")}
        return types.SimpleNamespace(
            split=True, wo=self._take(p.wo, 1, lo, hi), out=self._take(p.out, 0, lo, hi, True),
            norm=self._split_norm(p.norm, lo, hi), **w)

    # -- the KV cache (decode) ---------------------------------------------------
    def _sequence_block(self, name, shape) -> tuple:
        """The rank's block [lo, hi) of dim 1 of a cache leaf `name` of
        `shape` by `cache_specs`' rule, guard included: all of it where
        the rule leaves dim 1 whole."""
        length = shape[1]
        spec = _cache_rule(name, shape, None, dict(self.layout.mesh.shape))
        if self.model.size == 1 or "model" not in _axes(spec[1]):
            return 0, length
        step = length // self.model.size
        return self.model.rank * step, (self.model.rank + 1) * step

    def cache_slots(self, max_len: int) -> tuple:
        """The slots [lo, hi) of a KV cache of `max_len` slots this rank
        holds: its block of the sequence over "model" where `cache_specs`
        splits it (m divides `max_len`), else all of them."""
        cfg = self.cfg
        return self._sequence_block("k", (1, max_len, cfg.n_kv_heads, cfg.hd))

    def enc_slots(self, enc_len: int) -> tuple:
        """The slots [lo, hi) of an enc-dec cache's encoder output of
        `enc_len` slots this rank holds: its block of the encoder sequence
        over "model" where `cache_specs` splits `enc_out` (m divides
        `enc_len`), else all of them."""
        return self._sequence_block("enc_out", (1, enc_len, self.cfg.d_model))

    def every_kv_head(self, attn) -> dict:
        """wk and wv (bk and bv with `qkv_bias`) of every KV head of an
        `Attention` block, whole over "model" (gathered where "model"
        splits them; the backward sums the ranks' parts of the gradient):
        a cross-attention decode projects the rank's block of the encoder
        output's slots with them (`models.attention.split_cross_decode`)."""
        cfg = attn.cfg
        width = cfg.n_kv_heads * cfg.hd
        names = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
        return {n: self._take(getattr(attn, n), 1 if n.startswith("w") else 0, 0, width)
                for n in names}

    def gather_kv_heads(self, kv):
        """Every KV head from the ranks' blocks (`attention_weights(...,
        all_kv=True)`'s `kv_blocks`): [..., Hkv / m, hd] → [..., Hkv, hd]."""
        return all_gather(kv, kv.ndim - 2, self.model)

    def gather_heads(self, q):
        """Every query head from the ranks' blocks, equal on every rank of
        "model": [B, hi - lo, hd] → [B, H, hd]. Where m does not divide H
        the blocks differ by one head: each is padded to ⌈H/m⌉ for the
        all-gather and the pads dropped by the blocks' bounds."""
        if not self.heads:
            return q
        h, m = self.cfg.n_heads, self.model.size
        if h % m == 0:
            return all_gather(q, 1, self.model)
        width = -(-h // m)
        padded = q.new_zeros((q.shape[0], width, q.shape[2]))
        padded[:, :q.shape[1]] = q
        every = all_gather(padded, 1, self.model)
        return torch.cat([every[:, i * width:i * width + h * (i + 1) // m - h * i // m]
                          for i in range(m)], dim=1)

    def sum_over_model(self, t):
        """`t` summed over "model" in place (no gradient); returns it."""
        return all_reduce(t, self.model)

    def max_over_model(self, t):
        """`t`'s elementwise max over "model" in place (no gradient)."""
        return all_reduce(t, self.model, tdist.ReduceOp.MAX)

    # -- activations -----------------------------------------------------------
    def enter(self, x, split: bool):
        """The input of a group's column-split products."""
        return copy_to(x, self.model) if split else x

    def leave(self, y, split: bool):
        """The output of a group's row-split product, whole."""
        return reduce_from(y, self.model) if split else y

    def embed(self, table, tokens):
        """The embedding rows of `tokens` from the rank's vocab block."""
        if not self.vocab:
            return self._take(table)[tokens]
        t = self._take(table, 0, *self.v, True)
        return vocab_embed(t, tokens, self.v[0], self.model)

    def logits(self, x, net):
        """f32 logits of the rank's vocab block (whole without a vocab
        split), through `net.unembed` where the net has one, else through
        its embedding (tied: the enc-dec family always unembeds so)."""
        x = self.enter(x, self.vocab)
        lo, hi = self.v
        if getattr(net, "unembed", None) is None:
            w = self._take(net.embed, 0, lo, hi, True) if self.vocab else self._take(net.embed)
            return (x @ w.T).float()
        w = self._take(net.unembed, 1, lo, hi, True) if self.vocab else self._take(net.unembed)
        return (x @ w).float()

    def gather_vocab(self, logits):
        """Whole logits from the ranks' vocab blocks, equal on every rank."""
        if not self.vocab:
            return logits
        return gather_over(logits, self.model, logits.ndim - 1)

    def cross_entropy(self, logits, labels):
        """Mean NLL from the logits of `logits` (the rank's vocab block)."""
        return vocab_cross_entropy(logits, labels, self.v[0],
                                   self.model if self.vocab else _ONE)
