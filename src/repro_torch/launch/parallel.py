"""Collectives with their gradients, over one axis of a `dist.Mesh`: the
pieces of the split plan (`launch.sharding.SplitPlan`), by which a rank of
a dense or MoE model computes with its own blocks of heads, ff columns,
experts and vocab rows over "model" and gathers each layer's weights over
"data".

Each is a `torch.autograd.Function` over a `dist.Mesh1D` (one axis's
sub-group); over an axis of size 1 each is the identity:

  * `copy_to`     — identity forward, all-reduce backward: the input of a
                    column-split product (each rank's columns give a part
                    of the input's gradient);
  * `reduce_from` — all-reduce forward, identity backward: the output of a
                    row-split product (each rank's rows give a part of it);
  * `gather_over` — all-gather forward along `dim`, reduce-scatter backward
                    (`summed`: the ranks ran other rows or other heads, so
                    their gradients add) or this rank's block of the
                    gradient (the ranks ran the same rows: the gradients
                    are equal);
  * `gather_many` — `gather_over` of several tensors, each along its own
                    dim, in one all-gather of their blocks laid end to end
                    a dtype (and one reduce-scatter backward): a layer's
                    leaves split over "data" make one collective a dtype,
                    not one each, and keep their dtypes;
  * `vocab_embed`, `vocab_cross_entropy` — the embedding lookup and the
                    loss over a vocab split into blocks, one a rank.

The collectives are hand-written over the mesh's sub-groups, as the rest
of the port's distributed code is: NCCL on the card, gloo on the CPU, the
fake backend of the dry run on meta.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

_ALL_GATHER = getattr(tdist, "all_gather_single", None) or tdist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor


def all_gather(t, dim, ax):
    """The ranks' tensors of axis `ax` joined along `dim`, in rank order."""
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] * ax.size,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    _ALL_GATHER(out, src, group=ax.group)
    return out.movedim(0, dim)


def reduce_scatter(t, dim, ax):
    """The sum of `t` over the ranks of axis `ax`, each keeping its block of
    dim `dim` (the block at its coordinate)."""
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // ax.size,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    _REDUCE_SCATTER(out, src, group=ax.group)
    return out.movedim(0, dim)


def all_reduce(t, ax, op=tdist.ReduceOp.SUM):
    """`t` reduced over axis `ax` in place; returns it."""
    tdist.all_reduce(t, op=op, group=ax.group)
    return t


def block_of(t, dim, ax):
    """This rank's block of `t` along `dim` on axis `ax`."""
    step = t.shape[dim] // ax.size
    return t.narrow(dim, ax.rank * step, step)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, summed):
        ctx.ax, ctx.dim, ctx.summed = ax, dim, summed
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.dim, ctx.ax), None, None, None
        return block_of(g, ctx.dim, ctx.ax).contiguous(), None, None, None


class _GatherMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dims, summed, *xs):
        ctx.ax, ctx.dims, ctx.summed = ax, dims, summed
        ctx.shapes = [x.shape for x in xs]
        flat = torch.cat([x.reshape(-1) for x in xs])
        out = torch.empty((ax.size, flat.numel()), dtype=flat.dtype, device=flat.device)
        _ALL_GATHER(out.view(-1), flat, group=ax.group)
        whole, at = [], 0
        for x, d in zip(xs, dims):     # rank r's block of x at row r: join them along d
            part = out[:, at:at + x.numel()].reshape(ax.size, *x.shape).movedim(0, d)
            shape = list(x.shape)
            shape[d] *= ax.size
            whole.append(part.reshape(shape).contiguous())
            at += x.numel()
        return tuple(whole)

    @staticmethod
    def backward(ctx, *gs):
        ax, n = ctx.ax, ctx.ax.size
        if not ctx.summed:
            return (None, None, None) + tuple(block_of(g, d, ax).contiguous()
                                              for g, d in zip(gs, ctx.dims))
        rows = [g.reshape(*g.shape[:d], n, s[d], *g.shape[d + 1:]).movedim(d, 0).reshape(n, -1)
                for g, d, s in zip(gs, ctx.dims, ctx.shapes)]
        flat = torch.cat(rows, dim=1)               # [n, the blocks end to end]
        out = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
        _REDUCE_SCATTER(out, flat.view(-1), group=ax.group)
        blocks, at = [], 0
        for s in ctx.shapes:
            blocks.append(out[at:at + s.numel()].view(s))
            at += s.numel()
        return (None, None, None) + tuple(blocks)


def copy_to(x, ax):
    """Identity forward, all-reduce over `ax` backward."""
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from(x, ax):
    """All-reduce over `ax` forward, identity backward."""
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_over(x, ax, dim, summed=True):
    """The ranks' blocks of `ax` joined along `dim`; backward, the sum of
    the ranks' gradients cut to this rank's block (`summed`) or this
    rank's block of its own gradient."""
    return x if ax.size == 1 else _GatherOver.apply(x, ax, dim, summed)


def gather_many(xs, ax, dims, summed=True):
    """`gather_over(x, ax, dim, summed)` of each x in `xs` along its dim in
    `dims`, in one all-gather per dtype, in the order each dtype first
    appears (backward: one reduce-scatter per dtype, or each rank's blocks
    as `gather_over` keeps them). Each comes back in its own dtype: the
    blocks of one all-gather share a dtype, so an f32 router beside bf16
    experts is never promoted, nor they with it."""
    if ax.size == 1 or not xs:
        return list(xs)
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    out = [None] * len(xs)
    for idx in groups.values():
        whole = _GatherMany.apply(ax, tuple(dims[i] for i in idx), summed,
                                  *(xs[i] for i in idx))
        for i, w in zip(idx, whole):
            out[i] = w
    return out


def vocab_embed(table, tokens, lo, ax):
    """Rows `tokens` of a table split by vocab rows over `ax`: `table` holds
    rows [lo, lo + len(table)); each rank looks up the tokens in its block
    (zeros elsewhere) and the ranks' lookups are summed (`reduce_from`)."""
    local = tokens - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)] * inside[..., None].to(table.dtype)
    return reduce_from(rows, ax)


def vocab_cross_entropy(logits, labels, lo, ax):
    """Mean NLL of `labels` [B, S] under logits split by vocab over `ax`:
    `logits` [B, S, Vb] f32 holds the vocab block [lo, lo + Vb). The max,
    the sum of exponentials and the gold logit are each reduced over `ax`;
    no rank forms the whole [B, S, V] logits. Equal to
    `train.train_step.cross_entropy` of the whole logits, gradient too."""
    with torch.no_grad():
        top = logits.amax(dim=-1)
        if ax.size > 1:
            all_reduce(top, ax, tdist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - top[..., None]).sum(dim=-1), ax)
    local = labels - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.take_along_dim(logits, local.clamp(0, logits.shape[-1] - 1)[..., None],
                                dim=-1)[..., 0]
    gold = reduce_from(torch.where(inside, gold, torch.zeros_like(gold)), ax)
    return torch.mean(top + torch.log(sumexp) - gold)
