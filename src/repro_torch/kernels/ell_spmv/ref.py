"""Plain-torch versions of the block-ELL semiring SpMV and of the sliced
pull sweep (the kernels' oracles)."""
from __future__ import annotations

import torch

from ...graph.csr import INF_I32

INF = int(INF_I32)
_INT_MAX = 2**31 - 1   # the min-plus identity


def ell_spmv_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                 semiring: str = "minplus") -> torch.Tensor:
    """cols/vals [R, D]; x [M] (→ y [R]) or [M, B] (→ y [R, B]), weights
    broadcast across the B lanes."""
    gathered = torch.index_select(x, 0, cols.reshape(-1)).reshape(
        cols.shape + x.shape[1:])           # [R, D] or [R, D, B]
    if x.ndim == 2:
        vals = vals[..., None]
    if semiring == "minplus":
        return torch.amin(gathered + vals, dim=1)
    if semiring == "plustimes":
        return torch.sum(gathered * vals, dim=1)
    raise ValueError(semiring)


def _segment_reduce(index, values, size, minplus):
    out = torch.full((size,), _INT_MAX if minplus else 0, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, index, values, "amin" if minplus else "sum")


def ell_sweep_ref(ell, plan, x: torch.Tensor, semiring: str = "minplus",
                  dist: torch.Tensor | None = None) -> torch.Tensor:
    """The pull sweep of a reverse sliced view, step by step as its plan
    lays it out: y [N] from the gather source x [N].

      minplus   : y[v] = min(dist[v], INF, min over in-edges (x[u] + w))
      plustimes : y[v] = sum over in-edges x[u]           (unit weights)

    Rows of in-degree 0 take min(dist, INF) or 0. Each bucket runs through
    `ell_spmv_ref` (its pads meet a sentinel slot holding 0, so they add
    INF or 0 and change nothing); the hub tail is reduced piece by piece,
    where a piece is one segment's entries inside one chunk: a segment
    inside one chunk is written at once, the pieces of a spanning segment
    go to partial slots that are then combined."""
    n = plan.num_nodes
    minplus = semiring == "minplus"
    if semiring not in ("minplus", "plustimes"):
        raise ValueError(semiring)
    dev = x.device
    base = torch.clamp(dist, max=INF) if minplus else None

    def finish(rows, acc):
        return torch.minimum(base[rows], acc) if minplus else acc

    y = torch.empty_like(x)
    zr = plan.zero_rows.long()
    y[zr] = base[zr] if minplus else 0
    x_ext = torch.cat([x, x.new_zeros(1)])          # the pads' sentinel slot
    for cols, wts, rows in zip(ell.cols, ell.wts, ell.rows):
        vals = wts if minplus else torch.ones(cols.shape, dtype=x.dtype, device=dev)
        acc = ell_spmv_ref(cols, vals, x_ext, semiring)
        keep = rows < n                              # row padding is skipped
        r = rows[keep].long()
        y[r] = finish(r, acc[keep])

    eh = int(ell.hub_rows.shape[0])
    if eh == 0:
        return y
    seg_ptr = plan.seg_ptr.long()
    num_segs = int(seg_ptr.shape[0]) - 1
    seg = torch.repeat_interleave(torch.arange(num_segs, device=dev), seg_ptr.diff())
    chunk_of = torch.arange(eh, device=dev) // plan.chunk
    cand = x[ell.hub_cols.long()]
    if minplus:
        cand = cand + ell.hub_wts
    # pieces: a new one starts where the segment or the chunk changes
    new = torch.ones(eh, dtype=torch.bool, device=dev)
    new[1:] = (seg[1:] != seg[:-1]) | (chunk_of[1:] != chunk_of[:-1])
    piece = torch.cumsum(new, 0) - 1
    p_seg, p_chunk = seg[new], chunk_of[new]
    p_acc = _segment_reduce(piece, cand, int(p_seg.shape[0]), minplus)
    first = seg_ptr[:-1] // plan.chunk
    last = (seg_ptr[1:] - 1) // plan.chunk
    whole = (first == last)[p_seg]
    rows = plan.seg_rows.long()[p_seg[whole]]
    y[rows] = finish(rows, p_acc[whole])

    partial = torch.full((2 * plan.num_chunks,), _INT_MAX if minplus else 0,
                         dtype=x.dtype, device=dev)
    slot = 2 * p_chunk[~whole] + (plan.chunk_seg.long()[p_chunk[~whole]] != p_seg[~whole]).long()
    partial[slot] = p_acc[~whole]
    # combine: the first chunk's slot, then slot 2k of every later chunk
    first_slot = plan.span_first_slot.long()
    ka = first_slot // 2
    length = plan.span_last_chunk.long() - ka + 1
    j = torch.repeat_interleave(torch.arange(int(length.shape[0]), device=dev), length)
    step = torch.arange(int(length.sum()), device=dev) - \
        torch.repeat_interleave(torch.cumsum(length, 0) - length, length)
    slots = torch.where(step == 0, first_slot[j], 2 * (ka[j] + step))
    acc = _segment_reduce(j, partial[slots], int(length.shape[0]), minplus)
    rows = plan.span_rows.long()
    y[rows] = finish(rows, acc)
    return y
