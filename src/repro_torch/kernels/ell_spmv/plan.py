"""The sweep plan: what the one-launch pull sweep needs beside a sliced view.

`ell_sweep` (kernel.py) runs the single-vector pull sweep of a reverse
`SlicedEllGraph` — every bucket, the COO hub tail and the rows of in-degree
0 — in one launch plus a small combine launch. The view's own arrays stay
as they are (they equal the reference's, array for array); the plan adds,
once per view:

  * per bucket, its lanes per row and its range of thread blocks;
  * the hub tail as row segments: `seg_rows[s]` owns the hub entries
    `seg_ptr[s] .. seg_ptr[s + 1]` (`hub_rows` must be sorted);
  * the chunk table: the tail cut into chunks of `chunk` entries, one
    block each; `chunk_seg[k]` is the segment holding chunk k's first
    entry. A segment that lies inside one chunk is written by that chunk's
    block. A segment that spans several (`span_*`) leaves a partial in
    slot `2k` of the chunk where it continues from the chunk before, or in
    slot `2k + 1` of the chunk where it starts (when another segment holds
    that chunk's first entry); the combine launch folds the partials of
    each spanning segment in chunk order, so f32 sums are deterministic;
  * `zero_rows`: the rows in no bucket and no segment (in-degree 0).

`sweep_plan(ell)` builds the plan once per view object and keeps it while
the view lives; `GraphContext.sweep_plan` holds the same object among the
graph's views, so `view_nbytes` counts it.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from ...graph.csr import SlicedEllGraph

THREADS = 256        # threads per block of the sweep kernel (csrc/ell_spmv.cu)
HUB_CHUNK = 4096     # hub entries per chunk (one block each)
MAX_BUCKETS = 16     # buckets one launch takes (kMaxBuckets in the source)


def lanes_for(width: int) -> int:
    """Lanes per bucket row: one per 4 columns (one 16-byte load), rounded
    up to a power of two, at most a warp."""
    lanes = 1
    while lanes < min(32, -(-width // 4)):
        lanes *= 2
    return lanes


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Host-built launch plan of one sliced view (see the module docstring).

    `buckets[i]` describes `ell.cols[i]`: (rows R, width D, lanes,
    first block, blocks). Blocks run hub chunks first, then the buckets
    widest first, then the zero rows."""

    num_nodes: int
    buckets: tuple            # ((R, D, lanes, first_block, num_blocks), ...)
    chunk: int
    num_chunks: int
    seg_rows: torch.Tensor    # int32[S]
    seg_ptr: torch.Tensor     # int32[S + 1]
    chunk_seg: torch.Tensor   # int32[K]
    span_rows: torch.Tensor   # int32[P] rows of the spanning segments
    span_first_slot: torch.Tensor  # int32[P] partial slot of the first chunk
    span_last_chunk: torch.Tensor  # int32[P]
    zero_rows: torch.Tensor   # int32[Z]
    zero_first_block: int
    num_blocks: int


def build_sweep_plan(ell: SlicedEllGraph, *, chunk: int = HUB_CHUNK) -> SweepPlan:
    """Build the plan of `ell` on its device (a host check first: the hub
    tail's rows must be sorted, as `to_sliced_ell` lays them out)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if len(ell.cols) > MAX_BUCKETS:
        raise ValueError(f"the sweep takes at most {MAX_BUCKETS} buckets, "
                         f"got {len(ell.cols)}")
    n = ell.num_nodes
    hub_rows = ell.hub_rows
    dev = hub_rows.device
    eh = int(hub_rows.shape[0])
    if eh >= 2**31 - chunk:
        raise ValueError(f"the hub tail's {eh} entries exceed int32 offsets")
    if eh > 1 and not bool((hub_rows[1:] >= hub_rows[:-1]).all()):
        raise ValueError("hub_rows must be sorted: the sweep walks the hub "
                         "tail as row segments")
    i32 = dict(dtype=torch.int32, device=dev)
    seg_rows, counts = torch.unique_consecutive(hub_rows, return_counts=True)
    seg_ptr = torch.zeros(seg_rows.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=seg_ptr[1:])
    k = -(-eh // chunk)
    # segment holding each chunk's first entry
    starts = torch.arange(k, dtype=torch.int64, device=dev) * chunk
    chunk_seg = torch.searchsorted(seg_ptr, starts, right=True) - 1
    first_chunk = seg_ptr[:-1] // chunk
    last_chunk = (seg_ptr[1:] - 1) // chunk
    span = torch.nonzero(last_chunk > first_chunk).flatten()
    fc = first_chunk[span]
    starts_inside = chunk_seg[fc] != span     # another segment opens the chunk
    span_first_slot = 2 * fc + starts_inside.long()

    covered = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for rows in ell.rows:
        covered[rows.long()] = True
    covered[seg_rows.long()] = True
    zero_rows = torch.nonzero(~covered[:n]).flatten()

    buckets, block = [], k
    for i in sorted(range(len(ell.cols)), key=lambda i: -int(ell.cols[i].shape[1])):
        r, d = (int(s) for s in ell.cols[i].shape)
        lanes = lanes_for(d)
        nb = -(-r * lanes // THREADS)
        buckets.append((i, (r, d, lanes, block, nb)))
        block += nb
    zero_first = block
    block += -(-int(zero_rows.shape[0]) // THREADS)
    if block >= 2**31:
        raise ValueError(f"the sweep needs {block} blocks, more than one launch takes")
    return SweepPlan(
        num_nodes=n, buckets=tuple(b for _, b in sorted(buckets)), chunk=int(chunk),
        num_chunks=k, seg_rows=seg_rows.to(**i32), seg_ptr=seg_ptr.to(**i32),
        chunk_seg=chunk_seg.to(**i32), span_rows=seg_rows[span].to(**i32),
        span_first_slot=span_first_slot.to(**i32),
        span_last_chunk=last_chunk[span].to(**i32), zero_rows=zero_rows.to(**i32),
        zero_first_block=zero_first, num_blocks=block)


_PLANS: dict = {}   # id(view) -> (weakref(view), plan)


def sweep_plan(ell: SlicedEllGraph) -> SweepPlan:
    """The plan of `ell` (default chunk), built on first use and kept while
    the view lives."""
    key = id(ell)
    entry = _PLANS.get(key)
    if entry is None or entry[0]() is not ell:
        ref = weakref.ref(ell, lambda _r, _k=key: _PLANS.pop(_k, None))
        _PLANS[key] = entry = (ref, build_sweep_plan(ell))
    return entry[1]
