"""Distributed runtime of the MPI-analogue backend, on `torch.distributed`.

The port of `repro.core.runtime_dist` (the paper's MPI backend, §3.2), and
the two axis collectives of the 2-D grid (`reduce_scatter_min`,
`reduce_scatter_sum`, which `core.dist2d` runs over its "model" axis):
one process per shard, SPMD, as under `mpirun` or `torchrun`.

  * each rank owns a contiguous vertex block (`own_ids`), the last block
    padded, exactly the paper's scheme;
  * property exchange = an all-gather into one tensor, or the frontier-
    compressed `exchange` (changed entries only, through a fixed per-shard
    buffer) when the compiled Schedule's `dist_frontier` policy asks;
  * update combining = an `all_reduce` (MIN / SUM / MAX) of scattered
    candidate arrays: the paper's communication aggregation is the
    collective itself;
  * the fixed-point flag = a global OR (a SUM of the local any()).

The reference's collectives name the mesh axis 'data' and find it in the
enclosing `shard_map`; these take the mesh (`dist.Mesh1D`) as an argument,
and the generated code passes its own. Where the reference branches
on the device (`lax.cond`, `while_loop`), this branches on the host, and
every such predicate is read from a collective's result or from data every
rank holds alike: a rank that branched alone would wait forever in a
collective the others never enter.

`prepare_graph_1d` builds every shard's arrays on the host (numpy, stacked
on a leading [P] axis); `shard_arrays` moves one rank's row to its device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..graph.csr import CSRGraph, to_ell
from ..graph.partition import partition_edges_1d
from . import runtime as rt

# `all_gather_into_tensor` and `reduce_scatter_tensor` are deprecated for
# `all_gather_single` and `reduce_scatter_single` from torch 2.13 on (a
# FutureWarning per call); older lines have only the former
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# --------------------------------------------------------------------------
# Graph preparation (host side)
# --------------------------------------------------------------------------

def prepare_graph_1d(g: CSRGraph, num_devices: int, *, ell: bool = False) -> dict:
    """Every shard's arrays of the 1-D partition, numpy, stacked [P, ...].

    Keys with a leading [P] are partitioned (rank r holds row r); `*_rep`
    keys are replicated graph structure (degree tables, the sorted edge key
    for is_an_edge, the true vertex count)."""
    p = num_devices
    n = g.num_nodes
    host = lambda t: t.cpu().numpy()                         # noqa: E731
    out = partition_edges_1d(host(g.edge_src), host(g.indices), host(g.weights), n, p)
    # in-edges by dst block: `src` of `inn` is the OWNED dst, `dst` the in-neighbor
    inn = partition_edges_1d(host(g.rev_edge_dst), host(g.rev_indices),
                             host(g.rev_weights), n, p)
    block, n_pad = out.block, out.num_nodes_padded
    base = (np.arange(p) * block)[:, None]
    deg_out = np.zeros(n_pad, np.int32)
    deg_out[:n] = host(g.out_degree)
    deg_in = np.zeros(n_pad, np.int32)
    deg_in[:n] = host(g.in_degree)
    gd = {
        "esrc": out.src, "edst": out.dst, "ew": out.weight, "evalid": out.valid,
        # local slot of the source vertex; padding edges clipped to 0 and
        # neutralized by the valid mask
        "esrc_local": np.clip(out.src - base, 0, block - 1).astype(np.int32),
        "idst": inn.src, "isrc": inn.dst, "iw": inn.weight, "ivalid": inn.valid,
        "idst_local": np.clip(inn.src - base, 0, block - 1).astype(np.int32),
        "own_ids": (base + np.arange(block)[None, :]).astype(np.int32),
        "out_degree_rep": deg_out,
        "in_degree_rep": deg_in,
        "n_true_rep": n,
        "edge_key_rep": host(g.edge_key),
    }
    if ell:
        e = to_ell(g)
        cols = host(e.cols)
        cols_pad = np.full((n_pad, e.max_deg), n_pad, np.int32)
        cols_pad[:n] = np.where(cols == n, n_pad, cols)
        gd["ell_cols"] = cols_pad.reshape(p, block, e.max_deg)
    return gd


# the edge arrays of each direction, and the mask of its real edges
_EDGE_KEYS = {"evalid": ("esrc", "edst", "ew", "evalid", "esrc_local"),
              "ivalid": ("idst", "isrc", "iw", "ivalid", "idst_local")}


def shard_arrays(host: dict, rank: int, device) -> dict:
    """Rank `rank`'s view of `prepare_graph_1d`'s arrays on `device`: its
    row of every partitioned key, the `*_rep` keys whole.

    A rank keeps only its real edges (a prefix of its row). The reference
    pads every shard's edge row to the longest, since `shard_map` needs one
    shape; here the padding would only add work, and on the card its
    edges, all aimed at vertex 0 and local slot 0, serialize the atomics of
    every scatter and segment sum on that one address (a block partition
    of an RMAT graph leaves the last shards mostly padding)."""
    real = {key: int(host[valid][rank].sum())
            for valid, keys in _EDGE_KEYS.items() for key in keys}

    def move(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {}
    for k, v in host.items():
        if k == "n_true_rep":
            out[k] = v
        elif k.endswith("_rep"):
            out[k] = move(v)
        else:
            out[k] = move(v[rank][: real[k]] if k in real else v[rank])
    return out


# --------------------------------------------------------------------------
# Collectives (used by generated code)
# --------------------------------------------------------------------------

def _gather_dim0(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather along dim 0 into one tensor: [k, ...] -> [P*k, ...] in rank
    order. bool travels as uint8 (one byte either way)."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bool else x
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=wire.dtype, device=x.device)
    _all_gather(out, wire, group=mesh.group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def gather(x, mesh):
    """Property exchange: every rank receives the full [N_pad] array."""
    return _gather_dim0(x, mesh)


def gather_rows(x, mesh):
    """Batched property exchange: [S, B] lane blocks -> [S, N_pad] full rows
    (gathered as [P, S, B], then the shard axis moves next to the block)."""
    s, b = x.shape
    return _gather_dim0(x, mesh).view(mesh.size, s, b).permute(1, 0, 2).reshape(
        s, mesh.size * b)


def reduce_scatter_min(part, mesh):
    """Min-reduce-scatter over an axis: `part` is [size * piece]
    destination candidates; rank k receives min over ranks of chunk k
    ([piece]). An all-to-all of the chunks, then a local min (the
    reference's `_reduce_scatter_min`; MIN has no reduce-scatter in
    every backend)."""
    chunks = part.reshape(mesh.size, -1).contiguous()
    got = torch.empty_like(chunks)
    dist.all_to_all_single(got, chunks, group=mesh.group)
    return torch.amin(got, dim=0)


def reduce_scatter_sum(part, mesh):
    """Sum-reduce-scatter over an axis: [size * piece] -> this rank's
    [piece] chunk summed over ranks (the reference's `psum_scatter`)."""
    out = torch.empty((part.shape[0] // mesh.size,), dtype=part.dtype, device=part.device)
    _reduce_scatter(out, part.contiguous(), group=mesh.group)
    return out


def _all_reduce(x, op, mesh):
    wire = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
    dist.all_reduce(wire, op=op, group=mesh.group)
    return wire.to(torch.bool) if x.dtype == torch.bool else wire


def pmin(x, mesh):
    return _all_reduce(x, dist.ReduceOp.MIN, mesh)


def pmax(x, mesh):
    return _all_reduce(x, dist.ReduceOp.MAX, mesh)


def psum(x, mesh):
    return _all_reduce(x, dist.ReduceOp.SUM, mesh)


def por(x, mesh):  # global OR of a local bool scalar
    return psum(x.to(torch.int32), mesh) > 0


def any_global(x, mesh):  # global OR over a local bool array
    return por(torch.any(x), mesh)


def min_global(x, mesh):  # global min over a local array (delta bucket advance)
    return pmin(torch.amin(x), mesh)


def compact_cap(block: int, frac: float) -> int:
    """Static per-shard compact-buffer capacity for a [block]-sized shard."""
    return max(min(int(block * frac), block), 1)


def _to_lane(vals: torch.Tensor) -> torch.Tensor:
    """Values as int32 lanes of the pair buffer: bool widens, float32
    bitcasts (both lossless round trips)."""
    if vals.dtype == torch.bool:
        return vals.to(torch.int32)
    if vals.dtype == torch.int32:
        return vals
    if vals.dtype == torch.float32:
        return vals.view(torch.int32)
    raise TypeError(f"exchange carries bool, int32 or float32 properties, not {vals.dtype}")


def _from_lane(lane: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return lane != 0
    if dtype == torch.float32:
        return lane.contiguous().view(torch.float32)
    return lane


def exchange(full_prev, blk, own_ids, gather_frac: float = 0.25, *, mesh,
             skip_empty: bool = True, within=None, _dense=None):
    """Frontier-compressed BSP property exchange.

    `full_prev` is the [N_pad] view every rank agreed on last superstep;
    `blk` is this rank's current [B] block. Entries that differ are the
    communication frontier. Three regimes, chosen per superstep from one
    collective, the largest change count of any rank (`worst`), so every
    rank branches the same way:

      * empty   — nothing changed anywhere (`worst == 0`, which is the
                  reference's `total == 0`: counts are never negative):
                  skip the collective entirely (only when `skip_empty`, the
                  "auto" policy);
      * compact — every rank's change count fits the fixed-size buffer
                  (`cap = compact_cap(B, gather_frac)`): all-gather only
                  (id, value) pairs, stacked into ONE [cap, 2] int32
                  buffer, and write them into `full_prev`, moving 2*cap*P
                  elements instead of N_pad (§4.2's send-buffer
                  aggregation, volume edition);
      * dense   — overflow fallback: the full all-gather.

    `within` (optional bool [B]) restricts the exchange to a slice of the
    changed entries — the delta-stepping priority slice; out-of-window
    changes stay local until their bucket is reached (values only
    decrease, so they still differ from `full_prev` then).

    Returns `(full, gathered_elems)`, the second a Python int: the elements
    this superstep moved. The changed slots go first in a STABLE order;
    lanes past a rank's count carry the id N_pad and land in a spare slot
    that is sliced off, so initialized-but-never-written padding, which
    never differs from `full_prev`, is never transmitted (tested with
    poison values)."""
    n_pad = full_prev.shape[0]
    cap = compact_cap(blk.shape[0], gather_frac)
    p = mesh.size
    chg = blk != full_prev[own_ids]
    if within is not None:
        chg = chg & within

    def dense():
        # `_dense` overrides the fallback gather when the flat layout is a
        # view an all-gather cannot reproduce by concatenation (the [S, B]
        # lane blocks of `exchange_rows`)
        return (gather(blk, mesh) if _dense is None else _dense()), n_pad

    if 2 * cap * p >= n_pad and not skip_empty:   # compact cannot beat dense
        return dense()
    cnt = torch.sum(chg, dtype=torch.int32)
    worst = int(pmax(cnt, mesh))
    if skip_empty and worst == 0:
        return full_prev, 0
    if 2 * cap * p >= n_pad or worst > cap:
        return dense()
    order = torch.argsort((~chg).to(torch.uint8), stable=True)   # changed slots first
    sel = order[:cap]
    lane_ok = torch.arange(cap, device=blk.device) < cnt
    ids = torch.where(lane_ok, own_ids[sel], n_pad).to(torch.int32)
    lane = _to_lane(blk[sel].to(full_prev.dtype))
    pairs = _gather_dim0(torch.stack([ids, lane], dim=1), mesh)
    full = torch.empty((n_pad + 1,), dtype=full_prev.dtype, device=full_prev.device)
    full[:n_pad] = full_prev
    full[pairs[:, 0].long()] = _from_lane(pairs[:, 1], full_prev.dtype)
    return full[:n_pad], 2 * cap * p


def exchange_rows(full_prev, blk, own_ids, gather_frac: float = 0.25, *, mesh,
                  skip_empty: bool = True):
    """Batched-lane `exchange`: full_prev [S, N_pad], blk [S, B]. Lanes are
    flattened into one composite id space (lane * N_pad + vertex), so the
    compact buffer is shared across lanes — a lane whose frontier emptied
    donates its capacity to the others."""
    s, n_pad = full_prev.shape
    own2d = (torch.arange(s, dtype=torch.int32, device=own_ids.device)[:, None] * n_pad
             + own_ids[None, :]).reshape(-1)
    full, elems = exchange(full_prev.reshape(-1), blk.reshape(-1), own2d,
                           gather_frac, mesh=mesh, skip_empty=skip_empty,
                           _dense=lambda: gather_rows(blk, mesh).reshape(-1))
    return full.reshape(s, n_pad), elems


def combine_scatter_min(n_pad: int, idx, cand, dtype, mesh):
    """Paper §4.2 'communication aggregation': local scatter-min into a
    full-size buffer, then one min-combine across ranks."""
    buf = torch.full((n_pad,), rt.inf_for(dtype), dtype=dtype, device=idx.device)
    return pmin(rt.scatter_min(buf, idx, cand), mesh)


def combine_scatter_add(n_pad: int, idx, vals, dtype, mesh):
    """Local scatter-add (float32 on the card accumulates in float64, as
    every sum of the runtime), then one sum across ranks."""
    buf = torch.zeros((n_pad,), dtype=dtype, device=idx.device)
    return psum(rt.scatter_add(buf, idx, vals), mesh)


def combine_scatter_max(n_pad: int, idx, cand, dtype, mesh):
    fill = False if dtype == torch.bool else -rt.inf_for(dtype)
    buf = torch.full((n_pad,), fill, dtype=dtype, device=idx.device)
    return pmax(rt.scatter_max(buf, idx, cand), mesh)


def combine_scatter_add_rows(n_pad: int, idx, vals, dtype, mesh):
    """Batched-lane combine: vals [S, E] scattered by idx [E] into a
    [S, n_pad] buffer and summed across ranks (one combine for all lanes)."""
    buf = torch.zeros((vals.shape[0], n_pad), dtype=dtype, device=idx.device)
    return psum(rt.scatter_add_rows(buf, idx, vals.to(dtype)), mesh)


def dist_should_push(frontier_full, threshold_frac: float) -> bool:
    """Replicated-frontier occupancy test: True when the frontier is sparse
    enough that a push superstep (scatter + global combine) beats the pull
    form (local segment reduction over the gathered arrays). The input is
    a full [N_pad] (or [S, N_pad]) mask every rank holds alike, so every
    rank reads the same answer (one host read)."""
    cap = max(int(frontier_full.numel() * threshold_frac), 1)
    return int(torch.sum(frontier_full, dtype=torch.int64)) <= cap


# --------------------------------------------------------------------------
# Distributed BFS (iterateInBFS construct)
# --------------------------------------------------------------------------

def _bfs_1d(level0, gather_fn, exchange_fn, push, pull, own_ids, n_elems, *,
            frontier, gather_frac, direction, threshold_frac, mesh):
    """The level-synchronous loop shared by the single-root and the batched
    BFS; `push`/`pull` map (level_full, cur) to the reached mask."""
    level_blk = level0
    level_full = gather_fn(level0, mesh)
    elems = torch.tensor(float(level_full.numel()), dtype=torch.float32,
                         device=own_ids.device)
    cur, going = 0, True
    while going:
        if direction == "push" or (direction == "auto" and dist_should_push(
                level_full == cur, threshold_frac)):
            reach_blk = push(level_full, cur)
        else:
            reach_blk = pull(level_full, cur)
        newly = reach_blk & (level_blk < 0)
        level_blk = torch.where(newly, cur + 1, level_blk)
        if frontier == "dense":
            level_full = gather_fn(level_blk, mesh)
            elems = elems + n_elems
        else:
            level_full, step = exchange_fn(level_full, level_blk, own_ids, gather_frac,
                                           mesh=mesh, skip_empty=(frontier == "auto"))
            elems = elems + step
        cur += 1
        going = bool(any_global(newly, mesh))
    return level_blk, cur, elems


def bfs_levels_1d(esrc, edst, evalid, isrc, idst_local, ivalid, own_ids,
                  root, n_pad: int, *, frontier: str = "dense",
                  gather_frac: float = 0.25, direction: str = "auto",
                  threshold_frac: float = 1.0 / 16.0, mesh):
    """Level-synchronous distributed BFS over the 1-D partition.

    `frontier` is the Schedule's `dist_frontier` policy for the per-level
    exchange of the level array; `direction` picks the expansion:

      push — scatter reached-flags over out-edges of frontier vertices and
             combine globally (a sum over [N_pad], the paper's scheme);
      pull — each rank segment-reduces over its *in*-edge partition from
             the replicated level array: no combine collective at all;
      auto — per-level Beamer switch on frontier occupancy against
             `threshold_frac` (rank-uniform: the frontier is replicated).

    Both directions mark exactly the unseen out-neighborhood of the
    frontier, so the choice never changes results. Returns
    (level_blk int32[B], depth (a Python int), gathered_elems float32, as
    in the reference: exact to 2^24)."""
    b = own_ids.shape[0]
    level0 = torch.where(own_ids == root, 0, -1).to(torch.int32)

    def push(level_full, cur):
        src_on = (level_full[esrc] == cur) & evalid
        unseen = level_full[edst] < 0
        reach = combine_scatter_add(n_pad, edst, (src_on & unseen).to(torch.int32),
                                    torch.int32, mesh)
        return reach[own_ids] > 0

    def pull(level_full, cur):
        on = (level_full[isrc] == cur) & ivalid
        return rt.segment_max(on.to(torch.int32), idst_local, b, sorted_ids=False) > 0

    return _bfs_1d(level0, gather, exchange, push, pull, own_ids, n_pad,
                   frontier=frontier, gather_frac=gather_frac, direction=direction,
                   threshold_frac=threshold_frac, mesh=mesh)


def bfs_levels_1d_batch(esrc, edst, evalid, isrc, idst_local, ivalid,
                        own_ids, roots, n_pad: int, *,
                        frontier: str = "dense", gather_frac: float = 0.25,
                        direction: str = "auto",
                        threshold_frac: float = 1.0 / 16.0, mesh):
    """Batched `bfs_levels_1d`: one BSP loop serves all S roots. State is
    [S, B] per rank / [S, N_pad] replicated; the per-level exchange moves
    all lanes' frontiers through one shared compact buffer, and the
    direction is chosen once per level for the whole batch. Returns
    (level_blk int32[S, B], depth, gathered_elems); depth is the deepest
    lane's level count."""
    b = own_ids.shape[0]
    level0 = torch.where(own_ids[None, :] == roots[:, None], 0, -1).to(torch.int32)

    def push(level_full, cur):
        src_on = (level_full[:, esrc] == cur) & evalid
        unseen = level_full[:, edst] < 0
        reach = combine_scatter_add_rows(n_pad, edst, (src_on & unseen).to(torch.int32),
                                         torch.int32, mesh)
        return reach[:, own_ids] > 0

    def pull(level_full, cur):
        on = (level_full[:, isrc] == cur) & ivalid
        return rt.segment_max_batch(on.to(torch.int32), idst_local, b,
                                    sorted_ids=False) > 0

    return _bfs_1d(level0, gather_rows, exchange_rows, push, pull, own_ids,
                   roots.shape[0] * n_pad, frontier=frontier, gather_frac=gather_frac,
                   direction=direction, threshold_frac=threshold_frac, mesh=mesh)


# --------------------------------------------------------------------------
# Distributed triangle counting (wedge pattern over own rows)
# --------------------------------------------------------------------------

_WEDGE_CELL_BYTES = 32   # live bytes per (v, u, w) cell: int64 query and
#                          position, the gathered key, bool masks


def wedge_count_1d(ell_cols, own_ids, edge_key, n_true, mesh, chunk: int = 256,
                   budget_bytes: int = rt.WEDGE_BUDGET_BYTES):
    """The paper's Fig. 20 wedge count over the owned rows, summed across
    ranks: for v, u in N(v) with u < v, w in N(v) with w > v, count
    (u, w) ∈ E by a search of the sorted int32 edge key.

    Where the reference walks the owned rows in order, each padded to the
    graph's largest degree, here the rows go in ascending degree order
    (rows of degree < 2 have no wedge), each chunk of at most `chunk`
    rows is cut to its own largest degree D, and shrinks until its
    [C, D, D] block fits `budget_bytes`: the count does not depend on
    either. The key holds src * N + dst in int32, so N must stay below
    46,341 (the reference would wrap)."""
    if n_true * n_true >= 2**31:
        raise ValueError(
            f"wedge_count_1d: the int32 edge key of the 1-D layout holds "
            f"N < 46,341 vertices, not {n_true}")
    dev = ell_cols.device
    deg = (ell_cols < n_true).sum(dim=1).cpu().numpy()
    order = np.argsort(deg, kind="stable")
    order = order[deg[order] >= 2]
    key = edge_key.long()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    start = 0
    while start < order.shape[0]:
        c = min(chunk, order.shape[0] - start)
        while c > 1 and c * int(deg[order[start + c - 1]]) ** 2 * _WEDGE_CELL_BYTES \
                > budget_bytes:
            c //= 2
        d = int(deg[order[start + c - 1]])
        ridx = torch.from_numpy(order[start:start + c]).to(dev)
        rows = ell_cols[ridx, :d].long()
        valid = rows < n_true
        u = rows[:, :, None]
        w = rows[:, None, :]
        vv = own_ids[ridx].long()[:, None, None]
        mask = valid[:, :, None] & valid[:, None, :] & (u < vv) & (w > vv)
        q = u * n_true + w
        pos = torch.clamp(torch.searchsorted(key, q), max=key.shape[0] - 1)
        total += torch.sum(mask & (key[pos] == q))
        start += c
    return psum(total, mesh).to(torch.int32)
