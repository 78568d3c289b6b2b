"""Graph partitions for the distributed backend: the port of
`repro.graph.partition`.

1. `block_partition_1d` — the paper's MPI layout (§3.1/§4.2): contiguous
   equal-size vertex blocks, one per shard ("index-based partitioning"),
   the last block padded ("we pad temporary vertices for the last
   process"). Every shard owns the out-edges of its vertex block.

2. `partition_2d` — the CombBLAS-style 2-D blocking for an R×C
   (data × model) grid: rank (i, j) holds the edges with dst ∈ block_i
   (contiguous, N/R vertices) and src ∈ colset_j (the interleaved pieces
   {b : b mod C == j}). Vertex state is sharded N/(R·C) per rank (piece
   b = i·C + j), so one relax step moves N/C gathered plus N/(R·C)
   reduce-scattered elements a rank instead of the 1-D N
   (`core.dist2d`).

Edge counts differ per shard or tile, so each row is padded to the
largest with inert sentinel edges (src=dst=0, weight=INF, valid=0).
Host-side numpy, stacked on leading shard axes as in the reference; each
rank moves only the real edges of its own row or tile to its device
(`core.runtime_dist.shard_arrays`, `core.dist2d.shard_tile`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import INF_I32, CSRGraph


@dataclasses.dataclass(frozen=True)
class Partition1D:
    """Edges partitioned by source-vertex block; stacked [P, Emax]."""
    src: np.ndarray      # int32[P, Emax]  global src id
    dst: np.ndarray      # int32[P, Emax]  global dst id
    weight: np.ndarray   # int32[P, Emax]
    valid: np.ndarray    # bool [P, Emax]
    num_devices: int
    block: int           # vertices per shard (padded)
    num_nodes_padded: int


def partition_edges_1d(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                       num_nodes: int, num_shards: int) -> Partition1D:
    """Edges (src, dst, w) in CSR order, split by the block that owns `src`;
    each shard keeps its edges in their input order."""
    p = num_shards
    block = -(-num_nodes // p)
    owner = src // block
    emax = max(int(np.bincount(owner, minlength=p).max()) if len(src) else 0, 1)
    out_src = np.zeros((p, emax), np.int32)
    out_dst = np.zeros((p, emax), np.int32)
    out_w = np.full((p, emax), int(INF_I32), np.int32)
    out_valid = np.zeros((p, emax), bool)
    for d in range(p):
        sel = owner == d
        k = int(sel.sum())
        out_src[d, :k] = src[sel]
        out_dst[d, :k] = dst[sel]
        out_w[d, :k] = w[sel]
        out_valid[d, :k] = True
    return Partition1D(out_src, out_dst, out_w, out_valid, p, block, block * p)


def block_partition_1d(g: CSRGraph, num_devices: int) -> Partition1D:
    """The out-edges of `g` by source block (the reference's signature)."""
    return partition_edges_1d(g.edge_src.cpu().numpy(), g.indices.cpu().numpy(),
                              g.weights.cpu().numpy(), g.num_nodes, num_devices)


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """Adjacency tiles for an R×C (data × model) grid.

    Index remapping (host-side, baked into the edge arrays):
      - `src_local[i,j,e]` = position of the edge's source inside the
        all-gathered x_j (the i-ordered concat of pieces {b : b mod C == j});
      - `dst_local[i,j,e]` = position of the edge's dest inside dst block i
        (the contiguous range [i*N/R, (i+1)*N/R))."""
    src_local: np.ndarray   # int32[R, C, Emax]
    dst_local: np.ndarray   # int32[R, C, Emax]
    weight: np.ndarray      # int32[R, C, Emax]
    valid: np.ndarray       # bool [R, C, Emax]
    rows: int               # R (data axis size)
    cols: int               # C (model axis size)
    piece: int              # vertices per rank's piece (padded)
    num_nodes_padded: int

    @property
    def block_rows(self) -> int:   # dst block size N/R
        return self.piece * self.cols

    @property
    def block_cols(self) -> int:   # src block size N/C
        return self.piece * self.rows


def partition_2d(g: CSRGraph, rows: int, cols: int) -> Partition2D:
    """The edges of `g` in R×C tiles (the reference's signature and arrays,
    pads included); each tile keeps its edges in CSR order."""
    r, c = rows, cols
    piece = -(-g.num_nodes // (r * c))
    src = g.edge_src.cpu().numpy().astype(np.int64)
    dst = g.indices.cpu().numpy().astype(np.int64)
    w = g.weights.cpu().numpy()
    # piece of a vertex v: b = v // piece; its owner (i, j) = divmod(b, c)
    b_src = src // piece
    j_of = b_src % c                              # src column set
    i_of = dst // piece // c                      # dst row block
    # src inside the gathered x_j: pieces in i' = b // c order
    src_local = (b_src // c) * piece + src % piece
    dst_local = dst - i_of * (piece * c)
    tile = i_of * c + j_of
    emax = max(int(np.bincount(tile, minlength=r * c).max()) if len(src) else 0, 1)
    o_src = np.zeros((r, c, emax), np.int32)
    o_dst = np.zeros((r, c, emax), np.int32)
    o_w = np.full((r, c, emax), int(INF_I32), np.int32)
    o_valid = np.zeros((r, c, emax), bool)
    for i in range(r):
        for j in range(c):
            sel = tile == i * c + j
            k = int(sel.sum())
            o_src[i, j, :k] = src_local[sel]
            o_dst[i, j, :k] = dst_local[sel]
            o_w[i, j, :k] = w[sel]
            o_valid[i, j, :k] = True
    return Partition2D(o_src, o_dst, o_w, o_valid, r, c, piece, piece * r * c)


def piece_order_to_global(part: Partition2D) -> np.ndarray:
    """global_id[i, j, k] of piece-sharded state: rank (i, j) owns the
    vertices [(i*C + j)*piece, ... + piece)."""
    r, c, piece = part.rows, part.cols, part.piece
    base = (np.arange(r * c) * piece).reshape(r, c)
    return base[..., None] + np.arange(piece)[None, None, :]
