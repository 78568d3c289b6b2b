"""1-D block partition of a graph for the distributed backend.

The port of `repro.graph.partition`'s 1-D scheme, the paper's MPI layout
(§3.1/§4.2): contiguous equal-size vertex blocks, one per shard ("index-
based partitioning"), the last block padded ("we pad temporary vertices
for the last process"). Every shard owns the out-edges of its vertex
block. Edge counts differ per shard, so each shard's edge row is padded to
the largest with inert sentinel edges (src=dst=0, weight=INF, valid=0).

Host-side numpy, stacked on a leading [P] shard axis; each rank moves its
own row to its device (`core.runtime_dist.prepare_graph_1d`).
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
