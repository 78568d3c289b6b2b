"""The 2-D adjacency-partitioned path of the distributed backend: the port
of `repro.core.dist2d`.

The paper's MPI backend is 1-D: every BSP step moves O(N) property
elements a rank (the all-gather of the frontier, the combine of the
candidates). The classic fix (CombBLAS / 2-D SpMV) blocks the adjacency
over an R×C grid of ranks, mesh axes ("data", "model"), so a step moves

    all-gather over "data"      : N/C elements a rank (the source block)
    reduce-scatter over "model" : N/R elements a rank (the dest partials)

State lives as N/(R·C) pieces, one a rank (piece b = i·C + j at grid
position (i, j), which is rank b); the edge tiles carry the pre-remapped
local indices of `graph.partition.partition_2d`.

SPMD, one process per rank, as the 1-D backend: every rank builds the same
graph, makes the same `make_mesh((R, C), ("data", "model"))` and the same
call, and gets the global result back. The reference's `specs_2d` (the
`PartitionSpec`s of the tiles) has no counterpart: torch has no sharding
specs, and each rank moves only its own tile to its device
(`shard_tile`). Every loop condition is read on the host from a value
summed over both axes, so every rank takes the same branch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import INF_I32, CSRGraph
from ..graph.partition import partition_2d
from . import runtime as rt
from . import runtime_dist as rtd

DATA, MODEL = "data", "model"
_EDGE_KEYS = ("src_local", "dst_local", "weight", "valid")


def prepare_graph_2d(g: CSRGraph, rows: int, cols: int) -> dict:
    """Every rank's edge tiles and the metadata, numpy, stacked [R, C, ...]
    (the reference's dict)."""
    part = partition_2d(g, rows, cols)
    return {
        "src_local": part.src_local,
        "dst_local": part.dst_local,
        "weight": part.weight,
        "valid": part.valid,
        "piece": part.piece,
        "rows": rows, "cols": cols,
        "n_true": g.num_nodes,
        "out_degree": g.out_degree.cpu().numpy(),
    }


def shard_tile(host: dict, rank: int, device) -> dict:
    """Rank `rank`'s tile of `prepare_graph_2d`'s arrays on `device`.

    The tile keeps only its real edges (a prefix of its padded row): on the
    card the padding edges, all aimed at local slot 0, would serialize the
    atomics of every segment reduction on that one address. The two index
    arrays move as int64, so no superstep converts them. Beside the edges:
    `own_ids`, the global ids of this rank's piece, and `deg_xj`, the
    out-degrees (at least 1) of the gathered source block x_j in its
    i-interleaved order, for pagerank."""
    r, c, piece, n = host["rows"], host["cols"], host["piece"], host["n_true"]
    i, j = divmod(rank, c)
    k = int(host["valid"][i, j].sum())

    def move(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if dtype is None else t.to(dtype)
    tile = {key: move(host[key][i, j, :k],
                      torch.int64 if key.endswith("_local") else None) for key in _EDGE_KEYS}
    deg = np.zeros(piece * r * c, np.float32)
    deg[:n] = np.maximum(host["out_degree"], 1)
    # column j gathers the pieces [j, C + j, 2C + j, ...] in i order
    tile["deg_xj"] = move(deg.reshape(r * c, piece)[np.arange(r) * c + j].reshape(-1))
    tile["own_ids"] = move((rank * piece + np.arange(piece)).astype(np.int32))
    tile.update(piece=piece, rows=r, cols=c, n_true=n)
    return tile


def prepare(g: CSRGraph, mesh) -> dict:
    """This rank's tile of `g` over `mesh`'s ("data", "model") grid,
    memoized in the graph's `GraphContext` (by grid shape, rank and
    device)."""
    from .context import get_context
    return get_context(g).dist_tile_2d(mesh.shape[DATA], mesh.shape[MODEL],
                                       rank=mesh.rank, device=mesh.device)


def gather_global(piece, mesh) -> torch.Tensor:
    """Every rank's piece, concatenated in rank (= piece) order on every
    rank: over "model" (the pieces of dst block i), then over "data"."""
    return rtd.gather(rtd.gather(piece, mesh.axis(MODEL)), mesh.axis(DATA))


# --------------------------------------------------------------------------
# SSSP (2-D relax until fixed point)
# --------------------------------------------------------------------------

def sssp_tile(tile: dict, mesh, src: int = 0):
    """Bellman-Ford supersteps over this rank's tile until no rank's piece
    changes; returns (this rank's piece of dist, supersteps)."""
    data, model = mesh.axis(DATA), mesh.axis(MODEL)
    inf = int(INF_I32)
    dist = torch.where(tile["own_ids"] == src, 0, inf).to(torch.int32)
    block_rows = tile["piece"] * tile["cols"]      # destination block size N/R
    steps, changed = 0, True
    while changed:
        xj = rtd.gather(dist, data)                                   # [piece*R]
        cand = torch.where(tile["valid"], xj[tile["src_local"]] + tile["weight"], inf)
        part = rt.segment_min(cand, tile["dst_local"], block_rows, sorted_ids=False)
        new = torch.minimum(dist, rtd.reduce_scatter_min(part, model))
        flag = rtd.psum(rtd.psum(torch.any(new < dist).to(torch.int32), data), model)
        dist, steps, changed = new, steps + 1, bool(flag > 0)
    return dist, steps


def sssp_2d(g: CSRGraph, mesh, src: int = 0):
    """Single-source shortest paths over the ("data", "model") grid: the
    global int32 [N] dist on every rank. `sssp_2d.supersteps` holds the
    last call's superstep count."""
    dist, sssp_2d.supersteps = sssp_tile(prepare(g, mesh), mesh, src)
    return gather_global(dist, mesh)[: g.num_nodes]


sssp_2d.supersteps = 0


# --------------------------------------------------------------------------
# PageRank (2-D gather until convergence)
# --------------------------------------------------------------------------

def pagerank_tile(tile: dict, mesh, delta: float = 0.85, beta: float = 1e-4,
                  max_iter: int = 100):
    """PageRank sweeps over this rank's tile until the L1 change summed
    over every rank is at most `beta` or `max_iter` sweeps ran (at least
    one); returns (this rank's piece of the ranks, sweeps).

    PR pulls over the in-edges of v, i.e. exactly the edge set u→v: tile
    (i, j) holds the edges with v ∈ block_i (the accumulator side, "data")
    and u ∈ colset_j (the contributor side, "model")."""
    data, model = mesh.axis(DATA), mesh.axis(MODEL)
    n, own = tile["n_true"], tile["own_ids"]
    pr = torch.full((tile["piece"],), 1.0 / n, dtype=torch.float32, device=own.device)
    block_rows = tile["piece"] * tile["cols"]
    it, going = 0, True
    while going:
        contrib = rtd.gather(pr, data) / tile["deg_xj"]
        term = torch.where(tile["valid"], contrib[tile["src_local"]], 0.0)
        part = rt.segment_sum(term, tile["dst_local"], block_rows, sorted_ids=False)
        val = (1 - delta) / n + delta * rtd.reduce_scatter_sum(part, model)
        val = torch.where(own < n, val, 0.0)
        diff = rtd.psum(rtd.psum(torch.sum(torch.abs(val - pr)), data), model)
        pr, it = val, it + 1
        going = bool(diff > beta) and it < max_iter
    return pr, it


def pagerank_2d(g: CSRGraph, mesh, delta: float = 0.85, beta: float = 1e-4,
                max_iter: int = 100):
    """PageRank over the ("data", "model") grid: the global float32 [N]
    ranks on every rank. `pagerank_2d.iterations` holds the last call's
    sweep count."""
    pr, pagerank_2d.iterations = pagerank_tile(prepare(g, mesh), mesh, delta, beta,
                                               max_iter)
    return gather_global(pr, mesh)[: g.num_nodes]


pagerank_2d.iterations = 0
