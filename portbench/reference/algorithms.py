"""Plain PyTorch reference algorithms over the benchmark's own edge list.

Each works from the forward edges (src, dst, weight) of the benchmark's CSR
and nothing of the program under test, and computes a block of sources at
a time as [b, N] rows with [b, E] temporaries, so that it fits on the card
beside what is left once the program's state is freed. Every function
takes `dtype` (or `rounds_short`) so that the same code serves as the
lower-precision control.

Semantics are the bundled programs' as the StarPlat paper defines them:

* `bellman_ford` — weighted shortest distances over out-edges; an
  unreached vertex holds INF = 2**30.
* `bfs_levels` — hop levels over out-edges; -1 where unreached.
* `brandes` — betweenness summed over the given sources, over each
  source's out-edge BFS DAG (Brandes' dependency accumulation).
* `ppr` — per-source personalized PageRank: rank' = (1 - delta) * e_s +
  delta * sum over in-edges u -> v of rank(u) / outdeg(u), a lane stopping
  after the sweep whose L1 change is at most beta, or after max_iter sweeps.
* `pagerank` — the same iteration with the uniform restart 1 / N and the
  uniform start.
"""
from __future__ import annotations

import torch

INF = 2**30


class Edges:
    """Forward edges of a graph as int64 index tensors on one device."""

    def __init__(self, fields: dict, num_nodes: int):
        self.n = int(num_nodes)
        self.src = fields["edge_src"].long()
        self.dst = fields["indices"].long()
        self.w = fields["weights"].to(torch.int32)
        self.out_degree = torch.bincount(self.src, minlength=self.n)

    @property
    def device(self):
        return self.src.device


def _blocks(sources, block):
    sources = torch.as_tensor(sources, dtype=torch.int64)
    for i in range(0, sources.shape[0], block):
        yield sources[i:i + block]


def bellman_ford(g: Edges, sources, *, block: int = 8, rounds_short: int = 0):
    """dist int32 [S, N] on the host. `rounds_short` > 0 returns the state
    that many rounds before the last round that changed anything (the
    control: a fixed point stopped early)."""
    out = []
    for srcs in _blocks(sources, block):
        b = srcs.shape[0]
        srcs = srcs.to(g.device)
        dist = torch.full((b, g.n), INF, dtype=torch.int32, device=g.device)
        dist[torch.arange(b, device=g.device), srcs] = 0
        idx = g.dst.expand(b, -1)
        history = [dist]
        while True:
            cand = dist[:, g.src] + g.w
            new = dist.scatter_reduce(1, idx, cand, "amin", include_self=True)
            del cand
            if torch.equal(new, dist):
                break
            dist = new
            history = (history + [dist])[-(rounds_short + 1):]
        out.append(history[0].cpu())
        del dist, new, history
    return torch.cat(out)


def _levels(g: Edges, srcs, rounds_short: int = 0):
    """BFS levels int32 [b, N] (-1 unreached) and the depth reached."""
    b = srcs.shape[0]
    lanes = torch.arange(b, device=g.device)
    level = torch.full((b, g.n), -1, dtype=torch.int32, device=g.device)
    level[lanes, srcs] = 0
    idx = g.dst.expand(b, -1)
    depth = 0
    while True:
        front = (level == depth).to(torch.int32)
        reach = torch.zeros_like(front).scatter_reduce(1, idx, front[:, g.src], "amax")
        newly = (reach > 0) & (level < 0)
        if not bool(newly.any()):
            break
        level = torch.where(newly, depth + 1, level)
        depth += 1
    if rounds_short:
        level = torch.where(level > depth - rounds_short, -1, level)
        depth -= rounds_short
    return level, depth


def bfs_levels(g: Edges, sources, *, block: int = 8, rounds_short: int = 0):
    """level int32 [S, N] on the host; `rounds_short` drops the last levels
    (the control)."""
    out = []
    for srcs in _blocks(sources, block):
        level, _ = _levels(g, srcs.to(g.device), rounds_short)
        out.append(level.cpu())
    return torch.cat(out)


def brandes(g: Edges, sources, *, block: int = 4, dtype=torch.float64):
    """Betweenness [N] (`dtype`, on the host) summed over `sources`."""
    bc = torch.zeros(g.n, dtype=dtype, device=g.device)
    for srcs in _blocks(sources, block):
        srcs = srcs.to(g.device)
        b = srcs.shape[0]
        level, depth = _levels(g, srcs)
        lev_src = level[:, g.src]
        dag = level[:, g.dst] == lev_src + 1
        sigma = torch.zeros((b, g.n), dtype=dtype, device=g.device)
        sigma[torch.arange(b, device=g.device), srcs] = 1
        idx_dst = g.dst.expand(b, -1)
        idx_src = g.src.expand(b, -1)
        for k in range(depth):
            m = dag & (lev_src == k)
            sigma.scatter_add_(1, idx_dst, torch.where(m, sigma[:, g.src], 0))
        delta = torch.zeros_like(sigma)
        one = torch.ones((), dtype=dtype, device=g.device)
        for k in range(depth - 1, -1, -1):
            m = dag & (lev_src == k)
            safe = torch.where(sigma > 0, sigma, one)
            term = torch.where(m, ((1 + delta) / safe)[:, g.dst], 0)
            acc = torch.zeros_like(sigma).scatter_add_(1, idx_src, term)
            delta = torch.where(level == k, sigma * acc, delta)
            del term, acc, m
        bc += torch.where(level > 0, delta, 0).sum(0, dtype=dtype)
        del lev_src, dag, sigma, delta, level
    return bc.cpu()


def _power(g: Edges, restart, start, beta, delta, max_iter, dtype):
    inv = 1.0 / torch.clamp(g.out_degree, min=1).to(dtype)
    b = restart.shape[0]
    idx = g.dst.expand(b, -1)
    rank = start
    act = torch.ones(b, dtype=torch.bool, device=g.device)
    it = 0
    while bool(act.any()):
        contrib = (rank * inv)[:, g.src]
        pulled = torch.zeros_like(rank).scatter_add_(1, idx, contrib)
        del contrib
        nxt = (1 - delta) * restart + delta * pulled
        diff = (nxt - rank).abs().sum(1, dtype=dtype)
        rank = torch.where(act[:, None], nxt, rank)
        it += 1
        act = act & (diff > beta) & (it < max_iter)
    return rank


def ppr(g: Edges, sources, *, beta: float, delta: float, max_iter: int,
        block: int = 8, dtype=torch.float64):
    """Per-source personalized PageRank rows [S, N] (`dtype`, host)."""
    out = []
    for srcs in _blocks(sources, block):
        srcs = srcs.to(g.device)
        b = srcs.shape[0]
        restart = torch.zeros((b, g.n), dtype=dtype, device=g.device)
        restart[torch.arange(b, device=g.device), srcs] = 1
        out.append(_power(g, restart, restart, beta, delta, max_iter, dtype).cpu())
    return torch.cat(out)


def pagerank(g: Edges, *, beta: float, delta: float, max_iter: int,
             dtype=torch.float64):
    """PageRank [N] (`dtype`, host) from the uniform start."""
    uni = torch.full((1, g.n), 1.0 / g.n, dtype=dtype, device=g.device)
    return _power(g, uni, uni, beta, delta, max_iter, dtype)[0].cpu()
