"""Graph-level relax/gather ops on the ELL kernels.

These are what the DSL's `cuda` backend emits calls to. Two layouts
coexist, as in the reference:

  * dense ELL (`prepare_ell` → cols/wts tensors): the single `[N, max_deg]`
    view — the kernel unit tests and the baseline;
  * sliced ELL (`prepare_sliced_ell` → `SlicedEllGraph`): degree-bucketed
    tiles + a COO hub tail — the frontier-aware engine's layout.
    `relax_minplus` / `gather_plustimes` dispatch on the first argument.

A single-vector ([N]) sliced pull is one `ell_sweep` over the view's
`SweepPlan` (`plan.sweep_plan`, built once per view): buckets, hub tail and
rows of in-degree 0 in one launch that writes each row once — the CUDA
kernel for tensors on the card, `ell_sweep_ref` for tensors on the CPU.
The dense ops and the batched ([B, N]) sliced ops go through the
rectangular `ell_spmv`, bucket by bucket; there the reference's
`mode="drop"` scatters into row-padding slots (row id `N`) become scatters
into a spare `N`-th slot of an `N + 1` buffer that is sliced off; those
buffers are fresh and are updated in place.

`lax.cond` becomes a Python `if` on one device scalar read on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ...graph.csr import CSRGraph, INF_I32, SlicedEllGraph, to_ell, to_sliced_ell
from .kernel import ell_spmv, ell_sweep
from .plan import sweep_plan

INF = int(INF_I32)


def prepare_ell(g: CSRGraph, *, reverse: bool = False, block_rows: int = 256):
    """Host-side: build the padded dense-ELL tensors once per graph.

    Returns (cols, wts, block). cols pad slots point at the sentinel row
    (index n_pad); wts pad slots are INF (masked out by the semiring)."""
    ell = to_ell(g, reverse=reverse)
    n = g.num_nodes
    cols = ell.cols.cpu().numpy().copy()
    wts = ell.wts.cpu().numpy()
    block = min(block_rows, -(-n // 8) * 8)   # 8-aligned, capped at block_rows
    pad = (-n) % block
    n_pad = n + pad
    cols[cols == n] = n_pad                   # sentinel = last slot of padded x
    if pad:
        cols = np.concatenate([cols, np.full((pad, cols.shape[1]), n_pad, np.int32)])
        wts = np.concatenate([wts, np.full((pad, wts.shape[1]), INF, np.int32)])
    dev = g.device
    return torch.from_numpy(cols).to(dev), torch.from_numpy(wts).to(dev), block


def prepare_sliced_ell(g: CSRGraph, *, reverse: bool = True, schedule=None,
                       **knobs) -> SlicedEllGraph:
    """Host-side: degree-bucketed view for the frontier-aware engine.
    Default orientation is reverse (in-edges) — the pull layout. Prefer
    `repro_torch.core.context.GraphContext.sliced_ell`, which memoizes this
    per (graph, layout)."""
    return to_sliced_ell(g, reverse=reverse, schedule=schedule, **knobs)


def _extend(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[N] → [rows] or [B, N] → [rows, B] (lanes minor), zero-filled past N:
    the gather operand with its sentinel slot(s) holding 0."""
    if x.ndim == 2:
        out = torch.zeros((rows, x.shape[0]), dtype=x.dtype, device=x.device)
        out[: x.shape[1]] = x.T
    else:
        out = torch.zeros((rows,), dtype=x.dtype, device=x.device)
        out[: x.shape[0]] = x
    return out


def _row_index(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """int64 scatter index for writing `like` [R, B] into rows."""
    return rows.long()[:, None].expand(like.shape)


# --------------------------------------------------------------------------
# dense-ELL ops (baseline layout)
# --------------------------------------------------------------------------

def _relax_dense(cols, wts, dist):
    """One dense SSSP relax sweep over the single-width ELL view."""
    n = dist.shape[0]
    n_pad = cols.shape[0]
    # padded slots + the sentinel hold 0 — never read as real neighbors,
    # and 0 keeps INF (pad weight) + x from overflowing int32
    x = _extend(dist, n_pad + 1)
    y = ell_spmv(cols, wts, x, semiring="minplus")
    return torch.minimum(dist, y[:n])


def _gather_dense(cols, contrib):
    n_pad = cols.shape[0]
    ones = torch.where(cols == n_pad, 0.0, 1.0).to(contrib.dtype)
    x = _extend(contrib, n_pad + 1)
    return ell_spmv(cols, ones, x, semiring="plustimes")


# --------------------------------------------------------------------------
# sliced-ELL ops (frontier-aware engine)
# --------------------------------------------------------------------------

def _bucket_plustimes(cols, x):
    ones = torch.ones(cols.shape, dtype=x.dtype, device=x.device)  # pads hit the 0 sentinel
    return ell_spmv(cols, ones, x, semiring="plustimes")


def _relax_sliced_pull(ell: SlicedEllGraph, dist, frontier=None):
    """Masked-pull sweep. Frontier masking happens on the gather source
    (x), so the kernel stays unmasked. dist [N] is one `ell_sweep` (x is
    the only N-sized pass besides it); dist [B, N] runs per-bucket min-plus
    SpMM kernels over the [N+1, B] operand, then the COO hub tail. This and
    `_relax_push` are the kernel-layer copies of the push/pull relaxation —
    keep in sync with runtime.relax_minplus_hybrid."""
    n = ell.num_nodes
    x = dist if frontier is None else torch.where(frontier, dist, INF)
    if dist.ndim == 1:
        return ell_sweep(ell, sweep_plan(ell), x, semiring="minplus", dist=dist)
    x_ext = _extend(x, n + 1)               # sentinel slot n holds 0
    y = torch.full(x_ext.shape, INF, dtype=dist.dtype, device=dist.device)
    for cols, wts, rows in zip(ell.cols, ell.wts, ell.rows):
        out = ell_spmv(cols, wts, x_ext, semiring="minplus")
        y.scatter_reduce_(0, _row_index(rows, out), out, "amin")
    if ell.hub_rows.shape[0]:
        cand = x_ext[ell.hub_cols] + ell.hub_wts[:, None]
        y.scatter_reduce_(0, _row_index(ell.hub_rows, cand), cand, "amin")
    return torch.minimum(dist, y[:n].T)


def _relax_push(g: CSRGraph, dist, frontier):
    """Scatter-push from the (sparse) frontier over out-edges.
    dist/frontier: [N] or [B, N] (row-wise scatter-min)."""
    if dist.ndim == 2:
        cand = dist[:, g.edge_src] + g.weights[None, :]
        cand = torch.where(frontier[:, g.edge_src], cand, INF)
        idx = g.indices.long()[None, :].expand(cand.shape)
        return dist.scatter_reduce(1, idx, cand, "amin")
    cand = dist[g.edge_src] + g.weights
    cand = torch.where(frontier[g.edge_src], cand, INF)
    return dist.scatter_reduce(0, g.indices.long(), cand, "amin")


def relax_minplus(cols_or_ell, wts_or_dist, dist=None, *, frontier=None,
                  csr: CSRGraph | None = None, block_rows=256,
                  threshold_frac: float | None = None,
                  direction: str = "auto"):
    """One SSSP relax step.

    Dense form: `relax_minplus(cols, wts, dist)` — full pull sweep over the
    `[N, max_deg]` reverse-ELL view.

    Sliced form (engine): `relax_minplus(ell, dist, frontier=fr, csr=g)` —
    frontier-masked, direction-optimized: when the frontier occupancy is
    at most `max(int(N * threshold_frac), 1)` the relax runs push-style
    over the CSR out-edges (scatter-min), otherwise as per-bucket pull
    kernels. `direction="push"|"pull"` pins one branch. Both directions
    compute the identical relaxation, so the switch never changes results.

    Batched sliced form: dist/frontier [B, N] — the pull sweep is a
    per-bucket min-plus SpMM over the [N+1, B] operand, and the push/pull
    choice is made per batch row (mixed batches run each direction masked
    to its rows, which partition the frontier, so the result is exact).

    `block_rows` (`Schedule.block_rows`: an int, or a {bucket_width: cap}
    mapping) is accepted for the reference's signature and ignored: the
    CUDA launch shape is fixed, and the knob never changes a result."""
    if not isinstance(cols_or_ell, SlicedEllGraph):
        return _relax_dense(cols_or_ell, wts_or_dist, dist)
    if dist is not None:
        raise TypeError(
            "sliced form takes (ell, dist) positionally; pass the frontier "
            "as relax_minplus(ell, dist, frontier=fr, csr=g)")
    ell, dist = cols_or_ell, wts_or_dist
    if frontier is None or csr is None:
        # dense sweep (or no CSR for push): pull is the only orientation
        return _pull_step(ell, dist, frontier)
    if direction == "push":
        return _push_step(csr, dist, frontier)
    if direction == "pull":
        return _pull_step(ell, dist, frontier)
    from ...core.runtime import (_cond_by_rows, frontier_rows_should_push,
                                 frontier_should_push)
    if dist.ndim == 2:
        rows_push = frontier_rows_should_push(frontier, ell.num_nodes,
                                              threshold_frac)
        return _cond_by_rows(
            rows_push,
            lambda d: _push_step(csr, d, frontier),
            lambda d: _pull_step(ell, d, frontier),
            lambda d: _pull_step(
                ell, _push_step(csr, d, frontier & rows_push[:, None]),
                frontier & ~rows_push[:, None]),
            dist)
    if frontier_should_push(frontier, ell.num_nodes, threshold_frac):
        return _push_step(csr, dist, frontier)
    return _pull_step(ell, dist, frontier)


def _push_step(csr, dist, frontier):
    relax_minplus.push_steps += 1
    return _relax_push(csr, dist, frontier)


def _pull_step(ell, dist, frontier):
    relax_minplus.pull_steps += 1
    return _relax_sliced_pull(ell, dist, frontier)


# sliced relax steps taken per direction in this process (a run's trip
# count is their sum; the dense form counts neither)
relax_minplus.push_steps = 0
relax_minplus.pull_steps = 0


def gather_plustimes(cols_or_ell, contrib, n_out: int = None, *,
                     block_rows=256):
    """PR gather: y[v] = sum_{u in-nbr} contrib[u]; `contrib` already divided
    by out-degree.

    Dense form: `gather_plustimes(cols, contrib)` (returns padded rows).
    Sliced form: `gather_plustimes(ell, contrib)` (returns exactly [N]):
    one `ell_sweep`, whose f32 sums run in a fixed order on the card, so
    they are deterministic. Batched sliced form: contrib [B, N] → [B, N]
    (plus-times SpMM, one bucket pass shared by all B lanes; its hub tail
    adds with atomics on the card, so those f32 sums are
    order-nondeterministic). `block_rows` is ignored, as in
    `relax_minplus`."""
    if not isinstance(cols_or_ell, SlicedEllGraph):
        return _gather_dense(cols_or_ell, contrib)
    ell = cols_or_ell
    if contrib.ndim == 1:
        return ell_sweep(ell, sweep_plan(ell), contrib, semiring="plustimes")
    n = ell.num_nodes
    x_ext = _extend(contrib, n + 1)
    y = torch.zeros(x_ext.shape, dtype=contrib.dtype, device=contrib.device)
    for cols, rows in zip(ell.cols, ell.rows):
        y.index_add_(0, rows, _bucket_plustimes(cols, x_ext))
    if ell.hub_rows.shape[0]:
        y.index_add_(0, ell.hub_rows, x_ext[ell.hub_cols])
    return y[:n].T
