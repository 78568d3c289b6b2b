"""Runtime library for StarPlat-generated PyTorch code.

The port's counterpart of `repro.core.runtime`, for the single-device
subset the generated `local` and `cuda` programs of this slice call. Race
handling (the paper's atomics) stays structural: `scatter_min` is a
scatter-reduce with "amin" (min is order-independent, so it is
deterministic), pull reductions are segment reductions over the sorted
in-edge ids. Float sums by `segment_sum` / `scatter_add` run with atomics
on the card, so their rounding order is not fixed.

Where the reference branches on the device (`lax.cond`, `while_loop`),
generated code branches on the host: the predicates below read one device
scalar and return a Python bool.
"""
from __future__ import annotations

import torch

from ..graph.csr import INF_I32, CSRGraph
from ..schedule import DEFAULT_SCHEDULE

INF = int(INF_I32)   # a Python int, so int32 tensors stay int32 in arithmetic


def _identity_max(dtype: torch.dtype):
    """The value an empty segment holds after a min (jax.ops.segment_min)."""
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")


def _identity_min(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min if not dtype.is_floating_point else float("-inf")


# --- scatter / segment combine (the Min/Max construct, reductions) -----------

def scatter_min(current: torch.Tensor, idx: torch.Tensor, cand) -> torch.Tensor:
    """min-combine `cand` into `current` at positions `idx` (push relax)."""
    cand = torch.as_tensor(cand, dtype=current.dtype, device=current.device)
    return current.scatter_reduce(0, idx.long(), cand.expand(idx.shape), "amin")


def scatter_max(current, idx, cand):
    cand = torch.as_tensor(cand, dtype=current.dtype, device=current.device)
    return current.scatter_reduce(0, idx.long(), cand.expand(idx.shape), "amax")


def scatter_add(current, idx, vals):
    vals = torch.as_tensor(vals, dtype=current.dtype, device=current.device)
    return current.index_add(0, idx.long(), vals.expand(idx.shape))


def scatter_or(current, idx, vals):
    return scatter_max(current, idx, vals)   # bool max == or


def _segment(vals, seg_ids, num_segments, reduce, fill):
    out = torch.full((num_segments,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg_ids.long(), vals.expand(seg_ids.shape), reduce)


def segment_sum(vals, seg_ids, num_segments, sorted_ids=True):
    """`sorted_ids` is the reference's hint to XLA; the result never
    depends on it."""
    vals = torch.as_tensor(vals)
    out = torch.zeros((num_segments,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids.long(), vals.expand(seg_ids.shape))


def segment_min(vals, seg_ids, num_segments, sorted_ids=True):
    vals = torch.as_tensor(vals)
    return _segment(vals, seg_ids, num_segments, "amin", _identity_max(vals.dtype))


def segment_max(vals, seg_ids, num_segments, sorted_ids=True):
    vals = torch.as_tensor(vals)
    return _segment(vals, seg_ids, num_segments, "amax", _identity_min(vals.dtype))


# --- frontier engine (direction-optimizing traversal) --------------------------

def frontier_size(frontier: torch.Tensor) -> torch.Tensor:
    """On-device occupancy count of a dense bool frontier (int32, as in the
    reference; torch.sum of a bool gives int64)."""
    return torch.sum(frontier, dtype=torch.int32)


def frontier_should_push(frontier: torch.Tensor, n: int,
                         threshold_frac: float | None = None,
                         direction: str = "auto") -> bool:
    """True when the frontier is sparse enough that push (scatter from the
    few active sources) beats a pull sweep. The knob is
    `Schedule.push_threshold_frac` (fraction of N); `None` takes the
    default schedule's. A pinned `direction` short-circuits the test.
    Reads one device scalar."""
    if direction == "push":
        return True
    if direction == "pull":
        return False
    frac = DEFAULT_SCHEDULE.push_threshold_frac if threshold_frac is None \
        else threshold_frac
    return int(frontier_size(frontier)) <= max(int(n * frac), 1)


def relax_minplus_hybrid(g: CSRGraph, dist: torch.Tensor,
                         frontier: torch.Tensor | None = None,
                         threshold_frac: float | None = None,
                         direction: str = "auto",
                         weighted: bool = True) -> torch.Tensor:
    """One SSSP/min-plus relaxation restricted to `frontier` sources, with
    push/pull direction chosen on the host from the frontier's occupancy.

      push: scatter-min dist[u]+w over out-edges of frontier vertices
      pull: per-vertex min over in-edges, sources masked to the frontier

    Both compute dist'[v] = min(dist[v], min_{(u,v)∈E, frontier[u]} dist[u]+w)
    exactly, so the switch never changes results. `frontier=None` is a dense
    sweep; `weighted=False` drops the `+ w` term.

    NOTE: this push/pull pair also exists in the kernel-backed ops
    (kernels/ell_spmv/ops.py `_relax_push`/`_relax_sliced_pull`) and inline
    in the local backend's generated source (local_torch.emit_relax_hybrid).
    A semantic change to any copy must be applied to all."""
    n = g.num_nodes

    def push(d):
        cand = d[g.edge_src] + g.weights if weighted else d[g.edge_src]
        if frontier is not None:
            cand = torch.where(frontier[g.edge_src], cand, INF)
        return scatter_min(d, g.indices, cand)

    def pull(d):
        cand = d[g.rev_indices] + g.rev_weights if weighted \
            else d[g.rev_indices]
        if frontier is not None:
            cand = torch.where(frontier[g.rev_indices], cand, INF)
        return torch.minimum(d, segment_min(cand, g.rev_edge_dst, n))

    if frontier is None:
        return pull(dist)
    if frontier_should_push(frontier, n, threshold_frac, direction):
        return push(dist)
    return pull(dist)


def frontier_rows_should_push(frontier: torch.Tensor, n: int,
                              threshold_frac: float | None = None) -> torch.Tensor:
    """Per-row push/pull choice for a [B, N] batched frontier → bool[B]
    (on the device)."""
    frac = DEFAULT_SCHEDULE.push_threshold_frac if threshold_frac is None \
        else threshold_frac
    occ = torch.sum(frontier, dim=1, dtype=torch.int32)
    return occ <= max(int(n * frac), 1)


def _cond_by_rows(rows_push, push_all, pull_all, mixed, arg):
    """Dispatch on the per-row direction vector: homogeneous batches take a
    single-direction branch; mixed batches evaluate both, each masked to its
    rows (the masks make the two halves disjoint, so combining is exact).
    Reads the vector's all/any on the host."""
    if bool(torch.all(rows_push)):
        return push_all(arg)
    if bool(torch.any(rows_push)):
        return mixed(arg)
    return pull_all(arg)


# --- property helpers ------------------------------------------------------------

def init_prop(n, dtype, value=None, *, device):
    """[n] property of `dtype` on `device`, zero or filled with `value` (a
    Python scalar or a 0-d tensor)."""
    if value is None:
        return torch.zeros((n,), dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device).expand(n).clone()


def set_at(prop: torch.Tensor, idx, value) -> torch.Tensor:
    """Out-of-place single-node write: a copy of `prop` with prop[idx] =
    value (the reference's `prop.at[idx].set(value)`)."""
    out = prop.clone()
    out[idx] = value
    return out


def inf_for(dtype):
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return INF


def reduce_identity(op: str, dtype, device=None):
    if op == "+":
        return torch.zeros((), dtype=dtype, device=device)
    if op == "*":
        return torch.ones((), dtype=dtype, device=device)
    if op == "&&":
        return torch.tensor(True, device=device)
    if op == "||":
        return torch.tensor(False, device=device)
    raise ValueError(op)
