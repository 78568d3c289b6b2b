"""CSR graph representation — the storage format the paper standardizes on (§3.1).

PyTorch counterpart of `repro.graph.csr`. The graph is built on the host in
numpy (exactly the reference's arrays, value for value) and then lives on
one device as a frozen dataclass of tensors. Beside the CSR/CSC arrays it
materializes the padded ELL views the `ell_spmv` kernel consumes: the
single-width `[N, max_deg]` view and the degree-bucketed sliced view with a
COO tail for hub rows.

Entry points run on the card unless the caller asks otherwise: every
graph constructor takes `device=None`, which means `cuda`, and raises
`RuntimeError` when no CUDA device is present. Tests pass `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..schedule import DEFAULT_SCHEDULE, Schedule

INF_I32 = np.int32(2**30)  # "infinity" that survives + weight without overflow

# the eleven tensor fields of CSRGraph, in declaration order
FIELDS = ("indptr", "indices", "weights", "edge_src", "rev_indptr",
          "rev_indices", "rev_weights", "rev_edge_dst", "out_degree",
          "in_degree", "edge_key")


def resolve_device(device=None) -> torch.device:
    """`None` means the card. A CUDA device that is not there is an error:
    nothing in the port quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build the "
            "graph on the CPU explicitly")
    return dev


_ENGINE_DEPRECATION = (
    "mutating the module-level ENGINE is deprecated; construct an explicit "
    "repro_torch.schedule.Schedule and pass it to compile_program(..., "
    "schedule=...) / prepare(g, schedule) instead. ENGINE is snapshotted "
    "into a Schedule at compile/prepare time, so mutating it afterwards "
    "never changes an already-compiled program."
)


@dataclasses.dataclass
class EngineConfig:
    """DEPRECATED mutable shim over the default `Schedule`, as in the
    reference: reads are free; every mutation validates the would-be
    configuration (the same checks as `Schedule`), emits a
    `DeprecationWarning`, and only takes effect for *future*
    compiles/prepares via `snapshot()`."""

    # field defaults come from DEFAULT_SCHEDULE, so an unmutated shim
    # snapshots exactly the default Schedule
    num_buckets: int = DEFAULT_SCHEDULE.num_buckets
    min_width: int = DEFAULT_SCHEDULE.min_width
    growth: int = DEFAULT_SCHEDULE.growth
    push_threshold_frac: float = DEFAULT_SCHEDULE.push_threshold_frac
    batch_sources: int = DEFAULT_SCHEDULE.batch_sources

    def __post_init__(self):
        self.snapshot()           # validate the defaults once
        object.__setattr__(self, "_ready", True)

    def __setattr__(self, name, value):
        if getattr(self, "_ready", False) and not name.startswith("_"):
            knobs = {f.name: getattr(self, f.name)
                     for f in dataclasses.fields(self)}
            if name not in knobs:
                raise AttributeError(
                    f"ENGINE has no knob {name!r}; knobs: "
                    f"{', '.join(sorted(knobs))}")
            knobs[name] = value
            Schedule(**knobs)     # actionable ValueError before committing
            warnings.warn(_ENGINE_DEPRECATION, DeprecationWarning,
                          stacklevel=2)
        object.__setattr__(self, name, value)

    def snapshot(self, *, direction: str = "auto") -> Schedule:
        """Materialize the current knob values as a frozen `Schedule`."""
        return Schedule(num_buckets=self.num_buckets,
                        min_width=self.min_width, growth=self.growth,
                        push_threshold_frac=self.push_threshold_frac,
                        batch_sources=self.batch_sources,
                        direction=direction)


ENGINE = EngineConfig()


def resolve_schedule(schedule: Optional[Schedule] = None) -> Schedule:
    """The one place a default schedule is materialized: `None` snapshots
    the deprecated `ENGINE` shim (which, unless mutated, IS the default
    `Schedule`)."""
    sched = ENGINE.snapshot() if schedule is None else schedule
    if not isinstance(sched, Schedule):
        raise TypeError(
            f"schedule must be a repro_torch.schedule.Schedule, got "
            f"{type(sched).__name__} — e.g. Schedule(direction='pull')")
    return sched


def _tensor_fields_to(obj, device):
    """`dataclasses.replace` with every tensor (or tuple of tensors) field
    moved to `device`; static fields ride along unchanged."""
    dev = torch.device(device)
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(dev)
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            changes[f.name] = tuple(t.to(dev) for t in v)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Static graph in CSR (out-edges) + CSC (in-edges) form.

    Matches the paper's Graph type: `indptr/indices` are
    `indexofNodes/edgeList`; `rev_*` is the transpose CSR the paper keeps
    for `nodesTo()` (needed by PR-pull and BC). All tensors are int32 and
    live on one device (`g.device`).
    """

    # --- out-CSR ---
    indptr: torch.Tensor      # int32[N+1]
    indices: torch.Tensor     # int32[E]   destination of each out-edge
    weights: torch.Tensor     # int32[E]   edge weights (SSSP); ones if unweighted
    edge_src: torch.Tensor    # int32[E]   source of each out-edge (expanded rows)
    # --- in-CSR (transpose) ---
    rev_indptr: torch.Tensor  # int32[N+1]
    rev_indices: torch.Tensor # int32[E]   source of each in-edge
    rev_weights: torch.Tensor # int32[E]
    rev_edge_dst: torch.Tensor# int32[E]   destination of each in-edge (expanded rows)
    # --- degrees ---
    out_degree: torch.Tensor  # int32[N]
    in_degree: torch.Tensor   # int32[N]
    # --- membership index ---
    # sorted (src*N + dst) key, wrapped to int32 exactly as the reference
    # does; meaningful only while N*N fits int32
    edge_key: torch.Tensor    # int32[E]
    # --- static metadata ---
    num_nodes: int
    num_edges: int
    max_out_degree: int = 1
    max_in_degree: int = 1
    # update generation: 0 for a freshly built graph, old.version + 1 for
    # the result of `update()`; folded into the context fingerprint
    version: int = 0

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def to(self, device) -> "CSRGraph":
        return _tensor_fields_to(self, device)

    def update(self, adds=None, dels=None, weights=None):
        """Apply an edge write batch, returning a `repro_torch.graph.dynamic.
        GraphDelta` whose `.graph` is the NEW graph version (this graph is
        immutable and untouched). `adds`/`dels` are (src, dst) pairs — a
        `[K, 2]` array or a pair of arrays; `weights` parallels `adds`
        (default 1; adding an existing edge replaces its weight). Deleting
        an absent edge is a no-op. The sliced-ELL views of this graph's
        `GraphContext` are delta-patched into the new graph's context
        rather than rebuilt."""
        from .dynamic import apply_update
        return apply_update(self, adds=adds, dels=dels, weights=weights)


def _build_csr(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    # one stable sort on the composite key == the reference's
    # np.lexsort((dst, src)), ties (duplicate pairs) kept in input order
    order = np.argsort(src * np.int64(n) + dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    return indptr.astype(np.int32), dst.astype(np.int32), w.astype(np.int32), src.astype(np.int32)


def from_edges(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray] = None,
    *,
    undirected: bool = False,
    dedup: bool = True,
    drop_self_loops: bool = False,
    device=None,
) -> CSRGraph:
    """Build a CSRGraph on the host in numpy, then move it to `device`
    (`None` = the card)."""
    dev = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if weights is None:
        w = np.ones_like(src)
    else:
        w = np.asarray(weights, np.int64)
    if undirected:
        src, dst, w = np.concatenate([src, dst]), np.concatenate([dst, src]), np.concatenate([w, w])
    if drop_self_loops:
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
    if dedup and len(src):
        key = src * np.int64(n) + dst
        _, first = np.unique(key, return_index=True)
        src, dst, w = src[first], dst[first], w[first]
    e = len(src)
    indptr, indices, w_s, edge_src = _build_csr(n, src, dst, w)
    rev_indptr, rev_indices, rev_w, rev_edge_dst = _build_csr(n, dst, src, w)
    out_deg = np.diff(indptr).astype(np.int32)
    in_deg = np.diff(rev_indptr).astype(np.int32)
    # CSR order is (src, dst)-sorted, so the key array is sorted by
    # construction; int64 intermediate, then the reference's int32 wrap
    edge_key = (edge_src.astype(np.int64) * n + indices.astype(np.int64)).astype(np.int32)
    arrays = dict(indptr=indptr, indices=indices, weights=w_s,
                  edge_src=edge_src, rev_indptr=rev_indptr,
                  rev_indices=rev_indices, rev_weights=rev_w,
                  rev_edge_dst=rev_edge_dst, out_degree=out_deg,
                  in_degree=in_deg, edge_key=edge_key)
    return from_arrays(arrays, num_nodes=n, num_edges=e,
                       max_out_degree=int(out_deg.max(initial=1)),
                       max_in_degree=int(in_deg.max(initial=1)), device=dev)


def from_arrays(arrays: dict, *, num_nodes: int, num_edges: int,
                max_out_degree: int, max_in_degree: int, version: int = 0,
                device=None) -> CSRGraph:
    """Build the port's `CSRGraph` from the eleven fields of a reference
    graph given as numpy arrays (`{f: np.asarray(getattr(g, f)) for f in
    FIELDS}`), so both packages compute on the very same graph."""
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"from_arrays: missing fields {missing}")
    # np.array copies, so the tensors never alias the caller's (possibly
    # read-only) arrays
    tensors = {f: torch.from_numpy(np.array(arrays[f], dtype=np.int32)).to(dev)
               for f in FIELDS}
    return CSRGraph(**tensors, num_nodes=int(num_nodes),
                    num_edges=int(num_edges),
                    max_out_degree=int(max_out_degree),
                    max_in_degree=int(max_in_degree), version=int(version))


def to_dense(g: CSRGraph, dtype=torch.float32) -> torch.Tensor:
    """Dense adjacency on `g`'s device (small graphs only — tests + the TC
    matmul path): a[u, v] = 1 for every edge u → v."""
    a = torch.zeros((g.num_nodes, g.num_nodes), dtype=dtype, device=g.device)
    a[g.edge_src.long(), g.indices.long()] = 1
    return a


# --- ELL views ----------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _host_csr(g: CSRGraph, reverse: bool):
    if reverse:
        arrs = (g.rev_indptr, g.rev_indices, g.rev_weights)
    else:
        arrs = (g.indptr, g.indices, g.weights)
    return tuple(a.cpu().numpy() for a in arrs)


def _row_positions(indptr, sel):
    """For the CSR rows `sel`, every edge at once (the reference walks row
    by row in Python): (k, j, pos) with edge j of row sel[k] at pos."""
    deg = (indptr[sel + 1] - indptr[sel]).astype(np.int64)
    k = np.repeat(np.arange(len(sel)), deg)
    j = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
    return k, j, np.repeat(indptr[sel].astype(np.int64), deg) + j


def _fill_rows(indptr, indices, wts, sel, cols, vals):
    """cols[k, :deg] / vals[k, :deg] = the CSR row sel[k], for every k."""
    k, j, pos = _row_positions(indptr, sel)
    cols[k, j] = indices[pos]
    vals[k, j] = wts[pos]


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Padded neighbor-list (ELL) view: cols[i, k] = k-th neighbor of i (or
    `n` for padding), wts[i, k] = its weight (or INF for padding). Rows are
    padded to `max_deg` rounded up to a multiple of 8."""

    cols: torch.Tensor  # int32[N, D]
    wts: torch.Tensor   # int32[N, D]
    num_nodes: int
    max_deg: int

    def to(self, device) -> "EllGraph":
        return _tensor_fields_to(self, device)


def to_ell(g: CSRGraph, *, reverse: bool = False, pad_to: int = 8) -> EllGraph:
    indptr, indices, wts = _host_csr(g, reverse)
    n = g.num_nodes
    deg = np.diff(indptr)
    d = max(int(deg.max()) if n else 0, 1)
    d = _round_up(d, pad_to)
    cols = np.full((n, d), n, np.int32)          # n == "no neighbor" sentinel
    w = np.full((n, d), int(INF_I32), np.int32)
    _fill_rows(indptr, indices, wts, np.arange(n), cols, w)
    dev = g.device
    return EllGraph(cols=torch.from_numpy(cols).to(dev),
                    wts=torch.from_numpy(w).to(dev), num_nodes=n, max_deg=d)


@dataclasses.dataclass(frozen=True)
class SlicedEllGraph:
    """Degree-bucketed ELL: rows grouped by degree, each bucket padded only to
    its own width, hub rows (degree > the widest bucket) kept as flat COO.

    Per bucket b: cols[b] is int32[Rb, Db] (sentinel `num_nodes` for padding,
    its x-slot holds 0), wts[b] is int32[Rb, Db] (INF padding), rows[b] is
    int32[Rb] (original row id; sentinel `num_nodes` for row padding —
    scattered into a spare slot that is sliced off). Hub edges:
    (hub_rows, hub_cols, hub_wts) int32[Eh].
    """

    cols: tuple      # tuple of int32[Rb, Db]
    wts: tuple       # tuple of int32[Rb, Db]
    rows: tuple      # tuple of int32[Rb]
    hub_rows: torch.Tensor  # int32[Eh]
    hub_cols: torch.Tensor  # int32[Eh]
    hub_wts: torch.Tensor   # int32[Eh]
    num_nodes: int
    widths: tuple = ()

    def padded_cells(self) -> int:
        """Total padded (cols) slots — the memory/work proxy benchmarks track."""
        return sum(int(c.shape[0]) * int(c.shape[1]) for c in self.cols) \
            + int(self.hub_cols.shape[0])

    def to(self, device) -> "SlicedEllGraph":
        return _tensor_fields_to(self, device)


def to_sliced_ell(
    g: CSRGraph,
    *,
    reverse: bool = False,
    schedule: Optional[Schedule] = None,
    num_buckets: Optional[int] = None,
    min_width: Optional[int] = None,
    growth: Optional[int] = None,
    row_pad: int = 8,
) -> SlicedEllGraph:
    """Build the degree-bucketed view (host side, once per graph), on the
    graph's device. The bucket layout comes from `schedule`; the explicit
    knob kwargs remain as per-call overrides. `reverse=True` buckets by
    in-degree with in-neighbor columns — the pull orientation. Degree-0
    rows are dropped entirely (they contribute the semiring identity)."""
    cfg = resolve_schedule(schedule)
    num_buckets = cfg.num_buckets if num_buckets is None else num_buckets
    min_width = cfg.min_width if min_width is None else min_width
    growth = cfg.growth if growth is None else growth
    indptr, indices, wts = _host_csr(g, reverse)
    n = g.num_nodes
    dev = g.device
    deg = np.diff(indptr)
    widths = [min_width * growth**i for i in range(max(num_buckets, 1))]
    hub_width = widths[-1]

    b_cols, b_wts, b_rows = [], [], []
    prev_w = 0
    for w_b in widths:
        sel = np.nonzero((deg > prev_w) & (deg <= w_b))[0]
        prev_w = w_b
        if len(sel) == 0:
            continue
        rb = _round_up(len(sel), row_pad)
        cols = np.full((rb, w_b), n, np.int32)
        vals = np.full((rb, w_b), int(INF_I32), np.int32)
        rows = np.full((rb,), n, np.int32)
        rows[: len(sel)] = sel
        _fill_rows(indptr, indices, wts, sel, cols, vals)
        b_cols.append(torch.from_numpy(cols).to(dev))
        b_wts.append(torch.from_numpy(vals).to(dev))
        b_rows.append(torch.from_numpy(rows).to(dev))

    hub_sel = np.nonzero(deg > hub_width)[0]
    k, _, pos = _row_positions(indptr, hub_sel)
    hub_rows = hub_sel[k]
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    return SlicedEllGraph(
        cols=tuple(b_cols), wts=tuple(b_wts), rows=tuple(b_rows),
        hub_rows=as_dev(hub_rows), hub_cols=as_dev(indices[pos]),
        hub_wts=as_dev(wts[pos]),
        num_nodes=n, widths=tuple(int(c.shape[1]) for c in b_cols))


def pad_nodes(g: CSRGraph, multiple: int) -> CSRGraph:
    """Pad to a node-count multiple (the paper pads the last MPI shard; here
    every shard gets the same extent). The padding vertices have no edges.
    The membership key encodes N, so it is rebuilt for the padded count
    (still sorted: CSR order is (src, dst)-lexicographic), wrapped to int32
    as `from_edges` wraps it."""
    n = g.num_nodes
    n_pad = _round_up(max(n, 1), multiple)
    if n_pad == n:
        return g
    extra = n_pad - n

    def pad(t, fill):
        return torch.cat([t, torch.full((extra,), fill, dtype=t.dtype, device=t.device)])

    return dataclasses.replace(
        g,
        indptr=pad(g.indptr, int(g.indptr[-1])),
        rev_indptr=pad(g.rev_indptr, int(g.rev_indptr[-1])),
        out_degree=pad(g.out_degree, 0),
        in_degree=pad(g.in_degree, 0),
        edge_key=(g.edge_src.long() * n_pad + g.indices.long()).to(torch.int32),
        num_nodes=n_pad,
    )
