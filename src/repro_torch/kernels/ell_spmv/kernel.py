"""Block-ELL semiring SpMV/SpMM and the sliced-ELL pull sweep: the
wrappers around the CUDA kernels.

  minplus   : y[i] = min_k ( x[cols[i,k]] + vals[i,k] )     (SSSP relax, int32)
  plustimes : y[i] = sum_k ( x[cols[i,k]] * vals[i,k] )     (PR gather, f32)

`ell_spmv` takes one rectangular tile: x is the gather source with the
sentinel slot last, [M] (SpMV → y [R]) or [M, B] (SpMM over B source
lanes → y [R, B]). `ell_sweep` runs the whole single-vector pull sweep of
a reverse `SlicedEllGraph` (its buckets, hub tail and rows of in-degree 0)
from x [N] into y [N], laid out by the view's `SweepPlan`. The kernels are
`csrc/ell_spmv.cu` (its header says which TPU kernel they replace, what
bounds them on the card and how they are laid out). For CUDA tensors this
module launches them and raises on anything they do not take; for CPU
tensors it runs the plain versions `ell_spmv_ref` and `ell_sweep_ref`,
because the tensors lie on the CPU — there is no other way to reach the
plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .plan import MAX_BUCKETS, SweepPlan
from .ref import ell_spmv_ref, ell_sweep_ref

# semiring -> (value dtype, exported C function)
_SEMIRINGS = {"minplus": (torch.int32, "ell_minplus_i32"),
              "plustimes": (torch.float32, "ell_plustimes_f32")}
_SWEEPS = {"minplus": "ell_sweep_minplus_i32", "plustimes": "ell_sweep_plustimes_f32"}
_INT_MAX = 2**31 - 1



class _Bucket(ctypes.Structure):
    """ctypes mirror of SweepBucket in csrc/ell_spmv.cu."""
    _fields_ = [("cols", ctypes.c_void_p), ("wts", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("R", ctypes.c_int), ("D", ctypes.c_int),
                ("lanes_log2", ctypes.c_int), ("first_block", ctypes.c_int),
                ("num_blocks", ctypes.c_int)]


class _SweepArgs(ctypes.Structure):
    """ctypes mirror of SweepArgs in csrc/ell_spmv.cu (its size is checked
    against the library's when the library loads)."""
    _fields_ = ([("bucket", _Bucket * MAX_BUCKETS)]
                + [(f, ctypes.c_void_p) for f in (
                    "hub_cols", "hub_wts", "seg_rows", "seg_ptr", "chunk_seg", "span_rows",
                    "span_first_slot", "span_last_chunk", "zero_rows", "x", "dist", "y",
                    "partial")]
                + [(f, ctypes.c_int) for f in (
                    "num_buckets", "num_hub", "chunk", "num_chunks", "num_span", "num_zero",
                    "zero_first_block", "num_blocks", "N")])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ell_spmv")
        for fn in _SEMIRINGS.values():
            f = getattr(lib, fn[1])
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        for fn in _SWEEPS.values():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
        lib.ell_sweep_args_bytes.restype = ctypes.c_int
        if lib.ell_sweep_args_bytes() != ctypes.sizeof(_SweepArgs):
            raise RuntimeError(f"ctypes SweepArgs is {ctypes.sizeof(_SweepArgs)} bytes, "
                               f"the library's {lib.ell_sweep_args_bytes()}")
        _lib = lib
    return _lib


def _check(cols, vals, x, semiring):
    if semiring not in _SEMIRINGS:
        raise ValueError(f"semiring must be one of {tuple(_SEMIRINGS)}, got {semiring!r}")
    dt = _SEMIRINGS[semiring][0]
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype != dt or x.dtype != dt:
        raise TypeError(f"{semiring} takes {dt} vals and x, got {vals.dtype} and {x.dtype}")
    if cols.ndim != 2 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"cols and vals must be the same [R, D] shape, got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    if cols.shape[1] == 0:
        raise ValueError("cols must have at least one column (D >= 1)")
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be [M] or [M, B], got {tuple(x.shape)}")
    if not (cols.device == vals.device == x.device):
        raise ValueError(f"cols, vals and x must share a device, got "
                         f"{cols.device}, {vals.device}, {x.device}")


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             semiring: str = "minplus", block_rows: int = 256) -> torch.Tensor:
    """One semiring SpMV (x [M]) or SpMM (x [M, B]) over an ELL tile.

    `block_rows` (the `Schedule.block_rows` cap the ops pass down) is
    accepted for the reference's signature and ignored: the CUDA launch
    shape is fixed, and the knob never changes a result. Every cols entry
    must lie in [0, M): on the CPU an index error, on the card a device-side
    assert."""
    _check(cols, vals, x, semiring)
    if x.device.type == "cpu":
        return ell_spmv_ref(cols, vals, x, semiring)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on CUDA or CPU tensors, got {x.device}")
    for name, t in (("cols", cols), ("vals", vals), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r, d = cols.shape
    m, b = x.shape[0], 1 if x.ndim == 1 else x.shape[1]
    if max(r * d, x.numel(), r * b) > _INT_MAX:
        raise ValueError("ell_spmv: an operand exceeds 2^31 - 1 elements")
    y = torch.empty((r,) if x.ndim == 1 else (r, b), dtype=x.dtype, device=x.device)
    if r == 0 or b == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _SEMIRINGS[semiring][1])(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            r, d, m, b, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv ({semiring}, R={r}, D={d}, M={m}, B={b}) "
                           f"launch failed: {lib.ell_spmv_error_string(err).decode()}")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0   # kernel launches in this process (not CPU calls)


def _check_sweep(ell, plan, x, semiring, dist):
    if semiring not in _SEMIRINGS:
        raise ValueError(f"semiring must be one of {tuple(_SEMIRINGS)}, got {semiring!r}")
    if not isinstance(plan, SweepPlan) or plan.num_nodes != ell.num_nodes \
            or len(plan.buckets) != len(ell.cols):
        raise ValueError("plan is not the SweepPlan of this view (plan.sweep_plan(ell))")
    n, dt = ell.num_nodes, _SEMIRINGS[semiring][0]
    if x.dtype != dt or tuple(x.shape) != (n,):
        raise TypeError(f"{semiring} sweeps a {dt} x of shape ({n},), got {x.dtype} "
                        f"{tuple(x.shape)}")
    if semiring == "minplus":
        if dist is None or dist.dtype != dt or tuple(dist.shape) != (n,):
            raise TypeError(f"minplus takes an int32 dist of shape ({n},)")
        if dist.device != x.device:
            raise ValueError(f"x and dist must share a device, got {x.device}, {dist.device}")
    elif dist is not None:
        raise TypeError("plustimes takes no dist")
    if ell.hub_rows.device != x.device:
        raise ValueError(f"the view lies on {ell.hub_rows.device}, x on {x.device}")


def _ptr(t: torch.Tensor, name: str, align: int = 4) -> int:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
    return t.data_ptr()


def ell_sweep(ell, plan: SweepPlan, x: torch.Tensor, *, semiring: str = "minplus",
              dist: torch.Tensor | None = None) -> torch.Tensor:
    """The single-vector pull sweep of the reverse sliced view `ell`,
    laid out by its plan (`plan.sweep_plan(ell)`): y [N] from x [N].

      minplus   : y[v] = min(dist[v], INF, min over in-edges (x[u] + w))
      plustimes : y[v] = sum over in-edges x[u]           (unit weights)

    One kernel launch plus a small combine launch when a hub row spans
    chunks; every output row is written once and f32 sums run in a fixed
    order, so two calls give bitwise-equal results. Bucket columns must lie
    in [0, N] (N, the sentinel, ends a row) and hub columns in [0, N): on
    the CPU an index error, on the card a device-side assert."""
    _check_sweep(ell, plan, x, semiring, dist)
    if x.device.type == "cpu":
        return ell_sweep_ref(ell, plan, x, semiring, dist)
    if x.device.type != "cuda":
        raise ValueError(f"ell_sweep runs on CUDA or CPU tensors, got {x.device}")
    n = ell.num_nodes
    y = torch.empty_like(x)
    if n == 0:
        return y
    args = _SweepArgs()
    for i, (cols, wts, rows) in enumerate(zip(ell.cols, ell.wts, ell.rows)):
        r, d, lanes, first, nb = plan.buckets[i]
        if d % 4:
            raise ValueError(f"bucket width {d} is not a multiple of 4")
        if r * d >= 2**31:
            raise ValueError(f"bucket {i} exceeds 2^31 - 1 cells")
        # bucket rows are loaded as 16-byte vectors
        args.bucket[i] = _Bucket(_ptr(cols, "cols", 16), _ptr(wts, "wts", 16),
                                 _ptr(rows, "rows"), r, d, lanes.bit_length() - 1, first, nb)
    partial = torch.empty(2 * plan.num_chunks, dtype=x.dtype, device=x.device)
    for name, t in (("hub_cols", ell.hub_cols), ("hub_wts", ell.hub_wts),
                    ("seg_rows", plan.seg_rows), ("seg_ptr", plan.seg_ptr),
                    ("chunk_seg", plan.chunk_seg), ("span_rows", plan.span_rows),
                    ("span_first_slot", plan.span_first_slot),
                    ("span_last_chunk", plan.span_last_chunk),
                    ("zero_rows", plan.zero_rows), ("x", x), ("y", y), ("partial", partial)):
        setattr(args, name, _ptr(t, name))
    args.dist = _ptr(dist, "dist") if dist is not None else None
    args.num_buckets, args.num_hub = len(ell.cols), int(ell.hub_rows.shape[0])
    args.chunk, args.num_chunks = plan.chunk, plan.num_chunks
    args.num_span, args.num_zero = int(plan.span_rows.shape[0]), int(plan.zero_rows.shape[0])
    args.zero_first_block, args.num_blocks, args.N = plan.zero_first_block, plan.num_blocks, n
    lib = _library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _SWEEPS[semiring])(
            ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_sweep ({semiring}, N={n}) launch failed: "
                           f"{lib.ell_spmv_error_string(err).decode()}")
    ell_sweep.launches += 1
    return y


ell_sweep.launches = 0   # sweep launches in this process (not CPU calls)
