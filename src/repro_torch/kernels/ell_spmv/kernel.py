"""Block-ELL semiring SpMV/SpMM: the wrapper around the CUDA kernel.

  minplus   : y[i] = min_k ( x[cols[i,k]] + vals[i,k] )     (SSSP relax, int32)
  plustimes : y[i] = sum_k ( x[cols[i,k]] * vals[i,k] )     (PR gather, f32)

x is the gather source with the sentinel slot last: [M] (SpMV → y [R]) or
[M, B] (SpMM over B source lanes → y [R, B]). The kernel itself is
`csrc/ell_spmv.cu` (its header says which TPU kernel it replaces, what
bounds it on the card and how it is laid out). For CUDA tensors this
module launches it and raises on anything it does not take; for CPU
tensors it runs the plain version `ell_spmv_ref`, because the tensors lie
on the CPU — there is no other way to reach the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ell_spmv_ref

# semiring -> (value dtype, exported C function)
_SEMIRINGS = {"minplus": (torch.int32, "ell_minplus_i32"),
              "plustimes": (torch.float32, "ell_plustimes_f32")}
_INT_MAX = 2**31 - 1

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ell_spmv")
        for fn in _SEMIRINGS.values():
            f = getattr(lib, fn[1])
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
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
