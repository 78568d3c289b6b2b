"""Triangle count as a masked blocked matrix product: the wrapper around
the CUDA kernel.

    tc_matmul(L) = sum( (L @ L) * L )     L: [N, N] f32, strict lower 0/1

The kernel itself is `csrc/tc_matmul.cu` (its header says which TPU kernel
it replaces, what bounds it on the card and how it is laid out); it reads
only the strict lower triangle of its input, which on the contract's input
is the same function. For CUDA tensors this module launches it and raises
on anything it does not take; for CPU tensors it runs the plain version
`tc_matmul_ref`, because the tensors lie on the CPU — there is no other
way to reach the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import tc_matmul_ref

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("tc_matmul")
        lib.tc_matmul_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.tc_matmul_f32.restype = ctypes.c_int
        lib.tc_matmul_tile.argtypes = []
        lib.tc_matmul_tile.restype = ctypes.c_int
        lib.tc_matmul_error_string.argtypes = [ctypes.c_int]
        lib.tc_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tc_matmul(lower: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """lower: [N, N] float32 strict lower-triangular adjacency with
    N % block == 0 (the reference's block contract; the CUDA launch tiles
    by 128 whatever `block` is). Returns the triangle count as a float32
    0-dim tensor. On the card the per-tile partials are exact f64 sums."""
    if lower.dtype != torch.float32:
        raise TypeError(f"tc_matmul takes float32, got {lower.dtype}")
    n = lower.shape[0] if lower.ndim == 2 else -1
    if lower.ndim != 2 or lower.shape[1] != n or n == 0:
        raise ValueError(f"lower must be a non-empty square [N, N], got {tuple(lower.shape)}")
    if block <= 0 or n % block:
        raise ValueError(f"N={n} must be a multiple of block={block}")
    if lower.device.type == "cpu":
        return tc_matmul_ref(lower)
    if lower.device.type != "cuda":
        raise ValueError(f"tc_matmul runs on CUDA or CPU tensors, got {lower.device}")
    if not lower.is_contiguous():
        raise ValueError("lower must be contiguous")
    lib = _library()
    nb = -(-n // lib.tc_matmul_tile())
    partials = torch.empty(nb * nb, dtype=torch.float64, device=lower.device)
    with torch.cuda.device(lower.device):
        err = lib.tc_matmul_f32(lower.data_ptr(), partials.data_ptr(), n,
                                torch.cuda.current_stream(lower.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tc_matmul (N={n}) launch failed: "
                           f"{lib.tc_matmul_error_string(err).decode()}")
    tc_matmul.launches += 1
    return partials.sum().to(torch.float32)


tc_matmul.launches = 0   # kernel launches in this process (not CPU calls)
