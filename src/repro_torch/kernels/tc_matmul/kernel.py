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

The launch packs L into two int8 copies (scratch allocated here) and runs
the products over a list of work units built here: (I, J, K0, nK) in
128-tiles, every (I, J, K) with J <= K <= I exactly once.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .ref import tc_matmul_ref

TILE = 128      # the kernel's tile edge (tc_matmul_tile() in the library)
K_CHUNK = 32    # most K tiles in one work unit

_lib = None
_units_on_device: dict = {}   # (N, device) -> int32 tensor [U, 4]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("tc_matmul")
        lib.tc_matmul_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                                               ctypes.c_int, ctypes.c_void_p])
        lib.tc_matmul_f32.restype = ctypes.c_int
        for fn in (lib.tc_matmul_tile, lib.tc_matmul_warps, lib.tc_matmul_smem_bytes):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.tc_matmul_error_string.argtypes = [ctypes.c_int]
        lib.tc_matmul_error_string.restype = ctypes.c_char_p
        if lib.tc_matmul_tile() != TILE:
            raise RuntimeError(f"tc_matmul library tiles by {lib.tc_matmul_tile()}, not {TILE}")
        _lib = lib
    return _lib


def work_units(n: int) -> np.ndarray:
    """The kernel's work list for an [n, n] input: int32 rows (I, J, K0, nK)
    of 128-tiles, one per output tile (I, J), J <= I, and K chunk c (the
    tiles c·K_CHUNK .. c·K_CHUNK + K_CHUNK - 1) that meets K = J .. I.
    Longest first; among equals, by chunk, then in groups of 8 row tiles,
    so the units a persistent grid runs at once share their K tiles in L2."""
    chunk = K_CHUNK
    nb = -(-n // TILE)
    i, j = np.tril_indices(nb)
    c_lo, c_hi = j // chunk, i // chunk
    counts = c_hi - c_lo + 1
    first = np.repeat(np.cumsum(counts) - counts, counts)
    c = np.repeat(c_lo, counts) + (np.arange(int(counts.sum())) - first)
    i, j = np.repeat(i, counts), np.repeat(j, counts)
    k0 = np.maximum(j, c * chunk)
    nk = np.minimum(i, c * chunk + chunk - 1) - k0 + 1
    order = np.lexsort((i, j, i // 8, c, -nk))       # the last key sorts first
    return np.stack([i, j, k0, nk], axis=1)[order].astype(np.int32)


def _device_units(n: int, device: torch.device) -> torch.Tensor:
    # built once per (N, device): a copy from host memory would stall the stream
    key = (n, str(device))
    units = _units_on_device.get(key)
    if units is None:
        units = _units_on_device[key] = torch.from_numpy(work_units(n)).to(device)
    return units


def tc_matmul(lower: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """lower: [N, N] float32 strict lower-triangular adjacency with
    N % block == 0 (the reference's block contract; the CUDA launch tiles
    by 128 whatever `block` is). Returns the triangle count as a float32
    0-dim tensor. On the card the count is exact (int32 products, int64
    partials) before that cast, and a strictly lower entry other than 0 or
    1 stops the kernel with a device-side assert."""
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
    if lower.data_ptr() % 16:                 # the pack reads float4s
        lower = lower.clone()
    lib = _library()
    n_pad = -(-n // TILE) * TILE
    units = _device_units(n, lower.device)
    l8 = torch.empty((n_pad, n_pad), dtype=torch.int8, device=lower.device)
    l8t = torch.empty_like(l8)
    partials = torch.empty(units.shape[0] * lib.tc_matmul_warps(), dtype=torch.int64,
                           device=lower.device)
    with torch.cuda.device(lower.device):
        err = lib.tc_matmul_f32(lower.data_ptr(), l8.data_ptr(), l8t.data_ptr(),
                                units.data_ptr(), units.shape[0], partials.data_ptr(), n,
                                torch.cuda.current_stream(lower.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tc_matmul (N={n}) launch failed: "
                           f"{lib.tc_matmul_error_string(err).decode()}")
    tc_matmul.launches += 1
    return partials.sum().to(torch.float32)


tc_matmul.launches = 0   # kernel launches in this process (not CPU calls)
