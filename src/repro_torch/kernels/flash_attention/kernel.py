"""Blocked (flash) attention: the wrapper around the CUDA kernel.

    o[b, i] = softmax_j( q[b, i] · k[b, j] / sqrt(D) ) · v[b, j]
    causal: query i sees kv position j iff j <= i + (SKV - SQ)

q is [BH, SQ, D] and k, v are [BH, SKV, D] with the same head count (the
caller repeats KV heads for GQA), in float32 or bfloat16; the output is
[BH, SQ, D] in q's dtype. The kernel itself is `csrc/flash_attention.cu`
(its header says which TPU kernel it replaces, what bounds it on the card
and how it is laid out). For CUDA tensors this module launches it and
raises on anything it does not take; for CPU tensors it runs the plain
version `attention_ref`, because the tensors lie on the CPU — there is no
other way to reach the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

# dtype -> exported C function
_FUNCS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (32, 64, 128)
_INT_MAX = 2**31 - 1

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        for fn in _FUNCS.values():
            f = getattr(lib, fn)
            f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                          + [ctypes.c_float, ctypes.c_void_p])
            f.restype = ctypes.c_int
        lib.flash_attention_bf16_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_bf16_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, bq, bk):
    if q.dtype not in _FUNCS:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be [BH, SQ, D] and k, v the same [BH, SKV, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in BH or D")
    skv = k.shape[1]
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention needs SQ >= 1 and SKV >= 1")
    # the reference's block contract: bq = min(bq, SQ) must divide SQ
    if sq % min(bq, sq) or skv % min(bk, skv):
        raise ValueError(f"SQ={sq} and SKV={skv} must be multiples of their blocks "
                         f"bq=min({bq}, SQ) and bk=min({bk}, SKV)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v must share a device, got {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Online-softmax attention over [BH, S, D] operands (see the module
    docstring). `bq` and `bk` are the reference's blocks: they set which
    shapes are taken (SQ % min(bq, SQ) == 0, SKV % min(bk, SKV) == 0) and
    never the result; the CUDA launch tiles by 128 (bf16) or 16 (f32)
    query rows whatever they are."""
    _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward, in this package or in the reference: its "
            "output would carry no gradient to q, k and v. Training runs impl='ref' "
            "(make_train_step's default); call the kernel under torch.no_grad() or "
            "torch.inference_mode()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if max(q.numel(), k.numel()) > _INT_MAX or bh > 65535:
        raise ValueError("flash_attention: an operand exceeds 2^31 - 1 elements or BH > 65535")
    # the tensor maps' bases must be 16-byte aligned (a view may start anywhere)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = getattr(lib, _FUNCS[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            bh, sq, skv, d, int(causal), 1.0 / (d ** 0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({q.dtype}, BH={bh}, SQ={sq}, SKV={skv}, "
                           f"D={d}) launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0   # kernel launches in this process (not CPU calls)
