"""Model-facing attention op: GQA head handling + [B, H, S, D] layout glue."""
from __future__ import annotations

import torch

from .kernel import flash_attention
from .ref import attention_ref


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, use_kernel: bool = True) -> torch.Tensor:
    """q: [B, Hq, S, D]; k/v: [B, Hkv, Skv, D] with Hq % Hkv == 0.

    KV heads are repeated to Hq before the call (a copy of k and v, as the
    reference's `jnp.repeat`); query heads h·g .. h·g + g - 1 share KV
    head h. Every SQ >= 1 goes to `flash_attention`, which launches the
    kernel on CUDA tensors and runs the plain version on CPU tensors (the
    reference's SQ >= 8 rule is a TPU tiling limit the CUDA kernel does not
    have). `use_kernel=False` asks for the plain version, which runs only
    on CPU tensors: elsewhere it raises."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if not use_kernel and q.device.type != "cpu":
        raise ValueError(f"use_kernel=False runs the plain version, on CPU tensors only; "
                         f"got {q.device}")
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    qf = q.reshape(b * hq, sq, d).contiguous()
    kf = k.reshape(b * hq, -1, d).contiguous()
    vf = v.reshape(b * hq, -1, d).contiguous()
    attend = flash_attention if use_kernel else attention_ref
    return attend(qf, kf, vf, causal=causal).reshape(b, hq, sq, d)
