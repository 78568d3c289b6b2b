"""Plain-torch version of blocked attention (the flash kernel's oracle)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: [BH, SQ, D], k/v: [BH, SKV, D]. f32 scores, masked entries set to
    -1e30, query i sees kv j iff j <= i + (SKV - SQ). Returns q's dtype.
    Materializes the [BH, SQ, SKV] f32 scores."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=s.device).tril(skv - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)
