"""Minimal LM serving engine: batched greedy generation via the decode path.

PyTorch counterpart of `repro.serve.engine`. Prefill fills the KV cache
token by token through `decode_step` (fine at demo scale; the long prefill
runs through the model's forward and its flash kernel), then greedy decode
continues the batch. Everything runs under `torch.inference_mode()`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, prompt+new] int32
    steps: int


class ServeEngine:
    def __init__(self, model, *, max_len: int = 256, batch_size: int = 4):
        self.model = model
        self.max_len = max_len
        self.batch_size = batch_size

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, new_tokens: int) -> GenerationResult:
        """prompts: [B, S] int (right-aligned, no padding). Greedy
        continuation of `new_tokens` tokens."""
        prompts = np.asarray(prompts)
        b, s = prompts.shape
        if b > self.batch_size or s + new_tokens > self.max_len:
            raise ValueError(f"batch {b} > {self.batch_size} or {s} + {new_tokens} tokens "
                             f"> max_len {self.max_len}")
        cache = self.model.init_cache(b, self.max_len)
        toks = torch.as_tensor(prompts, dtype=torch.int64, device=self.model.device)
        logits = None
        for i in range(s):   # prefill via the decode path
            logits, cache = self.model.decode_step(toks[:, i:i + 1], cache, i)
        out = [toks]
        cur = torch.argmax(logits, dim=-1)[:, None]
        for j in range(new_tokens):
            out.append(cur)
            if j == new_tokens - 1:
                break
            logits, cache = self.model.decode_step(cur, cache, s + j)
            cur = torch.argmax(logits, dim=-1)[:, None]
        return GenerationResult(
            tokens=torch.cat(out, dim=1).cpu().numpy().astype(np.int32),
            steps=s + new_tokens)
