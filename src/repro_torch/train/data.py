"""Synthetic, deterministic, shard-aware token pipeline.

PyTorch counterpart of `repro.train.data`, with its own copy of the numpy
draw: `batch_at(step)` is a pure function of (seed, step, shard), so a
resume needs no iterator checkpoint (the restored step number is the data
position) and every data-parallel shard draws a disjoint slice. The
tokens are bit-equal to the reference's for the same config and step.

The stream is a mixture of repeated n-grams over the vocabulary, so a real
model can reduce its loss on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    structure: int = 16      # n-gram period; lower = easier to learn


def _token_rows(dc: DataConfig, step: int) -> np.ndarray:
    """[B / num_shards, seq_len + 1] int64: the reference's draw."""
    per_shard = dc.global_batch // dc.num_shards
    rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step, dc.shard]))
    base = rng.integers(0, dc.vocab, size=(per_shard, dc.structure))
    reps = -(-(dc.seq_len + 1) // dc.structure)
    seq = np.tile(base, (1, reps))[:, : dc.seq_len + 1]
    noise = rng.random((per_shard, dc.seq_len + 1)) < 0.05
    return np.where(noise, rng.integers(0, dc.vocab, size=seq.shape), seq)


def batch_at(dc: DataConfig, step: int, device=None) -> dict:
    """Batch of `step` on this shard: {"tokens", "labels"} [B / num_shards,
    seq_len] int64 on `device` (None: the card), labels the next tokens."""
    dev = resolve_device(device)
    seq = torch.from_numpy(_token_rows(dc, step))
    return {"tokens": seq[:, :-1].to(dev), "labels": seq[:, 1:].to(dev)}


def embeds_batch_at(dc: DataConfig, step: int, d_model: int, device=None) -> dict:
    """Stub-frontend batch (audio/vision archs): `batch_at`'s tokens and
    labels plus precomputed frame embeddings [B / num_shards, seq_len,
    d_model] f32, drawn from a second seed."""
    out = batch_at(dc, step, device)
    rng = np.random.default_rng(np.random.SeedSequence([dc.seed + 1, step, dc.shard]))
    per_shard = dc.global_batch // dc.num_shards
    emb = rng.normal(size=(per_shard, dc.seq_len, d_model)).astype(np.float32)
    out["embeds"] = torch.from_numpy(emb).to(out["tokens"].device)
    return out
