"""seamless-m4t-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596].

The audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model) to the encoder."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256_206, head_dim=64,
    input_kind="embeddings",
    notes="enc-dec; audio frontend stubbed as precomputed embeddings",
)
