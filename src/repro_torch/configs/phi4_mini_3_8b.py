"""phi4-mini-3.8b — dense, RoPE+SwiGLU+GQA, 200k vocab [arXiv:2412.08905]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200_064, head_dim=128,
    tie_embeddings=True,
    notes="embedding-sharding stressor (200k vocab)",
)
