"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32_000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, conv_width=4,
    attn_every=6,   # one shared transformer block application every 6 mamba blocks
    notes="Mamba2 backbone; SHARED attn block weights, separate KV per call; runs long_500k",
)
