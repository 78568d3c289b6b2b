"""qwen3-moe-235b-a22b — MoE 128 experts top-8 [hf:Qwen/Qwen3-*; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151_936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    n_experts=128, moe_top_k=8,
    notes="per-expert d_ff=1536; experts sharded on the model axis",
)
