"""minicpm-2b — dense llama-like, WSD schedule + mup scaling [arXiv:2404.06395]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122_753, head_dim=64,
    tie_embeddings=True, wsd_schedule=True,
    scale_emb=12.0, scale_depth=1.4,
    notes="WSD schedule in train/optimizer.py; mup-style scale_emb/scale_depth",
)
