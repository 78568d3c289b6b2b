"""chameleon-34b — early-fusion VLM decoder, VQ image tokens [arXiv:2405.09818; unverified].

Image tokens are ordinary ids inside the 65536 vocab (VQ codes produced
upstream); qk-norm stabilizes the early-fusion softmax per the paper."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65_536, head_dim=128,
    qk_norm=True,
    notes="early-fusion VLM: modality frontend is the VQ tokenizer (stub)",
)
