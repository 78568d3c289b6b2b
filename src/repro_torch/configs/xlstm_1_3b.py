"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the assignment: gating is internal to the xLSTM cells (no
separate MLP); mLSTM = matrix-memory linear attention (runs long_500k)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304, head_dim=512,
    slstm_every=7,   # one sLSTM block every 7 (positions per xLSTM[7:1])
    ssm_chunk=128,
    notes="mLSTM chunked linear attention; sLSTM recurrent scan",
)
