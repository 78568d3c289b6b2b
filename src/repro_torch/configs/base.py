"""Model/config schema for the assigned-architecture zoo.

One `ModelConfig` per architecture (exact shapes from the assignment table)
plus a `smoke()` reduction used by per-arch CPU tests. A copy of
`repro.configs.base`, field for field.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss: float = 0.01
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    attn_every: int = 0          # hybrid: one shared attn block every k blocks
    # --- xLSTM ---
    slstm_every: int = 0         # sLSTM block every k blocks (rest mLSTM)
    # --- enc-dec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- numerics / schedule hints ---
    dtype: str = "bfloat16"
    scale_emb: float = 1.0       # minicpm-style mup scaling
    scale_depth: float = 0.0     # minicpm residual scaling (0 = off)
    wsd_schedule: bool = False   # minicpm warmup-stable-decay
    # --- modality frontend stub ---
    input_kind: str = "tokens"   # tokens | embeddings (audio/vision stubs)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to 256 so embedding/unembedding shard cleanly on the
        'model' axis (e.g. minicpm's 122753 is odd). Labels always index
        below the true vocab; pad logits are dead weight only."""
        return -(-self.vocab // 256) * 256

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=self.d_ff and 256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            ssm_chunk=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
        )


# Shape cells from the assignment (per-arch shape set)
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode | long_decode


LM_SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "long_decode"),
)

# long_500k only for sub-quadratic archs (SSM / hybrid); skips per DESIGN.md
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_cells_for(cfg: ModelConfig):
    cells = []
    for cell in LM_SHAPES:
        if cell.kind == "long_decode" and cfg.family not in LONG_CONTEXT_FAMILIES:
            continue   # pure full-attention archs skip long_500k (DESIGN.md §5)
        cells.append(cell)
    return tuple(cells)
