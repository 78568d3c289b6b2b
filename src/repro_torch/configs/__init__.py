"""Architecture registry: one module per assigned architecture.

The port's own copy of `repro.configs` (plain data, no framework): the port
imports nothing of the JAX package, so it keeps the configs beside its
models. Keep the two copies equal; tests/test_torch_lm.py checks that they
are.
"""
from __future__ import annotations

from .base import LM_SHAPES, ModelConfig, ShapeCell, shape_cells_for
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .minicpm_2b import CONFIG as minicpm_2b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .chameleon_34b import CONFIG as chameleon_34b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .zamba2_1_2b import CONFIG as zamba2_1_2b
from .xlstm_1_3b import CONFIG as xlstm_1_3b
from .starplat_graph import GRAPH_CONFIGS

ARCHS = {
    c.name: c for c in [
        qwen2_5_3b, minicpm_2b, mistral_large_123b, phi4_mini_3_8b,
        seamless_m4t_large_v2, chameleon_34b, qwen3_moe_235b_a22b,
        deepseek_moe_16b, zamba2_1_2b, xlstm_1_3b,
    ]
}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]
