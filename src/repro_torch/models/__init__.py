"""The LM substrate of the port: the dense decoder family (qwen2.5-3b and
its kin), prefilled through the flash-attention kernel and decoded through
a static KV cache. The moe, hybrid, ssm and encdec families are not ported
yet (ROADMAP queue 1, item 12)."""
from . import attention, layers, transformer, weights, zoo
from .zoo import Model, build

__all__ = ["attention", "layers", "transformer", "weights", "zoo", "Model", "build"]
