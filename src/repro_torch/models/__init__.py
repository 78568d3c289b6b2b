"""The LM substrate of the port: every family of `configs.ARCHS` — dense,
moe, hybrid (Mamba2 + shared attention), ssm (xLSTM) and encdec —
prefilled through the flash-attention kernel where it attends, and decoded
through static caches. Training is not ported yet (ROADMAP queue 1,
item 12)."""
from . import attention, encdec, layers, moe, ssm, transformer, weights, zoo
from .zoo import Model, build

__all__ = ["attention", "encdec", "layers", "moe", "ssm", "transformer", "weights", "zoo",
           "Model", "build"]
