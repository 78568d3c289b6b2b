"""The LM substrate of the port: every family of `configs.ARCHS` — dense,
moe, hybrid (Mamba2 + shared attention), ssm (xLSTM) and encdec —
prefilled through the flash-attention kernel where it attends, and decoded
through static caches, and trained by `repro_torch.train` (remat on the
layer bodies under grad)."""
from . import attention, encdec, layers, moe, ssm, transformer, weights, zoo
from .zoo import Model, build

__all__ = ["attention", "encdec", "layers", "moe", "ssm", "transformer", "weights", "zoo",
           "Model", "build"]
