"""Launch layer: mesh construction, sharding rules and the training entry point
(`python -m repro_torch.launch.train`, not imported here: it runs as
__main__)."""
from . import mesh, sharding

__all__ = ["mesh", "sharding"]
