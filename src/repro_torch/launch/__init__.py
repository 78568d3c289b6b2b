"""Launch layer: mesh construction, sharding rules, roofline analysis and
the entry points `python -m repro_torch.launch.train`, `.dryrun` and
`.report` (not imported here: they run as __main__; the dry run brings up
its fake process group only when it runs a cell)."""
from . import mesh, roofline, sharding

__all__ = ["mesh", "roofline", "sharding"]
