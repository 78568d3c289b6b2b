"""The port's serving layer: so far the LM engine (`engine.ServeEngine`,
batched greedy generation over the decode path). The graph-analytics
service of the reference is not ported yet (ROADMAP queue 1, item 10)."""
from .engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
