"""repro_torch.serve — the port's serving layer; two engines live here.

* `graph_service.GraphService` — **the graph-analytics serving entry
  point**: an async multi-tenant service that coalesces concurrent
  SSSP/BFS/BC/PPR queries across users and graphs into the engine's
  batched [B, N] lanes, with a `GraphPool` of per-graph contexts
  (memory-bounded LRU view eviction), `TuningStore` warm-reload on
  registration, write batches (`update_graph`), and admission/deadline
  handling. `ServiceConfig(backend="cuda")` runs it on the card.
* `engine.ServeEngine` — the LM serving engine (batched greedy generation
  over the decode path). Unrelated to graph queries.
"""
from .engine import GenerationResult, ServeEngine
from .graph_service import (BUILTIN_KINDS, GraphService, QueryKind,
                            ServiceClosed, ServiceConfig, ServiceError,
                            ServiceOverloaded, ServiceTimeout, UnknownGraph,
                            UnknownQueryKind)
from .pool import GraphPool

__all__ = [
    "BUILTIN_KINDS", "GenerationResult", "GraphPool", "GraphService",
    "QueryKind", "ServeEngine", "ServiceClosed", "ServiceConfig",
    "ServiceError", "ServiceOverloaded", "ServiceTimeout", "UnknownGraph",
    "UnknownQueryKind",
]
