from ..schedule import Schedule
from .csr import (CSRGraph, ENGINE, EllGraph, EngineConfig, FIELDS, INF_I32,
                  SlicedEllGraph, from_arrays, from_edges, resolve_device,
                  resolve_schedule, to_ell, to_sliced_ell)
from .dynamic import (GraphDelta, RefreshPlan, apply_update, patch_sliced_ell,
                      sliced_ell_edges)
from .generators import (uniform_random, rmat, road, small_world,
                         powerlaw_social, preferential_attachment, load_suite,
                         SUITE)

__all__ = [
    "CSRGraph", "ENGINE", "EllGraph", "EngineConfig", "FIELDS", "INF_I32",
    "Schedule", "SlicedEllGraph", "from_arrays", "from_edges",
    "resolve_device", "resolve_schedule", "to_ell", "to_sliced_ell",
    "GraphDelta", "RefreshPlan", "apply_update", "patch_sliced_ell",
    "sliced_ell_edges", "uniform_random", "rmat", "road", "small_world",
    "powerlaw_social", "preferential_attachment", "load_suite", "SUITE",
]
