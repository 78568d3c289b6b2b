from ..schedule import Schedule
from .csr import (CSRGraph, ENGINE, EllGraph, EngineConfig, FIELDS, INF_I32,
                  SlicedEllGraph, from_arrays, from_edges, pad_nodes,
                  resolve_device, resolve_schedule, to_dense, to_ell, to_sliced_ell)
from .dynamic import (GraphDelta, RefreshPlan, apply_update, patch_sliced_ell,
                      sliced_ell_edges)
from .partition import (Partition1D, Partition2D, block_partition_1d, partition_2d,
                        piece_order_to_global)
from .generators import (uniform_random, rmat, road, small_world,
                         powerlaw_social, preferential_attachment, load_suite,
                         SUITE)
from . import io

__all__ = [
    "CSRGraph", "ENGINE", "EllGraph", "EngineConfig", "FIELDS", "INF_I32",
    "Schedule", "SlicedEllGraph", "from_arrays", "from_edges", "pad_nodes",
    "resolve_device", "resolve_schedule", "to_dense", "to_ell", "to_sliced_ell",
    "io",
    "GraphDelta", "RefreshPlan", "apply_update", "patch_sliced_ell",
    "sliced_ell_edges", "Partition1D", "Partition2D", "block_partition_1d",
    "partition_2d", "piece_order_to_global", "uniform_random",
    "rmat", "road", "small_world", "powerlaw_social", "preferential_attachment", "load_suite", "SUITE",
]
