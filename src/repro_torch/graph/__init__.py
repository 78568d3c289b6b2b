from ..schedule import Schedule
from .csr import (CSRGraph, EllGraph, FIELDS, INF_I32, SlicedEllGraph,
                  from_arrays, from_edges, resolve_device, resolve_schedule,
                  to_ell, to_sliced_ell)
from .generators import (uniform_random, rmat, road, small_world,
                         powerlaw_social, preferential_attachment, load_suite,
                         SUITE)

__all__ = [
    "CSRGraph", "EllGraph", "FIELDS", "INF_I32", "Schedule", "SlicedEllGraph",
    "from_arrays", "from_edges", "resolve_device", "resolve_schedule",
    "to_ell", "to_sliced_ell", "uniform_random", "rmat", "road",
    "small_world", "powerlaw_social", "preferential_attachment",
    "load_suite", "SUITE",
]
