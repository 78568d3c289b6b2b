"""Milliseconds in which the device ran no kernel inside each traced trip
of the generated sssp loop, on average: the program's `trip` spans on the
profiler's clock against the union of the kernels' run times."""
from portbench import spans


def read(run):
    if run.workload.get("program") != "sssp":
        return None
    return spans.idle_ms_per_span(run, "trip")
