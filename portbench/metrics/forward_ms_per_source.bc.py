"""Device milliseconds per source of the traced bc calls spent in the forward
sigma pass over the BFS's levels (the generated `bfs.forward` span): the
union of the run times of the kernels launched inside those spans, divided
by the sources the traced calls solved."""
from portbench import spans


def read(run):
    t = run.traced
    if run.workload.get("program") != "bc" or not t or not t.get("solves"):
        return None
    ms = spans.launched_ms(run, "bfs.forward")
    return None if ms is None else ms / t["solves"]
