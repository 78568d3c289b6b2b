"""Device milliseconds per source of the traced bc calls spent in the reverse
delta pass over the BFS's levels (the generated `bfs.reverse` span): the
union of the run times of the kernels launched inside those spans, divided
by the sources the traced calls solved."""
from portbench import spans


def read(run):
    t = run.traced
    if run.workload.get("program") != "bc" or not t or not t.get("solves"):
        return None
    ms = spans.launched_ms(run, "bfs.reverse")
    return None if ms is None else ms / t["solves"]
