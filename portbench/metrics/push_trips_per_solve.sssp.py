"""Push trips (the scatter-min over out-edges) of sssp per solve over the
window: the port's counter `relax_minplus.push_steps` per call."""


def read(run):
    if run.workload.get("program") != "sssp" or not run.window.get("solves"):
        return None
    return run.counters["relax_minplus.push_steps"] / run.window["solves"]
