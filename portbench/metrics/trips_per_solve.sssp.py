"""Relax trips of the generated sssp loop per solve over the window: the
port's counters `relax_minplus.push_steps` + `.pull_steps` per call."""


def read(run):
    if run.workload.get("program") != "sssp" or not run.window.get("solves"):
        return None
    c = run.counters
    return (c["relax_minplus.push_steps"] + c["relax_minplus.pull_steps"]) / run.window["solves"]
