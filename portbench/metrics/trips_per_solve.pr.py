"""Sweeps of the generated pr loop per solve over the window: the port's
counter `ell_sweep.launches` per call (one plus-times sweep a trip)."""


def read(run):
    if run.workload.get("program") != "pr" or not run.window.get("solves"):
        return None
    return run.counters["ell_sweep.launches"] / run.window["solves"]
