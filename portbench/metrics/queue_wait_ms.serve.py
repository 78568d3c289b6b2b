"""Milliseconds a query of the window waited from its arrival to the start
of its sweep, on average: the `queue_wait_s` of the service's
`serve.sweep` spans that started in the window over the queries they
swept (`batch`)."""
from portbench import spans


def read(run):
    if run.workload.get("driver") != "open_loop_service":
        return None
    sweeps = spans.window_records(run, "serve.sweep")
    if not sweeps:
        return None
    return 1e3 * sum(r.attrs["queue_wait_s"] for r in sweeps) / sum(r.attrs["batch"] for r in sweeps)
