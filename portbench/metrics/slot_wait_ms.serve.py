"""Milliseconds a sweep of the window waited from its batch forming to a
sweep slot (`max_concurrent_sweeps`), on average: the `slot_wait_s` of the
service's `serve.sweep` spans that started in the window."""
from portbench import spans


def read(run):
    if run.workload.get("driver") != "open_loop_service":
        return None
    sweeps = spans.window_records(run, "serve.sweep")
    if not sweeps:
        return None
    return 1e3 * sum(r.attrs["slot_wait_s"] for r in sweeps) / len(sweeps)
