"""Milliseconds of a sweep of the window, on average: the length of the
service's `serve.sweep` spans (the lane's runner in its worker thread,
answers copied to the host included) that started in the window."""
from portbench import spans


def read(run):
    if run.workload.get("driver") != "open_loop_service":
        return None
    sweeps = spans.window_records(run, "serve.sweep")
    if not sweeps:
        return None
    return sum(r.end_ns - r.start_ns for r in sweeps) / 1e6 / len(sweeps)
