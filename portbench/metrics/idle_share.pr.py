"""Share of the traced window of the pr cell in which no kernel ran on the
device: 1 - busy / window, from the profiler's trace."""


def read(run):
    t = run.traced
    if run.workload.get("program") != "pr" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
