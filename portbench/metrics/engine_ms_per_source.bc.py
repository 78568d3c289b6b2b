"""Device milliseconds per source of the traced bc calls: the profiler's
busy time over the traced window, which ends at a call boundary, divided
by the sources those calls solved."""


def read(run):
    t = run.traced
    if run.workload.get("program") != "bc" or not t or not t.get("solves") \
            or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["solves"]
