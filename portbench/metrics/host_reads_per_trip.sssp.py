"""Device scalars read on the host per relax trip of the generated sssp
loop over the window: the program's `host_read` spans that started in the
window (one per `rt.host_read`: the push/pull choice and the `finished`
flag) over its counters `relax_minplus.push_steps` + `.pull_steps`."""
from portbench import spans


def read(run):
    c = run.counters
    if run.workload.get("program") != "sssp" or not c:
        return None
    trips = c["relax_minplus.push_steps"] + c["relax_minplus.pull_steps"]
    reads = spans.window_records(run, "host_read")
    if not trips or reads is None:
        return None
    return len(reads) / trips
