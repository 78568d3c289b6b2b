"""Device scalars read on the host per trip of the generated pr loop over
the window: the program's `host_read` spans that started in the window
over its counter `ell_sweep.launches` (one plus-times sweep a trip)."""
from portbench import spans


def read(run):
    c = run.counters
    if run.workload.get("program") != "pr" or not c or not c["ell_sweep.launches"]:
        return None
    reads = spans.window_records(run, "host_read")
    return None if reads is None else len(reads) / c["ell_sweep.launches"]
