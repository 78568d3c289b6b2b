"""Share of the traced sweeps of a service cell in which the device ran no
kernel: the idle part of the service's `serve.sweep` spans on the
profiler's clock over their length."""
from portbench import spans


def read(run):
    if run.workload.get("driver") != "open_loop_service":
        return None
    return spans.idle_share(run, "serve.sweep")
