"""Seconds of the benchmark's span around the warm-up calls before the
window (the first run of a checkout includes the kernel build)."""


def read(run):
    return run.spans.get("warm")
