"""Seconds of the benchmark's span around compiling and binding the
program (the service: `register_graph`), the reverse sliced-ELL view and
its sweep plan included."""


def read(run):
    return run.spans.get("bind")
