"""Spans inside the port, kept in memory as records.

Tracing is off by default. While it is off, `span(name)` checks one module
flag and returns one shared null context, so the hot path pays a function
call per span. Turn it on for a traced run:

    from repro_torch import trace
    trace.enable()
    ...                                  # run the program
    recs = trace.records()               # [Record, ...], oldest first
    trace.enable(False); trace.clear()

While it is on, each span keeps a `Record`: name, id, parent id, thread,
start and end in `time.perf_counter_ns()`, and the span's attributes. The
parent is the innermost span open on the same thread, so a span opened in
a worker thread (`asyncio.to_thread`) nests under that thread's spans
only. A span opens nothing in `torch.profiler`, so it adds no event to a
profiler trace; a reader puts the records on a trace's clock through the
wall clock (`portbench/spans.py`).

At most `CAP` records are kept (a few more where threads race at the cap);
the rest are counted by `dropped()`.
Counters stay where they are counted, as function attributes
(`ell_sweep.launches`, `rt.bfs_levels_batch.calls`, ...), and always
count.

Span names: `call.<function>` (`BoundProgram.__call__` and `.refresh`),
`trip` (one trip of a generated host loop), `host_read` (`rt.host_read`),
`bfs` (`rt.bfs_levels_batch`), `bfs.forward` and `bfs.reverse` (the
generated passes over a BFS's levels), `view` (a derived view built by
`GraphContext.view`) and `serve.sweep` (one sweep of `GraphService`, in
its worker thread).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

CAP = 1 << 20

_on = False
_NULL = contextlib.nullcontext()
_records: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    name: str
    id: int
    parent: int          # 0: no span was open on the thread
    thread: int          # threading.get_ident() of the opening thread
    start_ns: int        # time.perf_counter_ns()
    end_ns: int
    attrs: dict


def enable(on: bool = True) -> None:
    """Turn tracing on (or off). Records already kept stay."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str, **attrs):
    """A context manager around one unit of the program's work: the shared
    null context while tracing is off."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


def records() -> list:
    """The records kept so far, in the order their spans closed."""
    with _lock:
        kept = list(_records)
    return [Record(*r[:6], dict(r[6])) for r in kept]


def dropped() -> int:
    """Spans closed while `CAP` records were already kept."""
    return _dropped


def clear() -> None:
    """Forget every record and the count of dropped ones."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        try:
            st = _local.stack
        except AttributeError:
            st = _local.stack = []
        self.stack = st
        self.parent = st[-1] if st else 0
        self.id = next(_ids)
        st.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        # a plain tuple of atoms, which the garbage collector stops
        # tracking: a million kept records then add no pause to its sweeps.
        # One append holds the interpreter's lock, so threads need no other
        if len(_records) < CAP:
            _records.append((self.name, self.id, self.parent, threading.get_ident(),
                             self.start, end, tuple(self.attrs.items())))
        else:
            _drop()
        return False


def _drop():
    global _dropped
    with _lock:
        _dropped += 1
