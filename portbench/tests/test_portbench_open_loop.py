"""The open-loop generator: arrivals fixed before the window, latency from
the scheduled arrival, so a stalled server shows in the tail."""
import asyncio
import time

import numpy as np

from portbench.traffic import open_loop_service as ols


class FakeService:
    """Answers each query after `service_s`; one query stalls the server
    (a lock held) for `stall_s`."""

    def __init__(self, service_s=0.002, stall_at=None, stall_s=0.0):
        self.service_s, self.stall_at, self.stall_s = service_s, stall_at, stall_s
        self.lock = None
        self.n = 0
        self.sweeps = 0

    async def query(self, graph, kind, *, src):
        if self.lock is None:
            self.lock = asyncio.Lock()
        async with self.lock:
            self.n += 1
            stall = self.stall_s if self.n == self.stall_at else 0.0
            time.sleep(self.service_s + stall)      # the server blocks, as a sweep does
            self.sweeps += 1
        return np.zeros(4, np.int32)

    def stats(self):
        return {"sweeps": self.sweeps, "mean_batch": 1.0, "rejected": 0, "timeouts": 0}


class FakeRun:
    workload = {"drain_s": 10}


def window(svc, queries, seconds):
    d = ols.Driver.__new__(ols.Driver)
    d.run, d.svc, d.kept = FakeRun(), svc, {}
    d.loop = asyncio.new_event_loop()
    try:
        return d._window(queries, seconds, set())
    finally:
        d.loop.close()


def test_arrivals_are_fixed_and_mixed_as_asked():
    cand = np.arange(100, 200)
    a = ols.draw_queries(np.random.default_rng(1), 50.0, 2.0, {"sssp": 0.6, "bfs": 0.2,
                                                             "ppr": 0.2}, cand)
    b = ols.draw_queries(np.random.default_rng(1), 50.0, 2.0, {"sssp": 0.6, "bfs": 0.2,
                                                             "ppr": 0.2}, cand)
    assert a == b and len(a) == 100
    kinds = [q[1] for q in a]
    assert kinds.count("sssp") == 60 and kinds.count("bfs") == 20
    times = [q[0] for q in a]
    assert times == sorted(times) and 0 <= times[0] and times[-1] < 2.0
    assert all(100 <= q[2] < 200 for q in a)


def test_a_stalled_server_shows_in_the_tail():
    queries = ols.draw_queries(np.random.default_rng(2), 40.0, 1.5, {"sssp": 1.0},
                               np.arange(10))
    calm = window(FakeService(), queries, 1.5)
    stalled = window(FakeService(stall_at=20, stall_s=0.4), queries, 1.5)
    p95 = lambda w: float(np.percentile(w["lat"], 95))  # noqa: E731
    assert p95(calm) < 100
    # every query that arrived during the stall waits it out
    assert p95(stalled) > 200 and p95(stalled) > 3 * p95(calm)
    assert all(s == "ok" for s in stalled["status"])


def test_backlog_counts_what_arrived_and_was_not_answered():
    arrivals = np.array([0.0, 0.1, 0.2, 0.9])
    done = np.array([0.05, 0.5, np.inf, 1.0])
    assert ols.backlog(arrivals, done, 0.3) == 2
    assert ols.backlog(arrivals, done, 0.95) == 2
