"""Open loop of independent clients against `repro_torch.serve.GraphService`.

Queries arrive on a schedule drawn before the window opens, whether or not
the service has kept up. It is drawn from the configuration's graph seed,
so every run sends the same queries to the vertices its own seed labelled:
the window's `round(rate_qps * seconds)` arrival times are uniform over the
window and sorted (a Poisson process given its count), the kinds are the
mix's shares of them in a drawn order, and each query's `src` is uniform
among the vertices of out-degree > 0. Each latency runs from the
scheduled arrival to the answer on the host, so a stall is charged to
every query behind it.
Every query that arrived in the window is waited for (up to `drain_s` past
its close) and counted; one rejected, timed out or failed counts as beyond
every limit.

The service is built from the configuration's `service` block, every key
a `ServiceConfig` field (an unknown key is an error), and serves the
kinds the mix sends.

The cell file gives `rate_qps`, `mix` ({kind: share}), `kinds` ({kind:
{"reference": module of `reference/`, "params": ...}}), `check` ({kind:
rows of the window compared}), `seed_queries` ({kind: queries sent at once
after the window, not timed, on sources drawn from the run's seed, and
compared}), `warm_width` (the small lane warmed for each kind after a
lone query) and `drain_s`.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np


GRAPH = "g"
FAILED_MS = 3.6e6   # the latency a failed query counts as: beyond any limit


def draw_queries(rng, rate: float, seconds: float, mix: dict, cand: np.ndarray):
    """(arrival s, kind, src) of every query of one window."""
    n = int(round(rate * seconds))
    at = np.sort(rng.uniform(0.0, seconds, n))
    kinds = sorted(mix)
    counts = [int(round(mix[k] * n)) for k in kinds]
    counts[-1] = n - sum(counts[:-1])
    order = rng.permutation(np.repeat(np.arange(len(kinds)), counts))
    srcs = cand[rng.integers(0, cand.shape[0], n)]
    return [(float(at[i]), kinds[order[i]], int(srcs[i])) for i in range(n)]


def backlog(arrivals: np.ndarray, done: np.ndarray, t: float) -> int:
    """Queries that had arrived by `t` and were not answered by then."""
    return int(np.sum((arrivals <= t) & (done > t)))


class Driver:
    def __init__(self, run):
        self.run = run
        wl = run.workload
        self.mix = wl["mix"]
        self.kinds = wl["kinds"]
        self.cand = run.labels[run.cand]
        self.queries = draw_queries(run.traffic_rng(3), float(wl["rate_qps"]), run.seconds,
                                    self.mix, self.cand)
        self.sample = self._sample(run.rng(4), self.queries)
        self.seed_queries = [(kind, int(src)) for kind, k in
                             sorted(wl.get("seed_queries", {}).items())
                             for src in run.sources(k, stream=20 + sorted(self.mix).index(kind),
                                                    from_seed=True)]
        self.kept: dict = {}
        self.seed_kept: dict = {}
        self.svc = None
        self.loop = None

    def _sample(self, rng, queries) -> set:
        want = self.run.workload["check"]
        out = set()
        for kind, k in want.items():
            idx = [i for i, q in enumerate(queries) if q[1] == kind]
            out.update(int(i) for i in rng.choice(idx, min(k, len(idx)), replace=False))
        return out

    # ---- set-up ------------------------------------------------------------
    def setup(self):
        from repro_torch.serve import GraphService, ServiceConfig
        run = self.run
        self.loop = asyncio.new_event_loop()
        with run.span("bind"):
            self.svc = GraphService(ServiceConfig(**run.config["service"]))
            self.svc.register_graph(GRAPH, run.graph, kinds=sorted(self.mix))
            run.sync()
        with run.span("warm"):
            self.loop.run_until_complete(self._warm())
            run.sync()

    async def _warm(self):
        """A lone query of each kind (the bound program's path), then a
        small lane of each kind (the batched engine), as the window's
        sparse arrivals form them."""
        width = int(self.run.workload["warm_width"])
        rng = self.run.traffic_rng(5)
        for kind in sorted(self.mix):
            srcs = self.cand[rng.integers(0, self.cand.shape[0], width + 1)]
            await self.svc.query(GRAPH, kind, src=int(srcs[0]))
            await asyncio.gather(*(self.svc.query(GRAPH, kind, src=int(s))
                                   for s in srcs[1:]))

    def seed_check(self):
        """The seed's queries, sent at once after the window; those
        answered are kept for the check."""
        async def burst():
            return await asyncio.gather(*(self.svc.query(GRAPH, kind, src=src)
                                          for kind, src in self.seed_queries),
                                        return_exceptions=True)
        for i, res in enumerate(self.loop.run_until_complete(burst())):
            if not isinstance(res, BaseException):
                self.seed_kept[i] = res

    # ---- the window ----------------------------------------------------------
    async def _load(self, queries, seconds: float, keep: set) -> dict:
        from repro_torch.serve import ServiceError
        loop = asyncio.get_running_loop()
        n = len(queries)
        lat = np.full(n, FAILED_MS)
        done_at = np.full(n, np.inf)
        lag = np.zeros(n)
        status = ["ok"] * n
        t0 = loop.time() + 0.05

        async def one(i):
            at, kind, src = queries[i]
            due = t0 + at
            delay = due - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            lag[i] = loop.time() - due
            try:
                res = await self.svc.query(GRAPH, kind, src=src)
            except ServiceError as exc:
                status[i] = type(exc).__name__
                return
            now = loop.time()
            lat[i] = (now - due) * 1e3
            done_at[i] = now - t0
            if i in keep:
                self.kept[i] = res

        tasks = [asyncio.ensure_future(one(i)) for i in range(n)]
        drain = float(self.run.workload["drain_s"])
        finished, pending = await asyncio.wait(tasks, timeout=seconds + 0.05 + drain)
        for t in pending:
            t.cancel()
            status[tasks.index(t)] = "unanswered"
        await asyncio.gather(*pending, return_exceptions=True)
        for t in finished:
            t.result()
        end = loop.time() - t0
        arrivals = np.array([q[0] for q in queries])
        return dict(lat=lat, status=status, lag=lag, end=end,
                    backlog_mid=backlog(arrivals, done_at, seconds / 2),
                    backlog_end=backlog(arrivals, done_at, seconds))

    def _window(self, queries, seconds: float, keep: set) -> dict:
        before = self.svc.stats()
        out = self.loop.run_until_complete(self._load(queries, seconds, keep))
        after = self.svc.stats()
        sweeps = after["sweeps"] - before["sweeps"]
        coalesced = after["mean_batch"] * after["sweeps"] - before["mean_batch"] * before["sweeps"]
        out["sweeps"] = sweeps
        out["mean_batch"] = coalesced / sweeps if sweeps else None
        out["rejected"] = after["rejected"] - before["rejected"]
        out["timeouts"] = after["timeouts"] - before["timeouts"]
        return out

    def measure(self, seconds: float) -> dict:
        w = self._window(self.queries, seconds, self.sample)
        failed = sum(s != "ok" for s in w["status"])
        notes = dict(queries=len(self.queries), p50_ms=float(np.percentile(w["lat"], 50)),
                     lag_max_s=float(w["lag"].max(initial=0.0)),
                     lag_mean_s=float(w["lag"].mean()) if len(w["lag"]) else 0.0,
                     rejected=w["rejected"], timeouts=w["timeouts"], sweeps=w["sweeps"],
                     mean_batch=w["mean_batch"], backlog_mid=w["backlog_mid"],
                     backlog_end=w["backlog_end"], drained_s=w["end"] - seconds)
        p95 = float(np.percentile(w["lat"], 95)) if len(w["lat"]) else FAILED_MS
        return dict(attempted=len(self.queries), failed=failed,
                    metrics={"query_p95_ms": p95}, notes=notes)

    def sweep(self, rates, seconds: float):
        """Yield one line per offered rate: whether the service sustained it
        (no query rejected or timed out, and no larger backlog at the
        window's end than at its middle)."""
        for rate in rates:
            queries = draw_queries(self.run.traffic_rng(int(rate * 1000) + 7), rate, seconds,
                                   self.mix, self.cand)
            t = time.perf_counter()
            w = self._window(queries, seconds, set())
            failed = sum(s != "ok" for s in w["status"])
            yield dict(rate_qps=rate, queries=len(queries), failed=failed,
                       rejected=w["rejected"], timeouts=w["timeouts"],
                       backlog_mid=w["backlog_mid"], backlog_end=w["backlog_end"],
                       p50_ms=float(np.percentile(w["lat"], 50)),
                       p95_ms=float(np.percentile(w["lat"], 95)),
                       lag_max_s=float(w["lag"].max(initial=0.0)),
                       mean_batch=w["mean_batch"], wall_s=time.perf_counter() - t,
                       sustained=bool(failed == 0 and w["backlog_end"] <= w["backlog_mid"]))

    def free(self):
        if self.svc is not None:
            self.loop.run_until_complete(self.svc.close())
            self.svc = None
        if self.loop is not None:
            # the sweeps' worker threads end here, not at interpreter exit
            self.loop.run_until_complete(self.loop.shutdown_default_executor())
            self.loop.close()
            self.loop = None

    # ---- the check -------------------------------------------------------
    def check_plan(self, control: bool) -> list:
        """[(reference module, params, items, answers)] per kind: the
        window's sampled queries and the seed's queries. A query that was
        never answered has no answer, and its kind reads as not finite."""
        plan = []
        for kind in sorted(self.kinds):
            idx = sorted(i for i in self.sample if self.queries[i][1] == kind)
            extra = [j for j, q in enumerate(self.seed_queries) if q[0] == kind]
            items = [self.queries[i][2] for i in idx] + [self.seed_queries[j][1] for j in extra]
            got = None if control else \
                [self.kept[i] for i in idx if i in self.kept] + \
                [self.seed_kept[j] for j in extra if j in self.seed_kept]
            spec = self.kinds[kind]
            plan.append((spec["reference"], spec.get("params", {}), items, got))
        return plan
