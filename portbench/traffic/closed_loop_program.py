"""Closed loop of one client over one bound program.

The client calls `compile_bundled(program, backend="cuda").bind(g)(...)`
back to back, each call ending in a device sync, and takes its next call's
`sources_per_call` sources (distinct within a call; none for an unrooted
program) from a stream drawn among the vertices of out-degree > 0: the
same generated vertices in every run, under the labels its seed drew. The call in flight when the window ends finishes;
the rate divides the completed solves by the window's actual length.

The cell file gives `program`, `metric` (the name its rate is reported
under; `solves_per_s` unless given), `params` (fixed program arguments),
`source_param`, `sources_per_call`, `solves_per_call`, `output` (the
result key compared), `reference` (a module of `reference/`), `warm_calls`,
and the check's sample: the window's first call and `check_calls` calls
drawn from the seed among the first `check_from_first` of the window, and
`seed_calls` calls after the window, not timed, on sources drawn from the
run's seed, so every seed checks other sources too.
"""
from __future__ import annotations

import time

import numpy as np


class Driver:
    def __init__(self, run):
        self.run = run
        wl = run.workload
        self.program = wl["program"]
        self.params = dict(wl.get("params", {}))
        self.source_param = wl.get("source_param")
        self.per_call = int(wl.get("sources_per_call", 0))
        self.solves_per_call = int(wl["solves_per_call"])
        self.output = wl["output"]
        self.warm_calls = int(wl["warm_calls"])
        self.stream = run.sources(run.meta["num_nodes"], stream=1) if self.per_call else None
        # the window's first call, and calls drawn from the seed among the
        # first `check_from_first`
        rng = run.rng(2)
        k = min(int(wl["check_calls"]), int(wl["check_from_first"]))
        self.sample = {0} | set(int(i) for i in rng.choice(int(wl["check_from_first"]), k,
                                                           replace=False))
        self.seed_calls = [self._seed_args(j) for j in range(int(wl.get("seed_calls", 0)))] \
            if self.per_call else []
        self.kept: dict = {}
        self.seed_kept: list = []
        self.bound = None

    # ---- the calls -------------------------------------------------------
    def sources_of(self, call: int):
        """The sources of call `call` (warm-up calls first), as int32."""
        n = self.stream.shape[0]
        idx = (np.arange(self.per_call) + call * self.per_call) % n
        return self.stream[idx].astype(np.int32)

    def args(self, call: int) -> dict:
        return self._with_sources(self.sources_of(call)) if self.per_call \
            else dict(self.params)

    def _with_sources(self, srcs: np.ndarray) -> dict:
        kw = dict(self.params)
        kw[self.source_param] = int(srcs[0]) if self.per_call == 1 \
            and self.source_param == "src" else srcs
        return kw

    def _seed_args(self, j: int) -> np.ndarray:
        """The sources of untimed call `j` after the window, from the run's
        seed (a stream of their own, distinct within a call)."""
        return self.run.sources(self.per_call, stream=10 + j, from_seed=True).astype(np.int32)

    def call(self, kw: dict) -> dict:
        return self.bound(**kw)

    def setup(self):
        from repro_torch.core import compile_bundled
        run = self.run
        with run.span("bind"):
            self.bound = compile_bundled(self.program, backend="cuda").bind(run.graph)
            run.sync()
        with run.span("warm"):
            for i in range(self.warm_calls):
                self.call(self.args(i))
                run.sync()

    def measure(self, seconds: float) -> dict:
        run = self.run
        done = failed = 0
        errors = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            i = done + failed
            try:
                with run.span("call"):
                    out = self.call(self.args(self.warm_calls + i))
                    run.sync()
            except Exception as exc:   # a failed call counts, the loop goes on
                failed += 1
                errors.append(repr(exc)[:300])
                if failed >= 3:
                    break
                continue
            if i in self.sample:
                self.kept[i] = out[self.output].detach().cpu()
            del out
            done += 1
            run.tick(done * self.solves_per_call)
        elapsed = time.perf_counter() - t0
        solves = done * self.solves_per_call
        return dict(attempted=done + failed, failed=failed, solves=solves,
                    metrics={self.run.workload.get("metric", "solves_per_s"): solves / elapsed},
                    notes=dict(calls=done, window_s=elapsed, errors=errors))

    def seed_check(self):
        """The untimed calls on the seed's sources; the answers of those
        that return are kept for the check."""
        for srcs in self.seed_calls:
            try:
                out = self.call(self._with_sources(srcs))
            except Exception:   # no answer: the check reads not finite
                continue
            self.seed_kept.append(out[self.output].detach().cpu())

    def free(self):
        self.bound = None

    # ---- the check -------------------------------------------------------
    def check_plan(self, control: bool) -> list:
        """[(reference module, params, items, answers)] for the sampled
        calls that the window completed and the untimed calls on the seed's
        sources (every one of them for a control, which runs no program)."""
        calls = sorted(self.sample if control else self.kept)
        items = [self.sources_of(self.warm_calls + i).tolist() if self.per_call else None
                 for i in calls]
        items += [srcs.tolist() for srcs in self.seed_calls]
        if self.per_call == 1:
            items = [s[0] for s in items]
        got = None if control else [self.kept[i] for i in calls] + self.seed_kept
        return [(self.run.workload["reference"], self.params, items, got)]
