"""The harness: one run of one cell, driven by the files `BENCHMARK.json`
names.

A run builds the configuration's graph on the device from `--seed`, hands
it to the cell's traffic driver (`traffic/<driver>.py`, named by the cell's
file `workloads/<cell>.json`), which binds the program and warms it up;
then measures for `--seconds`, has the driver make its few untimed calls
on sources drawn from `--seed`, frees the program's state and compares
what the timed path produced, and those calls, with the plain reference
(`reference/`). End-to-end
metrics come from the host clock; with `--trace 1` the window runs under
`torch.profiler` and each per-layer metric is read by its own reader,
`metrics/<metric>.py`.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import graphs, roofline

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NOT_FINITE = 1e30   # a reading that is not a finite number reads this


def load_module(path: Path):
    """A file of the benchmark as a module, by path (names may hold dots)."""
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> dict:
    """Everything one cell needs, found by name from `root/BENCHMARK.json`:
    the manifest, the cell's entry, its configuration and its cell file."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r}; workloads: {', '.join(sorted(cells))}")
    cell = cells[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    workload = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    return dict(root=root, manifest=manifest, cell=cell, config=config, workload=workload)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole (so `repro_torch` passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """The state of one run: inputs, spans, counters and what the window
    measured. Traffic drivers and metric readers read it."""

    def __init__(self, spec: dict, seed: int, seconds: float, device: str):
        self.spec = spec
        self.cell = spec["cell"]
        self.config = spec["config"]
        self.workload = spec["workload"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.spans: dict = {}
        self.counters: dict = {}
        self.traced: dict | None = None
        self.window: dict = {}
        self.fields = self.meta = self.graph = self.labels = self.cand = None
        self._prof = None
        self._trace_until = None

    # ---- inputs ----------------------------------------------------------
    def rng(self, stream: int) -> np.random.Generator:
        """A host generator for one purpose of this run, from the seed (the
        check's sample)."""
        return np.random.default_rng([self.seed, stream])

    def traffic_rng(self, stream: int) -> np.random.Generator:
        """A host generator of the traffic, from the configuration's graph
        seed: every run sends the same work, to vertices the run's seed
        labels."""
        return np.random.default_rng([int(self.config["graph"]["seed"]), stream])

    def set_inputs(self, fields, meta, labels):
        self.fields, self.meta = fields, meta
        self.labels = labels.cpu().numpy()
        out_deg = fields["out_degree"].cpu().numpy()
        # generated ids of the vertices of out-degree > 0, in generated order
        self.cand = np.flatnonzero(out_deg[self.labels] > 0)

    def sources(self, count: int, stream: int, from_seed: bool = False) -> np.ndarray:
        """`count` vertex ids of out-degree > 0 in an order drawn from the
        traffic's seed (or, `from_seed`, from the run's), distinct while
        count <= their number (the stream repeats past it)."""
        rng = self.rng(stream) if from_seed else self.traffic_rng(stream)
        order = rng.permutation(self.cand.shape[0])
        ids = self.labels[self.cand[order]]
        return np.resize(ids, count)

    # ---- timing ----------------------------------------------------------
    def sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own, summed by name; a `record_function`
        of the same name while the profiler runs."""
        t = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            try:
                yield
            finally:
                self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t

    def tick(self, solves: int):
        """Called after each completed call inside the window: stops the
        profiler at the first call boundary past the traced length."""
        if self._prof is not None and time.perf_counter() >= self._trace_until:
            self._stop_trace(solves)

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        self._trace_t0 = time.perf_counter()
        self._trace_until = self._trace_t0 + float(
            self.workload.get("trace_seconds", self.seconds))

    def _stop_trace(self, solves):
        """Stops the profiler; its events are read once the window is over
        (`reduce_traced`)."""
        self.sync()
        self._traced_raw = (self._prof, time.perf_counter() - self._trace_t0, solves)
        self._prof = None
        self._traced_raw[0].stop()

    def reduce_traced(self):
        prof, window_s, solves = self._traced_raw
        self.traced = reduce_trace(prof, window_s)
        self.traced["solves"] = solves

    # ---- the counters the port keeps ------------------------------------
    @staticmethod
    def read_counters() -> dict:
        from repro_torch.core import runtime as rt
        from repro_torch.kernels.ell_spmv import ops
        from repro_torch.kernels.ell_spmv.kernel import ell_sweep
        return {"ell_sweep.launches": ell_sweep.launches,
                "relax_minplus.push_steps": ops.relax_minplus.push_steps,
                "relax_minplus.pull_steps": ops.relax_minplus.pull_steps,
                "bfs_levels_batch.calls": rt.bfs_levels_batch.calls,
                "bfs_levels_batch.levels": rt.bfs_levels_batch.levels,
                "segment_sum_batch.calls": rt.segment_sum_batch.calls}


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, window_s: float) -> dict:
    """Device time by kernel, the busy seconds (the union of kernel
    intervals) and the longest idle gaps, each named by the benchmark's
    span and the innermost host operation open at its middle."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # the benchmark's own spans appear on the device's timeline as
            # annotations; they are no device work
            if not ev.name.startswith(("nccl:", "portbench.")):
                kernels.append((tr.start, tr.end, ev.name))
        else:
            host.append((tr.start, tr.end, ev.name))
    by_name: dict = {}
    for s, e, name in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s) / 1e6, c + 1)
    merged = _merge([(s, e) for s, e, _ in kernels])
    busy_s = sum(e - s for s, e in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    named = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        span, op = "none", "none"
        for hs, he, name in host:
            if hs <= mid <= he:
                if name.startswith("portbench."):
                    span = name
                elif op == "none" or he - hs < op_len:
                    op, op_len = name, he - hs
        named.append([f"{span} / {op}", length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return dict(window_s=window_s, busy_s=busy_s, kernels=by_name,
                device_ops=[[k[:160], v[0]] for k, v in top[:10]], idle_gaps=named)


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------

def driver_for(run: Run):
    return load_module(HERE / "traffic" / f"{run.workload['driver']}.py").Driver(run)


def build_inputs(run: Run):
    with run.span("graph"):
        run.set_inputs(*graphs.build(run.config, run.seed, run.device))
        run.graph = graphs.to_port(run.fields, run.meta)
        run.sync()
    run.digest = graphs.digest(run.fields)


def per_layer(run: Run, manifest: dict) -> dict:
    out = {}
    for m in manifest["per_layer"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(run: Run, manifest: dict, measured: dict) -> dict:
    out = {}
    for m in manifest["end_to_end"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        if m["name"] in measured:
            out[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    return out


def finite(x: float) -> float:
    return float(x) if np.isfinite(x) else NOT_FINITE


def judge(run: Run, readings: dict) -> tuple:
    """(correct, checks): every reading against its limit in the cell file;
    a reading without a limit, or a limit without a reading, is not
    correct."""
    limits = run.workload["limits"]
    checks = {k: {"value": finite(readings[k]), "limit": limits.get(k)} for k in readings}
    for k in limits:
        checks.setdefault(k, {"value": None, "limit": limits[k]})
    correct = all(c["value"] is not None and c["limit"] is not None
                  and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def check(run: Run, driver, control: bool = False) -> dict:
    """The readings of the sampled answers against the plain reference: the
    driver's answers, or the reference's own in its lower precision (the
    control)."""
    from portbench.reference import algorithms
    edges = algorithms.Edges(run.fields, run.meta["num_nodes"])
    out = {}
    for ref_name, params, items, got in driver.check_plan(control):
        mod = load_module(HERE / "reference" / f"{ref_name}.py")
        if not items:
            out[mod.READING] = NOT_FINITE
            continue
        with run.span("reference"):
            want = mod.reference(edges, items, params)
            if control:
                got = mod.reference(edges, items, params, control=True)
        # an answer missing for any checked item reads as not finite
        out[mod.READING] = mod.gap(got, want) if got and len(got) == len(items) \
            else NOT_FINITE
    del edges
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, driver_hook=None) -> tuple:
    """One run of one cell; returns the result line's object (its compared
    numbers under `checks`, last) and the run's notes. `driver_hook`
    (tests) may replace parts of the driver before set-up."""
    run = Run(spec, seed, seconds, device)
    build_inputs(run)
    driver = driver_for(run)
    if driver_hook is not None:
        driver_hook(driver)
    driver.setup()
    run.sync()
    if run.on_card:
        torch.cuda.reset_peak_memory_stats()
    before = run.read_counters()
    run.setup_s = time.perf_counter() - t_start
    if trace:
        run._start_trace()
    run.window = driver.measure(seconds)
    if trace:
        if run._prof is not None:
            run._stop_trace(run.window.get("solves"))
        run.reduce_traced()
    after = run.read_counters()
    run.counters = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated() if run.on_card else 0
    run.peak_bytes = peak

    layer = per_layer(run, spec["manifest"]) if trace else None
    with run.span("seed_check"):
        driver.seed_check()
        run.sync()
    driver.free()
    run.graph = None
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    readings = check(run, driver)
    readings["inputs_changed"] = float(sum(a != b for a, b in zip(run.digest,
                                                                graphs.digest(run.fields))))
    correct, checks = judge(run, readings)

    measured = dict(run.window.get("metrics", {}), setup_s=run.setup_s,
                    peak_mem_gib=peak / 2**30)
    result = {
        "correct": bool(correct),
        "attempted": int(run.window["attempted"]),
        "failed": int(run.window["failed"]),
        "metrics": layer if trace else end_to_end(run, spec["manifest"], measured),
        "device": device_info(run),
    }
    if trace and run.traced is not None:
        result["device"].update(busy_s=run.traced["busy_s"], window_s=run.traced["window_s"])
        result["breakdown"] = {"device_ops": run.traced["device_ops"],
                               "idle_gaps": run.traced["idle_gaps"]}
    result["checks"] = checks
    notes = dict(run.window.get("notes", {}), spans=run.spans, counters=run.counters)
    return result, notes


def device_info(run: Run) -> dict:
    if run.on_card:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(run.peak_bytes),
                "power": roofline.power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def print_checks(checks: dict, stream=sys.stderr):
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=stream)


def run_control(spec: dict, seed: int, seconds: float, device: str) -> dict:
    """The control of one seed: the reference computed in its lower
    precision (or its fixed point stopped short) in the program's place, on
    the answers a run of this seed would compare. No program runs."""
    run = Run(spec, seed, seconds, device)
    with run.span("graph"):
        run.set_inputs(*graphs.build(run.config, run.seed, run.device))
    readings = check(run, driver_for(run), control=True)
    readings["reference_s"] = run.spans.get("reference", 0.0)
    return readings


def run_sweep(spec: dict, seed: int, seconds: float, rates, device: str):
    """A service cell's driver at each offered rate in turn, one set-up."""
    run = Run(spec, seed, seconds, device)
    build_inputs(run)
    driver = driver_for(run)
    driver.setup()
    try:
        yield from driver.sweep(rates, seconds)
    finally:
        driver.free()
