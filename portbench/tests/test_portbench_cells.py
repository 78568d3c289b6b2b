"""Each traffic driver through a whole run on the CPU at a small size: the
result line, the check that decides `correct`, the control, and the run
with the timed path broken underneath."""
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny
from portbench import harness

CELLS = ["kron22-bc32", "kron22-sssp", "kron22-service-mix", "kron22-pr"]


def spec_of(name, scale=8, **workload):
    spec = tiny(harness.load_cell(ROOT, name), scale)
    spec["workload"].update(workload)
    return spec


def run(spec, seed=2**31 + 11, seconds=0.4, trace=False, hook=None):
    return harness.run_cell(spec, seed, seconds, trace, "cpu", time.perf_counter(),
                            driver_hook=hook)[0]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_and_is_correct(name):
    extra = {"rate_qps": 25.0} if "service" in name else {}
    res = run(spec_of(name, **extra))
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_per_layer_metrics(name):
    extra = {"rate_qps": 25.0} if "service" in name else {}
    res = run(spec_of(name, **extra), trace=True)
    assert res["correct"]
    assert {"bind_s", "warm_s"} <= set(res["metrics"])
    assert "breakdown" in res and list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    spec = spec_of(name)
    readings = harness.run_control(spec, 5, 0.4, "cpu")
    readings.pop("reference_s")
    r = harness.Run(spec, 5, 0.4, "cpu")
    correct, checks = harness.judge(r, dict(readings, inputs_changed=0.0))
    assert not correct, checks


# ---- the timed path broken underneath ----------------------------------

def broken_program(fault):
    """A driver hook: the bound program's answer replaced as `fault` says."""
    def hook(driver):
        call = driver.call

        def bad(kw):
            if fault == "half_batch":
                srcs = kw["sourceSet"]
                out = dict(call(dict(kw, sourceSet=srcs[: len(srcs) // 2])))
                out["BC"] = out["BC"] * 2           # the mean over the half
                return out
            out = dict(call(kw))
            key = driver.output
            if fault == "unchanged":
                if key == "dist":
                    init = torch.full_like(out[key], 2**30)
                    init[kw["src"]] = 0
                elif key == "pageRank":
                    init = torch.full_like(out[key], 1.0 / out[key].shape[0])
                else:
                    init = torch.zeros_like(out[key])
                out[key] = init
            elif fault == "altered":
                t = out[key].clone()
                v = int(torch.argmax(t.double()))
                t[v] = t[v] + (1 if not t.dtype.is_floating_point else t[v] * 1e-2)
                out[key] = t
            return out
        driver.call = bad
    return hook


@pytest.mark.parametrize("name,fault", [
    ("kron22-bc32", "unchanged"), ("kron22-bc32", "half_batch"), ("kron22-bc32", "altered"),
    ("kron22-sssp", "unchanged"), ("kron22-sssp", "altered"),
    ("kron22-pr", "unchanged"), ("kron22-pr", "altered")])
def test_a_broken_program_is_not_correct(name, fault):
    res = run(spec_of(name), hook=broken_program(fault))
    assert not res["correct"], res["checks"]


def broken_service(fault):
    """A driver hook: every lane's runner broken as `fault` says."""
    def init_row(kind, n, src):
        row = np.full(n, 2**30 if kind == "sssp" else (-1 if kind == "bfs" else 0),
                      np.float32 if kind == "ppr" else np.int32)
        row[src] = 0 if kind != "ppr" else 1
        return row

    def wrap(kind, runner, n):
        def bad(params_list):
            if fault == "half_batch" and len(params_list) > 1:
                keep = runner(params_list[: len(params_list) // 2])
                mean = np.mean(np.stack(keep), axis=0).astype(keep[0].dtype)
                return keep + [mean] * (len(params_list) - len(keep))
            rows = runner(params_list)
            if fault == "unchanged":
                return [init_row(kind, n, int(p["src"])) for p in params_list]
            if fault == "altered":
                rows = [r.copy() for r in rows]
                rows[0][int(np.argmax(rows[0]))] += 1
            return rows
        return bad

    def hook(driver):
        setup = driver.setup

        def patched():
            setup()
            n = driver.run.meta["num_nodes"]
            for (_, kind), lane in driver.svc._lanes.items():
                lane.runner = wrap(kind, lane.runner, n)
        driver.setup = patched
    return hook


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_service_is_not_correct(fault):
    # a rate far above what the small graph needs, so lanes coalesce, and
    # every query checked
    spec = spec_of("kron22-service-mix", rate_qps=400.0,
                   check={"sssp": 10**6, "bfs": 10**6, "ppr": 10**6})
    res = run(spec, seconds=0.3, hook=broken_service(fault))
    assert not res["correct"], res["checks"]


def test_inputs_changed_under_the_program_is_not_correct():
    def hook(driver):
        call = driver.call

        def writes(kw):
            driver.run.fields["weights"][0] += 1
            return call(kw)
        driver.call = writes
    res = run(spec_of("kron22-sssp"), hook=hook)
    assert not res["correct"] and res["checks"]["inputs_changed"]["value"] > 0


# ---- what the check covers -----------------------------------------------

@pytest.mark.parametrize("name", ["kron22-bc32", "kron22-sssp"])
def test_the_seed_moves_the_checked_sources(name):
    def items(seed):
        spec = spec_of(name)
        r = harness.Run(spec, seed, 0.4, "cpu")
        r.set_inputs(*harness.graphs.build(spec["config"], seed, "cpu"))
        driver = harness.driver_for(r)
        labels = r.labels
        # the seed's own calls, as generated vertex ids
        return [np.argsort(labels)[np.asarray(s)].tolist() for s in driver.seed_calls]
    a, b = items(3), items(2**31 + 5)
    assert a and a != b


def test_a_seed_call_that_fails_is_not_correct():
    def hook(driver):
        seed_check = driver.seed_check

        def fails(kw):
            raise RuntimeError("no answer")

        def patched():
            driver.call = fails
            seed_check()
        driver.seed_check = patched
    res = run(spec_of("kron22-sssp"), hook=hook)
    assert not res["correct"] and res["checks"]["dist_mismatch"]["value"] == harness.NOT_FINITE


def test_the_service_serves_the_mix_and_refuses_an_unknown_knob():
    spec = spec_of("kron22-service-mix", rate_qps=25.0)
    seen = {}

    def hook(driver):
        setup = driver.setup

        def patched():
            setup()
            seen["kinds"] = sorted(kind for _, kind in driver.svc._lanes)
        driver.setup = patched
    assert run(spec, hook=hook)["correct"]
    assert seen["kinds"] == sorted(spec["workload"]["mix"])
    spec = spec_of("kron22-service-mix")
    spec["config"]["service"]["max_wait_m"] = 5.0
    with pytest.raises(TypeError):
        run(spec)


# ---- the harness is driven by data ----------------------------------------

def test_a_new_cell_of_an_existing_kind_needs_only_data(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((ROOT / "portbench" / "workloads" / "kron22-sssp.json").read_text())
    cell.update(program="sssp_pull", warm_calls=2)
    (tmp_path / "portbench" / "workloads" / "kron22-sssp-pull.json").write_text(json.dumps(cell))
    manifest["workloads"].append({"name": "kron22-sssp-pull", "config": "kron22",
                                  "traffic": "sssp-pull", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*.py")}
    spec = tiny(harness.load_cell(tmp_path, "kron22-sssp-pull"))
    res = harness.run_cell(spec, 3, 0.3, False, "cpu", time.perf_counter())[0]
    assert res["correct"] and res["attempted"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


# ---- the command ---------------------------------------------------------------

def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kron22-sssp",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_the_command_fails_with_only_its_own_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kron22-sssp",
                          "--seed", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kron22-sssp",
                          "--seed", "12345", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
