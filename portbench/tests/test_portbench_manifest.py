"""`BENCHMARK.json` against the benchmark's contract, and every file it
names."""
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = ROOT / "portbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"] and M["command"] == ["python3", "portbench/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["graph"]["kind"] == "kronecker"
        assert len(c["reduced"]) <= 16 and c["name"] in used
        # a cut names keys of the file, with its reason under `assumed`
        assert set(c["reduced"]) <= set(cfg)


def test_workloads():
    names = {c["name"] for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (BENCH / "traffic" / f"{cell['driver']}.py").exists()
        refs = [cell["reference"]] if "reference" in cell else \
            [k["reference"] for k in cell["kinds"].values()]
        for r in refs:
            assert (BENCH / "reference" / f"{r}.py").exists()
        assert cell["limits"]["inputs_changed"] == 0


def metrics():
    return M["end_to_end"] + M["per_layer"]


def test_metric_names_and_units():
    seen = set()
    for m in metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    names = {m["name"] for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in names
        assert set(m["workloads"]) <= cells
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    from portbench import harness
    assert callable(harness.load_module(BENCH / "metrics" / f"{m['name']}.py").read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in M["per_layer"])


def test_files_are_named_from_names():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
