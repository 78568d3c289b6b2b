"""chip_smoke.py on a machine without a card: the smoke run refuses, the
CPU rehearsal runs the plain versions through every check and says it is
not a smoke run, and the per-call bound counts what the call must move."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ROOT / "chip_smoke.py"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def run_smoke(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(SMOKE), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_run_fails_without_a_card(no_card):
    r = run_smoke()
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no CUDA device" in r.stderr


def test_cpu_rehearsal_checks_every_run_and_is_not_a_smoke_run(no_card):
    r = run_smoke("--scale", "8", "--device", "cpu")
    assert r.returncode == 3, r.stderr
    assert "[check]" in r.stdout
    assert "not a smoke run" in r.stdout
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    runs = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith('  {"program"')]
    programs = ("sssp", "sssp_pull", "pr", "bc", "ppr", "cc", "lp", "kcore")
    assert {(i["program"], i["backend"]) for i in runs} == {
        (p, b) for p in programs for b in ("cuda", "local")}
    assert all(i["launches"] == i["sweep_launches"] == 0 for i in runs)   # the CPU never
    #                                                                     counts a launch
    assert "[oracles]" in r.stdout and '{"call": "dsl tc"' in r.stdout
    families = [json.loads(line) for line in r.stdout.splitlines()
                if line.startswith('  {"model"') and '"family"' in line]
    assert [f["model"] for f in families] == [
        "deepseek-moe-16b", "zamba2-1.2b", "xlstm-1.3b", "seamless-m4t-large-v2"]
    shapes = {"moe": 1, "hybrid": 1, "ssm": 0, "encdec": 3}    # distinct flash calls
    for f in families:
        assert f["kernel_vs_ref_f32"]["held"] and f["prefill_vs_decode_f32"]["held"]
        held16 = f["family"] in ("ssm", "encdec")
        assert f["kernel_vs_ref_bf16"]["held"] == f["prefill_vs_decode_bf16"]["held"] == held16
        assert f["serve"]["first_token_equal"] and f["flash_launches"] == 0
        assert len(f["flash_shapes_held"]) == shapes[f["family"]]
    assert len(families[-1]["serve"]["flash_shapes_held"]) == 1      # the cross call, SQ = 1
    assert "[lm-families]" in r.stdout
    dist = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith('  {"dist"')]
    assert {(d["dist"], d.get("frontier")) for d in dist} == {
        ("prepare", None), ("collectives", None), ("tc", None)} | {
        (p, f) for p in programs for f in ("dense", "auto")}
    assert all(d["gather_elems"] > 0 for d in dist if "frontier" in d)
    assert "[dist]" in r.stdout


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_bound_counts_each_operand_once():
    smoke = load_smoke()
    r, d, m, b = 1000, 8, 300, 32
    want = (2 * r * d + m * b + r * b) * 4 / smoke.HBM_BYTES_PER_S * 1e3
    ms, by = smoke.bound_ms(r, d, m, b)
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=1e-12)
    # fewer x rows reached, fewer bytes: the bound never counts unread rows
    assert smoke.bound_ms(r, d, m // 2, b)[0] < ms


@pytest.mark.parametrize("sq,skv,chunk", [(96, 96, 32), (64, 160, 24), (50, 50, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_in_blocks_of_query_rows_is_attention_ref(sq, skv, chunk, causal):
    """The plain version the smoke runs at 32K, one block of query rows at a
    time, is attention_ref of the whole: causal offsets included."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    smoke = load_smoke()
    gen = torch.Generator().manual_seed(sq + skv)
    q, k, v = (torch.randn((2, s, 32), generator=gen) for s in (sq, skv, skv))
    got = smoke.attention_ref_in_chunks(q, k, v, chunk, causal)
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal), rtol=1e-6,
                               atol=1e-6)
    err, excess, rel_rms = smoke.flash_vs_plain(got, got, chunk)
    assert err == 0 and rel_rms == 0 and excess <= 0
