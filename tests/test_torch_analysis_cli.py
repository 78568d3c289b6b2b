"""The port's analysis CLI (`python -m repro_torch.analyze`) against the
reference's (`repro.core.analysis.cli`).

Mirrors tests/test_analysis.py's five CLI cases (strict-clean bundled, the
error exit, --strict, a --schedule knob, the --json round trip), then
holds the --json payload equal to the reference CLI's on every bundled
program and every file of tests/programs_bad/, under each backend (the
reference's `pallas` is the port's `cuda`) and under a schedule that
trips the legality check; and the frontend-failure exit.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.core.analysis.cli import main as ref_main
from repro_torch.core.analysis import Diagnostic
from repro_torch.core.analysis.cli import main as analyze_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAD_DIR = os.path.join(ROOT, "tests", "programs_bad")
BAD = sorted(os.path.join(BAD_DIR, f) for f in os.listdir(BAD_DIR) if f.endswith(".sp"))
BACKENDS = {"local": "local", "cuda": "pallas", "distributed": "distributed"}


# --- the reference's CLI cases -------------------------------------------------

def test_cli_bundled_strict_clean(capsys):
    assert analyze_main(["--bundled", "--strict", "--backend", "cuda"]) == 0
    assert "0 error(s), 0 warning(s)" in capsys.readouterr().out


def test_cli_reports_error_exit(capsys):
    assert analyze_main([os.path.join(BAD_DIR, "race_cross_write.sp")]) == 1
    assert "SP101" in capsys.readouterr().out


def test_cli_strict_promotes_warnings(capsys):
    path = os.path.join(BAD_DIR, "scalar_race.sp")
    assert analyze_main([path]) == 0
    assert analyze_main([path, "--strict"]) == 1


def test_cli_schedule_knobs(capsys):
    assert analyze_main(["tc", "--schedule", "priority=delta"]) == 1
    assert "SP201" in capsys.readouterr().out


def test_cli_json_round_trip(capsys):
    path = os.path.join(BAD_DIR, "nonmonotone_fixedpoint.sp")
    assert analyze_main([path, "--json"]) == 0   # SP153 is a warning
    payload = json.loads(capsys.readouterr().out)
    [target] = payload["targets"]
    diags = [Diagnostic.from_dict(d) for d in target["diagnostics"]]
    assert [d.code for d in diags] == ["SP153"]
    assert json.loads(json.dumps(target["functions"])) == target["functions"]


def test_cli_frontend_failure_exits_2(tmp_path, capsys):
    bad = tmp_path / "broken.sp"
    bad.write_text("function f(Graph g) { int x = ; }\n")
    assert analyze_main([str(bad)]) == ref_main([str(bad)]) == 2


def test_cli_refuses_the_references_backend_name():
    with pytest.raises(SystemExit):
        analyze_main(["--bundled", "--backend", "pallas"])


# --- --json equal to the reference's ---------------------------------------

def json_of(main, argv, capsys):
    code = main(argv + ["--json"])
    return code, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("schedule", [[], ["--schedule", "priority=delta",
                                           "--schedule", "dist_frontier=compact"]])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("targets", [["--bundled"]] + [[p] for p in BAD],
                         ids=["bundled"] + [os.path.basename(p) for p in BAD])
def test_json_equals_the_references(targets, backend, schedule, capsys):
    code, got = json_of(analyze_main, targets + ["--backend", backend] + schedule, capsys)
    ref_code, want = json_of(ref_main, targets + ["--backend", BACKENDS[backend]] + schedule,
                             capsys)
    assert got.pop("backend") == backend and want.pop("backend") == BACKENDS[backend]
    assert (code, got) == (ref_code, want)


def test_module_entry_point_runs_alone():
    """`python -m repro_torch.analyze` in a fresh interpreter: the port's
    CLI loads nothing of jax or of the reference package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['analyze', '--bundled', '--strict', '--backend', 'cuda']\n"
            "try:\n    runpy.run_module('repro_torch.analyze', run_name='__main__')\n"
            "except SystemExit as e:\n    status = e.code\n"
            "print('loaded', sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'repro'}))\n"
            "sys.exit(status)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "0 error(s), 0 warning(s)" in out.stdout
    assert "loaded []" in out.stdout
