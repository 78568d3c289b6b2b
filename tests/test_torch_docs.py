"""Docs lint of the port: `docs/torch_port.md` maps every module of
`src/repro_torch/` onto the reference, names the reference's `pallas_call`
sites truly and every `REPRO_*` variable either package reads; and the
reference's knob pages (`docs/schedule.md`, `docs/serving.md`,
`docs/analysis.md`) hold for the port's `Schedule`, `ServiceConfig` and
diagnostics registry, checked with tests/test_docs.py's regexes."""
import dataclasses
import pathlib
import re

import pytest

from repro_torch.core.analysis import REGISTRY
from repro_torch.schedule import Schedule
from repro_torch.serve import ServiceConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
DOCS = ROOT / "docs"
PAGE = DOCS / "torch_port.md"
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
MAP_ROW = re.compile(r"^\| `src/repro_torch/([^`]+\.py)` \| (?:`src/repro/([^`]+\.py)`|(new)) \|",
                     re.MULTILINE)
SITE = re.compile(r"`(src/repro/kernels/[^`:]+\.py):(\d+)`")
READS = re.compile(r"""environ(?:\.get\(|\[)\s*["'](REPRO_[A-Z0-9_]+)["']""")


def read(path):
    return path.read_text()


def section(text, title):
    m = re.search(rf"^## {re.escape(title)}\n(.*?)(?=^## |\Z)", text, re.DOTALL | re.MULTILINE)
    assert m, f"docs/torch_port.md lost its '## {title}' section"
    return m.group(1)


def test_page_exists_and_the_readme_links_it():
    assert PAGE.exists()
    assert "docs/torch_port.md" in read(ROOT / "README.md")


def test_relative_links_resolve():
    links = re.findall(r"\[[^\]]*\]\(([^)]+)\)", read(PAGE))
    assert links
    for target in links:
        if target.startswith(("http://", "https://", "#")):
            continue
        resolved = (DOCS / target.split("#")[0]).resolve()
        assert resolved.exists(), f"dead relative link {target!r}"


def test_module_map_has_one_row_per_port_file():
    rows = MAP_ROW.findall(section(read(PAGE), "Module map"))
    documented = [port for port, _, _ in rows]
    actual = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
    assert len(documented) == len(set(documented)), "a file has two rows"
    assert sorted(documented) == actual, (
        f"undocumented={sorted(set(actual) - set(documented))}, "
        f"stale={sorted(set(documented) - set(actual))}")


def test_module_map_counterparts_exist():
    rows = MAP_ROW.findall(section(read(PAGE), "Module map"))
    for port, ref, new in rows:
        if new:
            assert not (REF / port).exists(), f"{port} is marked new but src/repro/{port} exists"
        else:
            assert (REF / ref).exists(), f"{port}: no src/repro/{ref}"


def test_pallas_call_sites_are_true():
    sites = SITE.findall(section(read(PAGE), "The three TPU kernels"))
    assert {path for path, _ in sites} == {
        f"src/repro/kernels/{k}/kernel.py" for k in ("ell_spmv", "flash_attention", "tc_matmul")}
    for path, line in sites:
        lines = read(ROOT / path).splitlines()
        assert "pallas_call" in lines[int(line) - 1], f"{path}:{line} holds no pallas_call"


def test_every_variable_either_package_reads_has_a_row():
    read_vars = {v for pkg in (REF, PORT) for p in pkg.rglob("*.py")
                 for v in READS.findall(read(p))}
    assert {"REPRO_ATTN_SHARD", "REPRO_MICROBATCHES", "REPRO_NO_CONSTRAIN"} <= read_vars
    rows = set(re.findall(r"^\| `(REPRO_[A-Z0-9_]+)` \|",
                          section(read(PAGE), "Environment variables"), re.MULTILINE))
    assert rows == read_vars, f"missing={sorted(read_vars - rows)}, stale={sorted(rows - read_vars)}"


def knob_rows(text):
    names = set(re.findall(r"^\| `([a-z_]+)` \|", text, re.MULTILINE))
    defaults = re.findall(r"^\| `([a-z_]+)` \| [^|]+ \| `([^`]+)`", text, re.MULTILINE)
    return names, defaults


def serving_section():
    m = re.search(r"## ServiceConfig knobs\n(.*?)(?:\n## |\Z)", read(DOCS / "serving.md"),
                  re.DOTALL)
    assert m, "docs/serving.md lost its '## ServiceConfig knobs' section"
    return m.group(1)


@pytest.mark.parametrize("cls, text, every_default", [
    (Schedule, lambda: read(DOCS / "schedule.md"), False),
    (ServiceConfig, serving_section, True),
], ids=["Schedule", "ServiceConfig"])
def test_knob_tables_match_the_ports_classes(cls, text, every_default):
    """Field names both ways; each default the regex reads equal to the
    field's (schedule.md's `block_rows` row escapes a `|` in its type
    column, so that regex skips it there, as in tests/test_docs.py)."""
    names, rows = knob_rows(text())
    fields = {f.name: f.default for f in dataclasses.fields(cls)}
    assert names == set(fields), (
        f"undocumented={sorted(set(fields) - names)}, stale={sorted(names - set(fields))}")
    assert rows and (len(rows) == len(fields) or not every_default)
    for name, doc_default in rows:
        lead = doc_default.split()[0].strip('"')
        assert lead in (repr(fields[name]), str(fields[name])), (name, doc_default)


def test_analysis_code_table_matches_the_ports_registry():
    rows = re.findall(r"^\| `(SP\d+)` \| (error|warning) \|", read(DOCS / "analysis.md"),
                      re.MULTILINE)
    assert dict(rows) == {code: sev for code, (sev, _) in REGISTRY.items()}
