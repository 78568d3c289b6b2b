"""What the benchmark may import and read."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    """Top-level names of every module a file imports (relative imports
    stay inside the benchmark and are left out)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    for p in sources():
        bad = imported(p) & FORBIDDEN
        assert not bad, f"{p} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for p in sorted((BENCH / "reference").glob("*.py")):
        assert not imported(p) & (FORBIDDEN | {"repro_torch"}), p


def test_nothing_reads_the_old_benchmarks_folder():
    for p in sources():
        assert "benchmarks/" not in p.read_text() and "BENCH_" not in p.read_text(), p


def test_the_runtime_check_names_what_it_finds():
    import sys
    import types

    import repro_torch  # noqa: F401  (its name begins with the JAX package's)

    from portbench import harness
    before = set(harness.forbidden_modules())
    assert "repro" not in before
    sys.modules["repro.fake"] = types.ModuleType("repro.fake")
    try:
        assert set(harness.forbidden_modules()) - before == {"repro"}
    finally:
        del sys.modules["repro.fake"]
