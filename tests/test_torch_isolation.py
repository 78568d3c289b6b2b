"""The port stands alone: nothing under src/repro_torch/, not
chip_smoke.py, not the port's examples (examples/torch_*.py), and not the
module the distributed tests run in their ranks (tests/torch_dist_worker.py),
imports jax or anything of the JAX package `repro`."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FILES = PORT + EXAMPLES + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_the_walk_sees_the_package():
    names = {p.name for p in FILES}
    assert {"csr.py", "ops.py", "kernel.py", "api.py", "transformer.py", "engine.py",
            "chip_smoke.py", "dist.py", "runtime_dist.py", "distributed.py",
            "torch_dist_worker.py", "io.py", "cli.py", "__main__.py", "analyze.py",
            "roofline.py", "hlo_cost.py", "dryrun.py", "report.py",
            "algorithms_ref.py"} <= names
    assert {p.name for p in EXAMPLES} == {
        f"torch_{n}.py" for n in ("quickstart", "graph_analytics", "query_server",
                                  "serve_lm", "train_lm")}
    assert all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_relative_imports_stay_inside_the_port():
    """A relative import can only climb to src/repro_torch/ itself."""
    pkg = ROOT / "src" / "repro_torch"
    for path in PORT:
        depth = len(path.relative_to(pkg).parts) - 1
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level - 1 <= depth, (path, node.level)
