"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the checkout. They run on the CPU at small sizes; the tests marked
`gpu` need a CUDA card and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(spec: dict, scale: int = 8) -> dict:
    """A cell's spec cut to a graph of 2**scale vertices, for the CPU."""
    spec["config"]["scale"] = scale
    return spec
