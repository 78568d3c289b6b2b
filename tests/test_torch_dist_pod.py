"""The port's pod-parallel runner (`dist.run_pod_parallel`) against the
reference's: bc over a source set split across the "pod" axis of a
("pod", "data") mesh, every pod running the 1-D body over its "data"
axis. Mirrors tests/test_distributed.py::test_bc_pod_parallel.

Each mesh runs in a world of pods·data gloo ranks
(`torch_dist_worker.spawn_world`). At N = 100 every "data" axis of these
meshes divides N, so the reference's `run_pod_parallel` runs (it trims a
padded sharded output with `out[:N]`, which raises under jax 0.9): BC
within 1e-3 and `_gather_elems` exactly equal. At N = 101 the blocks are
padded and the port is held against `bc_ref`.
"""
import jax
import numpy as np
import pytest

from repro.core import compile_bundled as ref_compile
from repro.core import dist as ref_dist
from repro.graph import uniform_random
from repro.graph.algorithms_ref import bc_ref
from torch_dist_ref import graph_spec
from torch_dist_worker import spawn_world

SRCS4 = np.array([0, 7, 23, 41], np.int32)
SRCS8 = np.array([0, 7, 23, 41, 55, 62, 80, 99], np.int32)
# (pods, data) -> the source set it splits
MESHES = {(2, 4): SRCS4, (4, 2): SRCS8, (8, 1): SRCS8, (2, 2): SRCS4}


@pytest.fixture(scope="module")
def graphs(eight_devices):
    return {"g100": uniform_random(100, 5, seed=2), "g101": uniform_random(101, 5, seed=2)}


def _cases(world):
    cases = []
    for shape, srcs in MESHES.items():
        if shape[0] * shape[1] == world:
            cases += [(("g100", shape), "g100", shape, srcs),
                      (("g101", shape), "g101", shape, srcs)]
    if world == 4:   # 3 sources over 2 pods
        cases.append((("odd", (2, 2)), "g100", (2, 2), SRCS4[:3]))
    return cases


_WORLDS = {}


@pytest.fixture(scope="module")
def world(graphs, tmp_path_factory):
    def get(size):
        if size not in _WORLDS:
            payload = {"pods": {"graphs": {k: graph_spec(g) for k, g in graphs.items()},
                                "cases": _cases(size)}}
            try:
                _WORLDS[size] = spawn_world(size, payload, tmp_path_factory.mktemp("pods"))
            except AssertionError as e:
                _WORLDS[size] = e
        res = _WORLDS[size]
        if isinstance(res, AssertionError):
            raise res
        return res
    return get


def _got(world, gname, shape):
    return world(shape[0] * shape[1])[0]["pods"][(gname, shape)]


@pytest.mark.parametrize("shape", list(MESHES))
def test_pod_bc_equals_the_reference(shape, graphs, world):
    mesh = jax.make_mesh(shape, ("pod", "data"), devices=jax.devices()[:shape[0] * shape[1]])
    want = ref_dist.run_pod_parallel(ref_compile("bc", backend="distributed"),
                                     graphs["g100"], mesh, MESHES[shape])
    got = _got(world, "g100", shape)
    assert got["BC"].shape == (100,) and got["BC"].dtype == np.float32
    np.testing.assert_allclose(got["BC"], np.asarray(want["BC"]), rtol=0, atol=1e-3)
    assert float(got["_gather_elems"]) == float(want["_gather_elems"])


@pytest.mark.parametrize("shape", list(MESHES))
def test_pod_bc_on_padded_blocks_agrees_with_the_oracle(shape, graphs, world):
    got = _got(world, "g101", shape)
    assert got["BC"].shape == (101,)
    np.testing.assert_allclose(got["BC"], bc_ref(graphs["g101"], MESHES[shape].tolist()),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("gname", ["g100", "g101"])
@pytest.mark.parametrize("shape", list(MESHES))
def test_gather_elems_is_the_sum_over_pods(shape, gname, world):
    """The pods' counts are summed, not one pod's taken: `_gather_elems`
    equals the sum of each pod's slice run alone over the "data" axis."""
    got = _got(world, gname, shape)
    assert len(got["per_pod_elems"]) == shape[0]
    assert float(got["_gather_elems"]) == sum(got["per_pod_elems"])


def test_a_set_that_does_not_divide_the_pods_raises(world):
    assert "must divide the pod count" in world(4)[0]["pods"][("odd", (2, 2))]


@pytest.mark.parametrize("size", [8, 4])
def test_every_rank_returns_the_global_result(size, world):
    res = world(size)
    for rank_res in res[1:]:
        for cid, out in res[0]["pods"].items():
            if cid[0] == "odd":
                assert rank_res["pods"][cid] == out
                continue
            for k, v in out.items():
                assert np.array_equal(np.asarray(rank_res["pods"][cid][k]), np.asarray(v)), \
                    (cid, k)
