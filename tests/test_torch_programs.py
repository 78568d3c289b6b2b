"""The bundled programs beyond the first slice — `bc`, `ppr` (the batched
source-set engine), `tc` (the wedge count), `cc`, `lp` and `kcore` —
compiled by the port on both torch backends against the reference's
`local` and `pallas` results on the same graphs. Mirrors
tests/test_backends_agree.py and tests/test_cc.py: int outputs equal, PPR
at rtol 1e-4 / atol 1e-5, BC at rtol 1e-4 / atol 1e-4 with its nan
positions compared, not its values (sigma overflows float32 on deep
graphs in both reference backends)."""
import re

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro_torch.schedule import Schedule


def carry(g):
    return tg.from_arrays({f: np.asarray(getattr(g, f)) for f in tg.FIELDS},
                          num_nodes=g.num_nodes, num_edges=g.num_edges,
                          max_out_degree=g.max_out_degree,
                          max_in_degree=g.max_in_degree, device="cpu")


def diamond_ladder(k):
    """a_i → b_i, c_i → a_{i+1}: 2^i shortest paths reach a_i, so BC's
    float32 sigma overflows past k = 128 and its ratios turn nan."""
    a = 3 * np.arange(k + 1)
    src = np.concatenate([a[:-1], a[:-1], a[:-1] + 1, a[:-1] + 2])
    dst = np.concatenate([a[:-1] + 1, a[:-1] + 2, a[1:], a[1:]])
    return rg.from_edges(3 * k + 1, src, dst, np.ones(len(src), np.int64))


@pytest.fixture(scope="module")
def graphs(graph_suite):
    out = dict(graph_suite)
    out["powerlaw"] = rg.preferential_attachment(600, m=6, seed=11)
    src = np.array([0, 1, 2, 8, 9, 10])
    dst = np.array([1, 2, 3, 9, 10, 11])
    out["disconnected"] = rg.from_edges(16, src, dst, np.ones(6, np.int64),
                                        undirected=True)
    out["path"] = rg.from_edges(40, np.arange(39), np.arange(1, 40),
                                np.ones(39, np.int64), undirected=True)
    out["ladder"] = diamond_ladder(140)
    return {k: (g, carry(g)) for k, g in out.items()}


GRAPHS = ["UR", "RD", "SW", "powerlaw", "disconnected"]


def sources(g, count=5):
    return np.arange(0, g.num_nodes, max(g.num_nodes // count, 1), np.int32)[:count]


def params_for(name, g, srcs=None):
    if name == "bc":
        return dict(sourceSet=sources(g) if srcs is None else srcs)
    if name == "ppr":
        return dict(beta=1e-4, delta=0.85, maxIter=60,
                    sourceSet=sources(g) if srcs is None else srcs)
    if name.startswith("kcore"):
        return dict(k=int(name[-1]))
    return {}


def assert_agree(want, got, what):
    assert set(want) == set(got), what
    for key in want:
        a, b = np.asarray(want[key]), got[key].cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}.{key}"
        if a.dtype.kind != "f":
            assert np.array_equal(a, b), f"{what}.{key}"
        elif key == "BC":
            assert np.array_equal(np.isnan(a), np.isnan(b)), f"{what}.{key} nan positions"
            ok = ~np.isnan(a)
            np.testing.assert_allclose(b[ok], a[ok], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}.{key}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=f"{what}.{key}")


def run_all(name, gname, graphs, schedule_kw, params):
    """The reference's `local` and `pallas` against the port's `local` and
    `cuda`, under the same schedule."""
    g, tgr = graphs[gname]
    prog = name.split("-")[0]
    ref = {b: rc.compile_bundled(prog, backend=b, schedule=rc.Schedule(**schedule_kw))(
        g, **params) for b in ("local", "pallas")}
    got = {b: tc.compile_bundled(prog, backend=b, schedule=Schedule(**schedule_kw)).bind(
        tgr)(**params) for b in ("local", "cuda")}
    for tb, out in got.items():
        for rb, want in ref.items():
            assert_agree(want, out, f"{name}[{gname}] torch {tb} vs jax {rb}")
    return ref, got


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("batch_sources", [0, 1, 32])
@pytest.mark.parametrize("name", ["bc", "ppr"])
def test_source_set_programs_match_reference(name, batch_sources, gname, graphs):
    run_all(name, gname, graphs, dict(batch_sources=batch_sources),
            params_for(name, graphs[gname][0]))


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("name", ["tc", "cc", "lp", "kcore-1", "kcore-2", "kcore-3"])
def test_programs_match_reference(name, gname, graphs):
    # kcore: k=2 leaves a nontrivial survivor set on UR, k=3 cascades to
    # empty, k=1 peels only sinks
    run_all(name, gname, graphs, {}, params_for(name, graphs[gname][0]))


@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("batch_sources", [1, 32])
def test_bc_pinned_direction_matches_reference(direction, batch_sources, graphs):
    run_all("bc", "powerlaw", graphs,
            dict(batch_sources=batch_sources, direction=direction),
            params_for("bc", graphs["powerlaw"][0]))


@pytest.mark.parametrize("name", ["bc", "ppr"])
@pytest.mark.parametrize("batch_sources,count", [(4, 5), (32, 37)])
def test_partial_final_chunk(name, batch_sources, count, graphs):
    """A source set that B does not divide: the last chunk is padded with
    the last source and masked out of the shared sums, so the batched run
    equals the sequential one."""
    g, tgr = graphs["UR"]
    srcs = np.random.default_rng(count).permutation(g.num_nodes)[:count].astype(np.int32)
    params = params_for(name, g, srcs)
    _, got = run_all(name, "UR", graphs, dict(batch_sources=batch_sources), params)
    bat = tc.compile_bundled(name, backend="local",
                             schedule=Schedule(batch_sources=batch_sources))
    assert "rt.bfs_levels_batch" in bat.source or "_bdw" in bat.source
    seq = tc.compile_bundled(name, backend="local", schedule=Schedule(batch_sources=1))
    assert_agree({k: v.numpy() for k, v in seq.bind(tgr)(**params).items()},
                 got["local"], f"{name} batched vs sequential")


@pytest.mark.parametrize("backend", ["local", "cuda"])
@pytest.mark.parametrize("name", ["bc", "ppr"])
@pytest.mark.parametrize("srcs", [[], [7], [3, 3, 3]], ids=["empty", "one", "repeated"])
def test_degenerate_source_sets(srcs, name, backend, graphs):
    """Empty, singleton and repeated source sets: the chunked batched loop
    (padding lanes, the empty-set guard) matches the sequential lowering
    and the reference."""
    g, tgr = graphs["path"]
    params = params_for(name, g, np.array(srcs, np.int32))
    want = rc.compile_bundled(name, backend="local", schedule=rc.Schedule(batch_sources=4))(
        g, **params)
    for bs in (4, 1):
        out = tc.compile_bundled(name, backend=backend,
                                 schedule=Schedule(batch_sources=bs)).bind(tgr)(**params)
        assert_agree(want, out, f"{name} {srcs} batch_sources={bs}")
    if not srcs:
        assert not out[next(iter(out))].any()


@pytest.mark.parametrize("batch_sources", [1, 32])
def test_bc_nan_positions_match_reference(batch_sources, graphs):
    """BC's float32 sigma overflows on the 140-diamond ladder: the port
    puts its nans where the reference does, batched and sequential."""
    g, _ = graphs["ladder"]
    params = dict(sourceSet=np.array([0, 3, 150], np.int32))
    ref, _ = run_all("bc", "ladder", graphs, dict(batch_sources=batch_sources), params)
    bc = np.asarray(ref["local"]["BC"])
    assert np.isnan(bc).any() and np.isfinite(bc).any()


@pytest.mark.parametrize("kind", ["list", "numpy", "tensor"])
def test_source_set_argument_moves_to_the_graph_device(kind, graphs):
    g, tgr = graphs["UR"]
    srcs = [0, 7, 23]
    arg = {"list": srcs, "numpy": np.array(srcs, np.int64),
           "tensor": torch.tensor(srcs, dtype=torch.int64)}[kind]
    out = tc.compile_bundled("bc", backend="local").bind(tgr)(sourceSet=arg)
    want = rc.compile_bundled("bc", backend="local")(g, sourceSet=np.array(srcs, np.int32))
    assert_agree(want, out, f"bc with a {kind} source set")


KOPS = re.compile(r"kops\.(\w+)\(")
LITERALS = re.compile(r"(threshold_frac|direction|block_rows)=([^,)]+|\{[^}]*\})|max\(min\((\d+),")


@pytest.mark.parametrize("batch_sources", [0, 1, 32])
@pytest.mark.parametrize("name", rc.bundled_programs())
def test_generated_source_mirrors_reference(name, batch_sources):
    """Every bundled program compiles on both torch backends; the port's
    `cuda` source calls the kernel ops exactly where the reference's
    `pallas` source does, and bakes in the same Schedule literals."""
    assert tc.bundled_programs() == rc.bundled_programs()
    ref = rc.compile_bundled(name, backend="pallas",
                             schedule=rc.Schedule(batch_sources=batch_sources)).source
    # the reference's `__refresh` variant is not ported yet (ROADMAP item 8)
    ref = re.split(r"\n(?=def \w+__refresh\()", ref)[0]
    sched = Schedule(batch_sources=batch_sources)
    src = tc.compile_bundled(name, backend="cuda", schedule=sched).source
    local = tc.compile_bundled(name, backend="local", schedule=sched).source
    assert KOPS.findall(src) == KOPS.findall(ref), name
    assert LITERALS.findall(src) == LITERALS.findall(ref), name
    assert "kops" not in local and "jax" not in src + local
    if name == "ppr":
        assert KOPS.findall(src) == (["gather_plustimes"] if batch_sources <= 1 else [])
    if name == "bc":
        assert KOPS.findall(src) == []
