"""Padded-tail edge cases of the port's 1-D distributed partition, and the
paths that must raise. Mirrors tests/test_dist_padding.py.

The last block is padded; with small N whole shards own nothing but
padding. End-to-end runs on 8 gloo ranks (one world, `spawn_world`) cover
N % P != 0, N < P, shards owning only padding and isolated vertices on the
dense and the frontier-compressed exchange, each against the numpy oracle
and the reference's runner (`_gather_elems` exactly). Unit cases seed the
padding of `exchange` with poison and check that it stays inert, that the
exchange skips when nothing changed and falls back to the dense gather on
overflow, and that `exchange_rows` / `gather_rows` place S > 1 lanes of
P > 1 shards where they belong. Without spawning: `pad_nodes` equals the
reference's, and the distributed path refuses every fallback — no group
started quietly, no gloo on a mesh on the card, no CPU run when the card is
missing, no collective error caught.
"""
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.graph import from_edges, pad_nodes as ref_pad_nodes, uniform_random
from repro.graph.algorithms_ref import bc_ref, sssp_ref
from repro_torch.core import Schedule, compile_bundled, dist, get_context
from repro_torch.core import runtime_dist as rtd
from repro_torch.graph import FIELDS, from_arrays, pad_nodes
from torch_dist_ref import assert_agree, assert_ranks_agree, graph_spec, ref_run
from torch_dist_worker import spawn_world

POLICIES = ["dense", "compact", "auto"]
P = 8
POISON = np.int32(-777777)


def _graphs():
    # vertices 7..9 of "isolated" have no edges at all; 0..6 form a weighted path
    return {
        "prime": uniform_random(101, 5, seed=2),        # 101 % 8 = 5
        "only_padding": uniform_random(9, 3, seed=5),   # block 2: shards 5..7 pad only
        "smaller": uniform_random(5, 2, seed=7),        # N=5 < P=8, block 1
        "isolated": from_edges(10, np.arange(6), np.arange(1, 7), np.arange(1, 7)),
    }


BC_SOURCES = np.array([0, 3, 7], np.int32)


# ---- exchange unit cases (stacked [P, block] blocks, one row per rank) ----

def _poison_case(frac, skip):
    """n_pad 32 with 5 poison slots in both the full view and the owning
    blocks; real changes on three different shards."""
    block, n_true = 4, 27
    n_pad = P * block
    full = np.random.default_rng(3).integers(0, 100, n_pad).astype(np.int32)
    full[n_true:] = POISON
    blk = full.reshape(P, block).copy()
    blk[0, 1], blk[3, 2], blk[6, 1] = 41, 42, 43
    return dict(frac=frac, skip=skip, per_rank=("blk", "own"),
                arrays=dict(full=full, blk=blk,
                            own=np.arange(n_pad, dtype=np.int32).reshape(P, block)))


def _unchanged_case():
    full = np.full(P * 4, POISON, np.int32)
    return dict(frac=0.25, skip=True, per_rank=("blk", "own"),
                arrays=dict(full=full, blk=full.reshape(P, 4),
                            own=np.arange(P * 4, dtype=np.int32).reshape(P, 4)))


def _overflow_case():
    n_pad = P * 8
    return dict(frac=0.25, skip=True, per_rank=("blk", "own"),
                arrays=dict(full=np.zeros(n_pad, np.int32),
                            blk=np.arange(1, n_pad + 1, dtype=np.int32).reshape(P, 8),
                            own=np.arange(n_pad, dtype=np.int32).reshape(P, 8)))


ROWS_S, ROWS_B = 3, 4


def _rows_case(changes):
    """[S, N_pad] lanes over 8 shards of 4 (float32, the padded tail
    poisoned); `changes` (lane, vertex) entries of the blocks change."""
    n_pad = P * ROWS_B
    full = np.random.default_rng(5).random((ROWS_S, n_pad)).astype(np.float32)
    full[:, 29:] = POISON
    new = full.copy()
    for lane, v in changes:
        new[lane, v] = -1.0 - lane
    blk = new.reshape(ROWS_S, P, ROWS_B).transpose(1, 0, 2).copy()   # [P, S, B]
    return new, dict(frac=0.25, skip=True, per_rank=("blk", "own"),
                     arrays=dict(full=full, blk=blk,
                                 own=np.arange(n_pad, dtype=np.int32).reshape(P, ROWS_B)))


ROWS_SPARSE = [(0, 1), (2, 13), (1, 26)]                  # fits the shared buffer
ROWS_DENSE = [(lane, v) for lane in range(ROWS_S) for v in range(0, 29, 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of the padding world (8 shards), spawned once."""
    graphs = {k: graph_spec(g) for k, g in _graphs().items()}
    cases = [(("sssp", k, pol), k, "sssp", dict(dist_frontier=pol), dict(src=0))
             for k in graphs for pol in POLICIES]
    cases += [(("bc", pol), "only_padding", "bc", dict(dist_frontier=pol),
               dict(sourceSet=BC_SOURCES)) for pol in POLICIES]
    exchanges = [(("poison", frac, skip), "exchange", _poison_case(frac, skip))
                 for frac, skip in ((0.25, True), (0.25, False), (1.0, True))]
    exchanges += [("unchanged", "exchange", _unchanged_case()),
                  ("overflow", "exchange", _overflow_case()),
                  ("rows_sparse", "exchange_rows", _rows_case(ROWS_SPARSE)[1]),
                  ("rows_dense", "exchange_rows", _rows_case(ROWS_DENSE)[1])]
    return spawn_world(P, {"programs": {"graphs": graphs, "cases": cases},
                           "exchanges": exchanges, "gathers": (ROWS_S, ROWS_B)},
                       tmp_path_factory.mktemp("dist"))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("graph", ["prime", "only_padding", "smaller", "isolated"])
def test_padded_sssp(graph, policy, world, eight_devices):
    g = _graphs()[graph]
    got = world[0]["programs"][("sssp", graph, policy)]
    ref = sssp_ref(g, 0).astype(np.int32)
    assert np.array_equal(got["dist"], ref)
    assert_agree(got, ref_run(g, "sssp", P, dict(dist_frontier=policy), dict(src=0)),
                 f"sssp/{graph}/{policy}")
    if graph == "isolated":
        assert (ref[7:] == ref[7]).all()                        # all INF


@pytest.mark.parametrize("policy", POLICIES)
def test_batched_bc_on_padded_tail(policy, world, eight_devices):
    """Batched source lanes ([S, B] blocks) across a padded tail."""
    g = _graphs()["only_padding"]
    got = world[0]["programs"][("bc", policy)]
    np.testing.assert_allclose(got["BC"], bc_ref(g, BC_SOURCES.tolist()), atol=1e-3)
    assert_agree(got, ref_run(g, "bc", P, dict(dist_frontier=policy),
                              dict(sourceSet=BC_SOURCES)), f"bc/{policy}")


def test_every_rank_returns_the_global_result(world):
    assert_ranks_agree(world)


@pytest.mark.parametrize("frac,skip", [(0.25, True), (0.25, False), (1.0, True)])
def test_exchange_never_reads_poisoned_padding(frac, skip, world):
    """Initialized-but-never-written padding never differs between block
    and full view, so the compact selection must not transmit it: the true
    slots are exact and every poison slot is bit-equal untouched."""
    case = _poison_case(frac, skip)
    want = case["arrays"]["blk"].reshape(-1)
    for res in world:
        full, elems = res["exchanges"][("poison", frac, skip)]
        assert np.array_equal(full[:27], want[:27])
        assert (full[27:] == POISON).all(), "padding was rewritten"
        assert elems > 0


def test_exchange_skips_when_nothing_changed(world):
    for res in world:
        full, elems = res["exchanges"]["unchanged"]
        assert elems == 0
        assert (full == POISON).all()


def test_exchange_dense_fallback_on_overflow(world):
    """A rank whose change count overflows the compact buffer sends every
    rank to the dense gather, which reports the dense element count."""
    for res in world:
        full, elems = res["exchanges"]["overflow"]
        assert elems == P * 8
        assert np.array_equal(full, np.arange(1, P * 8 + 1))


@pytest.mark.parametrize("case,changes", [("rows_sparse", ROWS_SPARSE),
                                          ("rows_dense", ROWS_DENSE)])
def test_exchange_rows_with_several_lanes(case, changes, world):
    """S = 3 lanes over 8 shards: the composite-id compact path (a shared
    buffer of 2*cap*P elements) and its dense fallback (`gather_rows`,
    S*N_pad elements) both land every lane's changes in its own row and
    leave the poisoned tail alone."""
    want, _ = _rows_case(changes)
    cap = rtd.compact_cap(ROWS_S * ROWS_B, 0.25)
    for res in world:
        full, elems = res["exchanges"][case]
        assert full.shape == (ROWS_S, P * ROWS_B)
        assert np.array_equal(full, want)
        assert elems == (2 * cap * P if case == "rows_sparse" else ROWS_S * P * ROWS_B)


def test_gather_rows_places_lanes_and_shards(world):
    """gather_rows of [S, B] blocks: row s of the result is lane s of every
    shard in shard order; a bool gather travels as bytes and comes back
    bool."""
    for res in world:
        rows, flags = res["gathers"]
        for r in range(P):
            blk = np.arange(ROWS_S * ROWS_B).reshape(ROWS_S, ROWS_B) * 100 + r
            assert np.array_equal(rows[:, r * ROWS_B:(r + 1) * ROWS_B], blk)
            assert np.array_equal(flags[r * ROWS_B:(r + 1) * ROWS_B],
                                  np.arange(ROWS_B) % (r + 2) == 0)
        assert flags.dtype == np.bool_


# --------------------------------------------------------------------------
# without spawning
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multiple", [1, 8, 16])
def test_pad_nodes_equals_the_reference(multiple):
    g = uniform_random(101, 5, seed=2)
    want = ref_pad_nodes(g, multiple)
    carried = from_arrays(graph_spec(g)["arrays"], num_nodes=g.num_nodes,
                          num_edges=g.num_edges, max_out_degree=int(g.max_out_degree),
                          max_in_degree=int(g.max_in_degree), device="cpu")
    got = pad_nodes(carried, multiple)
    assert got.num_nodes == want.num_nodes
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    ctx = get_context(carried)
    assert ctx.padded(multiple) is ctx.padded(multiple)          # a memoized view
    assert ctx.padded(multiple).num_nodes == want.num_nodes


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank in this process, destroyed after the test."""
    assert not tdist.is_initialized()
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


@pytest.fixture
def g_small():
    g = uniform_random(40, 3, seed=1)
    return from_arrays(graph_spec(g)["arrays"], num_nodes=g.num_nodes,
                       num_edges=g.num_edges, max_out_degree=int(g.max_out_degree),
                       max_in_degree=int(g.max_in_degree), device="cpu")


def test_make_mesh_never_starts_a_group():
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized default process group"):
        dist.make_mesh_1d(device="cpu")
    assert not tdist.is_initialized()


def test_mesh_checks_world_size_device_and_backend(one_rank_group, monkeypatch):
    mesh = dist.make_mesh_1d(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    with pytest.raises(ValueError, match="has 1 ranks"):
        dist.make_mesh_1d(2, device="cpu")
    if not torch.cuda.is_available():
        # no CPU run when the card is missing: the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.make_mesh_1d()
    # no gloo on a mesh on the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs its collectives on nccl"):
        dist.make_mesh_1d(device="cuda:0")
    # and no NCCL group serves a mesh on the CPU
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="runs its collectives on gloo"):
        dist.make_mesh_1d(device="cpu")


def test_one_rank_run_and_the_raising_entry_points(one_rank_group, g_small,
                                                    monkeypatch):
    """World size 1 in this process: bind(mesh=) runs and agrees with the
    local backend; mesh= on a local program and refresh of a distributed
    program raise; and a collective's own error reaches the caller
    unchanged."""
    mesh = dist.make_mesh_1d(device="cpu")
    prog = compile_bundled("sssp", backend="distributed")
    bound = prog.bind(g_small, mesh=mesh)
    local = compile_bundled("sssp").bind(g_small)(src=0)
    assert torch.equal(bound(src=0)["dist"], local["dist"])
    assert torch.equal(dist.run(prog, g_small, mesh, src=0)["dist"], local["dist"])
    with pytest.raises(ValueError, match="distributed backend only"):
        compile_bundled("sssp").bind(g_small, mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prog.bind(g_small)        # the default mesh is on the card
    with pytest.raises(ValueError, match="refresh is a local/cuda entry point"):
        bound.refresh({}, None, src=0)
    def broken(*args, **kwargs):
        raise RuntimeError("collective failed")
    monkeypatch.setattr(rtd, "_all_gather", broken)
    with pytest.raises(RuntimeError, match="collective failed"):
        bound(src=0)
    monkeypatch.undo()
    monkeypatch.setattr(tdist, "all_reduce", broken)
    with pytest.raises(RuntimeError, match="collective failed"):
        prog.recompile(Schedule(dist_frontier="auto")).bind(g_small, mesh=mesh)(src=0)


def test_hoisting_loop_invariant_gathers_changes_only_the_volume(one_rank_group, g_small,
                                                                 monkeypatch):
    """bc's reverse pass reads sigma and never writes it: hoisted, sigma is
    gathered once before the pass; with the hoist off (the ablation the
    reference's bench_analysis.py measures) it is gathered every level.
    The result is the same, the volume larger."""
    from repro_torch.core import compile_cache_clear
    from repro_torch.core.codegen import distributed
    mesh = dist.make_mesh_1d(device="cpu")
    srcs = np.array([0, 5, 9], np.int32)
    out = {}
    for hoist in (True, False):
        monkeypatch.setattr(distributed, "HOIST_INVARIANT", hoist)
        compile_cache_clear()        # the flag is not part of the compile key
        out[hoist] = compile_bundled("bc", backend="distributed").bind(
            g_small, mesh=mesh)(sourceSet=srcs)
    compile_cache_clear()
    torch.testing.assert_close(out[True]["BC"], out[False]["BC"])
    assert float(out[True]["_gather_elems"]) < float(out[False]["_gather_elems"])
