"""The port's distributed backend against the reference's, across shard
counts {1, 2, 4, 8}: the port runs in one gloo process per shard
(`torch_dist_worker.spawn_world`, one world per shard count, every rank
running every case), the reference on the forced host devices the shared
conftest sets up, through its untrimmed runner (`torch_dist_ref`).
Mirrors tests/test_dist_agree.py.

N is prime (101), so no shard count > 1 divides it: every world runs the
padded last block. Outputs agree as `torch_dist_ref.assert_agree` says
(integers equal, floats at rtol 1e-4 / atol 1e-4, nan positions equal),
and `_gather_elems`, the elements the exchange collectives moved, is
exactly the reference's: it tells which regime (skip / compact / dense)
every superstep took.
"""
import numpy as np
import pytest

from repro.graph import road, uniform_random
from repro.graph.algorithms_ref import sssp_ref
from repro_torch.core import Schedule, compile_bundled, get_context
from repro_torch.core import runtime_dist as rtd
from repro_torch.graph import block_partition_1d, from_arrays
from torch_dist_ref import assert_agree, assert_ranks_agree, graph_spec, ref_run
from torch_dist_worker import spawn_world

PROGRAMS = ["sssp", "sssp_pull", "pr", "tc", "bc", "cc", "ppr", "lp", "kcore"]
SHARDS = [1, 2, 4, 8]

# compressed exchange + adaptive direction: every knob on at once
DIST_SCHED = dict(dist_frontier="auto", direction="auto")
# the dense baseline and plain compact, per policy, at two shard counts
POLICY_CASES = [(name, pol, shards) for name in ("sssp", "bc", "pr")
                for pol in ("dense", "compact") for shards in (2, 8)]
DELTA_SHARDS = 4


def _params(name):
    if name in ("sssp", "sssp_pull"):
        return dict(src=0)
    if name == "pr":
        return dict(beta=1e-4, delta=0.85, maxIter=60)
    if name == "bc":
        return dict(sourceSet=np.array([0, 7, 23], np.int32))
    if name == "ppr":
        return dict(beta=1e-4, delta=0.85, maxIter=60,
                    sourceSet=np.array([0, 7, 23], np.int32))
    if name == "kcore":
        return dict(k=2)
    return {}


def _delta_sched(frontier):
    return dict(priority="delta", delta_bucket=150, dist_frontier=frontier,
                direction="auto")


# the priority-sliced exchange: 8 shards of 16, 4 changed per shard, 2 of
# them inside the window
WITHIN_P, WITHIN_B = 8, 16


def _within_case():
    n_pad = WITHIN_P * WITHIN_B
    idx = np.arange(n_pad)
    changed = idx % WITHIN_B < 4
    window = idx % WITHIN_B < 2
    blk = np.where(changed, 50, 100).astype(np.int32)
    return changed, window, dict(
        frac=0.25, skip=False, per_rank=("blk", "own", "within"),
        arrays=dict(full=np.full(n_pad, 100, np.int32),
                    blk=blk.reshape(WITHIN_P, WITHIN_B),
                    own=idx.astype(np.int32).reshape(WITHIN_P, WITHIN_B),
                    within=window.reshape(WITHIN_P, WITHIN_B)))


@pytest.fixture(scope="module")
def g_prime(eight_devices):
    return uniform_random(101, 5, seed=2)


@pytest.fixture(scope="module")
def g_road():
    return road(16, seed=7)


_WORLDS = {}


@pytest.fixture(scope="module")
def world(g_prime, g_road, tmp_path_factory):
    """`world(shards)`: every rank's results of that shard count's cases,
    spawned once per module (a failed world fails each of its tests with
    the same error, without a second spawn)."""
    def get(shards):
        if shards not in _WORLDS:
            cases = [(("matrix", n), "prime", n, DIST_SCHED, _params(n)) for n in PROGRAMS]
            cases += [(("policy", n, pol), "prime", n, dict(dist_frontier=pol), _params(n))
                      for n, pol, s in POLICY_CASES if s == shards]
            if shards == DELTA_SHARDS:
                cases += [(("delta", f), "road", "sssp", _delta_sched(f), dict(src=0))
                          for f in ("dense", "auto")]
            payload = {"programs": {"graphs": {"prime": graph_spec(g_prime),
                                               "road": graph_spec(g_road)},
                                    "cases": cases}}
            if shards == WITHIN_P:
                payload["exchanges"] = [("within", "exchange", _within_case()[2])]
            try:
                _WORLDS[shards] = spawn_world(shards, payload,
                                              tmp_path_factory.mktemp("dist"))
            except AssertionError as e:
                _WORLDS[shards] = e
        res = _WORLDS[shards]
        if isinstance(res, AssertionError):
            raise res
        return res
    return get


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_distributed_agrees_with_reference(name, shards, g_prime, world):
    got = world(shards)[0]["programs"][("matrix", name)]
    want = ref_run(g_prime, name, shards, DIST_SCHED, _params(name))
    assert_agree(got, want, f"{name} @ {shards} shards")


@pytest.mark.parametrize("name,policy,shards", POLICY_CASES)
def test_policy_agrees_with_reference(name, policy, shards, g_prime, world):
    got = world(shards)[0]["programs"][("policy", name, policy)]
    want = ref_run(g_prime, name, shards, dict(dist_frontier=policy), _params(name))
    assert_agree(got, want, f"{name}/{policy} @ {shards} shards")


@pytest.mark.parametrize("shards", SHARDS)
def test_every_rank_returns_the_global_result(shards, world):
    assert_ranks_agree(world(shards))


@pytest.mark.parametrize("frontier", ["dense", "auto"])
def test_delta_priority_on_weighted_grid(frontier, g_road, world):
    """Delta-stepping distributed: the bucketed frontier plus the
    priority-sliced exchange agree with the reference (its `_gather_elems`
    included) and with the monotonic oracle on the weighted grid."""
    got = world(DELTA_SHARDS)[0]["programs"][("delta", frontier)]
    assert np.array_equal(got["dist"], sssp_ref(g_road, 0).astype(np.int32))
    assert_agree(got, ref_run(g_road, "sssp", DELTA_SHARDS, _delta_sched(frontier),
                              dict(src=0)), f"delta/{frontier}")
    src = compile_bundled("sssp", backend="distributed",
                          schedule=Schedule(**_delta_sched(frontier))).source
    # the bucket advance is collective on every policy; the exchange is
    # priority-sliced only on the compressed path
    assert "rtd.min_global" in src
    assert ("within=" in src) == (frontier == "auto"), frontier


def test_exchange_within_ships_only_window_entries(world):
    """Changed entries inside `within` ship; changed entries outside are
    withheld; the pair buffer costs exactly 2*cap*P elements."""
    changed, window, _ = _within_case()
    for full, elems in (res["exchanges"]["within"] for res in world(WITHIN_P)):
        assert (full[window] == 50).all()
        assert (full[changed & ~window] == 100).all()
        assert (full[~changed] == 100).all()
        cap = rtd.compact_cap(WITHIN_B, 0.25)
        assert 2 * cap * WITHIN_P < WITHIN_P * WITHIN_B, "must stay compact"
        assert elems == 2 * cap * WITHIN_P


def test_comm_volume_counter_monotone_in_policy(world):
    """The compressed policies never move MORE elements than the dense
    baseline, and the empty-skip ("auto") never more than plain compact."""
    out = world(8)[0]["programs"]
    elems = {pol: int(out[("policy", "sssp", pol)]["_gather_elems"])
             for pol in ("dense", "compact")}
    elems["auto"] = int(out[("matrix", "sssp")]["_gather_elems"])
    assert elems["auto"] <= elems["compact"] <= elems["dense"]
    assert elems["auto"] < elems["dense"], elems


# --------------------------------------------------------------------------
# without spawning: the partition, the prepared arrays, the codegen
# --------------------------------------------------------------------------

def _carry(g):
    return from_arrays(graph_spec(g)["arrays"], num_nodes=g.num_nodes,
                       num_edges=g.num_edges, max_out_degree=int(g.max_out_degree),
                       max_in_degree=int(g.max_in_degree), device="cpu")


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_block_partition_equals_the_reference(shards, g_prime):
    from repro.graph.partition import block_partition_1d as ref_partition
    got, want = block_partition_1d(_carry(g_prime), shards), ref_partition(g_prime, shards)
    for f in ("src", "dst", "weight", "valid", "num_devices", "block", "num_nodes_padded"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("shards,ell", [(1, False), (8, False), (8, True)])
def test_prepared_arrays_equal_the_reference(shards, ell, g_prime):
    from repro.core.runtime_dist import prepare_graph_1d as ref_prepare
    got = rtd.prepare_graph_1d(_carry(g_prime), shards, ell=ell)
    want = ref_prepare(g_prime, shards, ell=ell)
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(w)), k


def test_context_owns_per_rank_partition_views(g_prime):
    """One graph serves every shard count through its GraphContext: each
    rank's arrays are memoized per (shard count, rank, device), and a rank
    holds only its own row, cut to its real edges."""
    g = _carry(g_prime)
    ctx = get_context(g)
    src, dst = g_prime.edge_src, g_prime.indices
    for shards in SHARDS:
        block = -(-101 // shards)
        for rank in range(shards):
            gd = ctx.dist_arrays(shards, rank=rank, device="cpu")
            assert gd["own_ids"].shape == (block,)
            assert int(gd["own_ids"][0]) == rank * block
            for valid, ids, keys in (("evalid", src, rtd._EDGE_KEYS["evalid"]),
                                     ("ivalid", dst, rtd._EDGE_KEYS["ivalid"])):
                real = int(np.sum(np.asarray(ids) // block == rank))
                assert bool(gd[valid].all())
                assert {tuple(gd[k].shape) for k in keys} == {(real,)}
    keys = {(k[1], k[3]) for k in ctx.view_keys() if k[0] == "dist_1d"}
    assert keys == {(s, r) for s in SHARDS for r in range(s)}
    before = len(ctx.view_keys())
    assert ctx.dist_arrays(4, rank=2, device="cpu") is ctx.dist_arrays(4, rank=2, device="cpu")
    assert len(ctx.view_keys()) == before


@pytest.mark.parametrize("name", PROGRAMS)
def test_every_bundled_program_compiles(name):
    prog = compile_bundled(name, backend="distributed")
    assert prog.dist_meta["needs_ell"] == (name == "tc")
    assert "jax" not in prog.source and "rtd." in prog.source
