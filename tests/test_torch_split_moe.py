"""The MoE family on the split plan (`SplitPlan.moe_weights`,
`models.moe.moe_ffn` under a plan), the qk-norm scales of a split step,
and `gather_many` over leaves of two dtypes, on gloo ranks, against one
process's unsplit computation and the JAX package's.

One world of 2 ranks and one of 4 (`torch_dist_worker.spawn_world`, each
spawned once with every case) run smoke configs at 2 layers in f32 from
the reference's weights (`models.weights.from_reference`), placed by
`launch.sharding` with `Layout.gather_params` made to raise:

  * train: deepseek-moe-16b (8 experts, a shared expert) and
    qwen3-moe-235b-a22b (8 experts, GQA, qk-norm) on (1, 2), (2, 2) and
    (1, 4), and chameleon-34b (dense, qk-norm) on (1, 2) and (1, 4): two
    steps, losses and grad norms at RTOL of one process's unsplit steps,
    each leaf's change within CHANGE_RTOL of the unsplit change, the
    leaves "model" does not split equal on every rank of a "data" block,
    the specs' bytes held, the first step's loss and grad norm at rel 1e-4
    of the reference's one-device step. A rank routes its own rows with
    their own capacity (ROADMAP §3, deliberate differences), so the
    unsplit run of a mesh with d "data" ranks takes d times its
    microbatches: each microbatch then routes the same rows as one rank's;
  * the guard: qwen3-moe at 6 experts on (1, 4), where "model" does not
    divide E: the experts computed whole, no collective over "model" in
    the MoE layers;
  * drops at `moe_capacity_factor` 0.25: on (1, 4) every rank routes,
    keeps and drops exactly as the unsplit run does; on (2, 1) each rank's
    MoE output is the reference's `moe_ffn` of its rows apart, not of all
    rows together (the recorded difference);
  * the split prefill's last-token logits, 6 split decode steps and
    `ServeEngine.generate` against the unsplit port and the reference;
  * `gather_many` of a bf16 and an f32 leaf: each comes back, with its
    gradient, in its own dtype.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro.serve import ServeEngine as RefServeEngine
from repro.train import OptimizerConfig as RefOC
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train.data import DataConfig as RefDC
from repro.train.data import batch_at as ref_batch_at
from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as lt
from repro_torch.models import build
from repro_torch.models import moe as moe_mod
from repro_torch.models.weights import from_reference
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from torch_dist_worker import SPLIT_CASE_SHAPES, spawn_world, split_case_arrays

DEEPSEEK, QWEN3, CHAMELEON = "deepseek-moe-16b", "qwen3-moe-235b-a22b", "chameleon-34b"
STEPS, MICROBATCHES, SEQ, BATCH = 2, 2, 16, 8
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SEED = 7
RTOL = 1e-5
CHANGE_RTOL = 1e-2          # tests/test_torch_parallel.py's measure of a leaf's change
ATOL = 1e-4                 # f32 logits against the reference (tests/test_torch_lm.py)
DROPS = {"moe_capacity_factor": 0.25}
GUARD = {"n_experts": 6}
# (case id, arch, config overrides, mesh spec)
TRAIN = [(f"{arch}@{spec}", arch, {}, spec) for arch in (DEEPSEEK, QWEN3)
         for spec in ("1,2", "2,2", "1,4")]
QK_NORM = [(f"{CHAMELEON}@{spec}", CHAMELEON, {}, spec) for spec in ("1,2", "1,4")]
STEP_CASES = TRAIN + QK_NORM + [("guard@1,4", QWEN3, GUARD, "1,4")]
LAYER_CASES = [("drops@1,4", DEEPSEEK, DROPS, "1,4"), ("drops@2,1", DEEPSEEK, DROPS, "2,1")]
BATCH_DEC, MAX_LEN, DECODE_STEPS = 4, 16, 6
PROMPT, NEW_TOKENS, ENGINE_LEN = 4, 6, 32
DECODE_CASES = [(f"{arch}@{spec}", arch, spec) for arch, spec in
                ((DEEPSEEK, "1,2"), (DEEPSEEK, "1,4"), (QWEN3, "1,4"), (QWEN3, "2,2"))]
ENGINE_CASES = [(f"engine {arch}@{spec}", arch, spec) for arch, spec in
                ((DEEPSEEK, "1,4"), (QWEN3, "2,2"))]


def cfg_of(arch, overrides=(), package=configs):
    return dataclasses.replace(package.ARCHS[arch].smoke(), n_layers=2, dtype="float32",
                               **dict(overrides))


def world_of(spec):
    return math.prod(int(x) for x in spec.split(","))


def dims(spec):
    return dict(zip(("data", "model"), map(int, spec.split(","))))


def key(arch, overrides):
    return arch, tuple(sorted(overrides.items()))


def tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """key(arch, overrides) → (the reference's model, its params, them as numpy)."""
    out = {}
    for _, arch, over, _ in STEP_CASES + LAYER_CASES:
        if key(arch, over) not in out:
            ref = ref_build(cfg_of(arch, over, ref_configs))
            params = ref.init(jax.random.PRNGKey(0))
            out[key(arch, over)] = (ref, params, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world size → every rank's results."""
    out = {}
    for world in (2, 4):
        moe = [dict(id=cid, kind="steps" if (cid, arch, over, spec) in STEP_CASES else "layer",
                    arch=arch, overrides=over, arrays=weights[key(arch, over)][2], spec=spec,
                    steps=STEPS, microbatches=MICROBATCHES, seq=SEQ, global_batch=BATCH)
               for cid, arch, over, spec in STEP_CASES + LAYER_CASES if world_of(spec) == world]
        dec = [(cid, arch, {}, weights[key(arch, {})][2], spec,
                tokens((BATCH_DEC, DECODE_STEPS), 1), MAX_LEN, None)
               for cid, arch, spec in DECODE_CASES if world_of(spec) == world]
        dec += [(cid, arch, {}, weights[key(arch, {})][2], spec,
                 tokens((BATCH_DEC, PROMPT), 2), ENGINE_LEN, NEW_TOKENS)
                for cid, arch, spec in ENGINE_CASES if world_of(spec) == world]
        payload = {"split_decode": dec, "split_moe": moe, "gather_dtypes": [("g", SEED)]}
        out[world] = spawn_world(world, payload, tmp_path_factory.mktemp("moe"), timeout=300)
    return out


def ranks_of(worlds, spec, cid, job="split_moe"):
    return [res[job][cid] for res in worlds[world_of(spec)]]


def blocks(d, rows):
    """The d row blocks of a batch of `rows` rows, as the "data" ranks hold them."""
    return [slice(i * rows // d, (i + 1) * rows // d) for i in range(d)]


@pytest.fixture(scope="module")
def unsplit(weights):
    """(key, d) → one process's unsplit run standing for a mesh of d "data"
    ranks: the prefill's last-token logits of each rank's rows of step 0's
    batch (each block routed apart) and STEPS steps of d · MICROBATCHES
    microbatches (each routes one rank's microbatch); the parameters
    before and after."""
    out = {}
    for _, arch, over, spec in STEP_CASES:
        d = dims(spec)["data"]
        if (key(arch, over), d) in out:
            continue
        cfg = cfg_of(arch, over)
        model = from_reference(weights[key(arch, over)][2], cfg, device="cpu")
        before = {n: p.detach().numpy().copy() for n, p in model.net.named_parameters()}
        dc = lt.data_config(cfg, SEQ, BATCH)
        batch = lt.batch_for(cfg, dc, 0, "cpu")
        with torch.no_grad():
            prefill = np.concatenate([
                model({k: v[rows] for k, v in batch.items()}, impl="chunked",
                      last_only=True)[0].numpy() for rows in blocks(d, BATCH)])
        state = init_state(model)
        step = make_train_step(model, OptimizerConfig(**OC), microbatches=d * MICROBATCHES)
        hist = []
        for i in range(STEPS):
            state, met = step(state, lt.batch_for(cfg, dc, i, "cpu"))
            hist.append({k: float(met[k]) for k in ("loss", "grad_norm", "lr")})
        out[key(arch, over), d] = dict(
            prefill=prefill, history=hist, before=before,
            params={n: p.detach().numpy() for n, p in state.params.items()})
    return out


def unsplit_of(unsplit, case):
    _, arch, over, spec = case
    return unsplit[key(arch, over), dims(spec)["data"]]


@pytest.fixture(scope="module")
def reference_step(weights):
    """(arch, microbatches) → the reference's one-device first step (loss,
    grad norm)."""
    out = {}
    for _, arch, _, spec in TRAIN:
        mb = dims(spec)["data"] * MICROBATCHES
        if (arch, mb) in out:
            continue
        ref, params, _ = weights[key(arch, {})]
        rstate = dataclasses.replace(ref_init_state(ref, jax.random.PRNGKey(0)), params=params)
        step = jax.jit(ref_make_train_step(ref, RefOC(**OC), microbatches=mb))
        rbatch = ref_batch_at(RefDC(vocab=ref.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                    structure=8), 0)          # launch.train.data_config
        _, met = step(rstate, rbatch)
        out[arch, mb] = {k: float(met[k]) for k in ("loss", "grad_norm")}
    return out


def expected_held_bytes(cfg, mesh_shape):
    """The specs' arithmetic: every parameter's bytes, m's and v's (f32),
    divided by the ranks that split it."""
    params = dict(build(cfg, device="meta").net.named_parameters())
    specs = sh.param_specs(params, mesh_shape)
    return sum(p.numel() // math.prod(sh._axis_size(e, mesh_shape) for e in specs[n])
               * (p.element_size() + 8) for n, p in params.items())


# --------------------------------------------------------------------------
# the split train step
# --------------------------------------------------------------------------

def leaf_apart(got, want, n):
    moved, should = got[n] - want["before"][n], want["params"][n] - want["before"][n]
    assert np.linalg.norm(should) > 0, n
    return np.linalg.norm(moved - should) / np.linalg.norm(should)


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_split_moe_step_equals_unsplit(worlds, unsplit, case):
    """Every rank's losses, grad norms and lrs at RTOL of the unsplit
    run's; rank 0's gathered parameters moved as the unsplit run moved
    them, leaf by leaf (CHANGE_RTOL)."""
    want = unsplit_of(unsplit, case)
    ranks = ranks_of(worlds, case[3], case[0])
    for r, res in enumerate(ranks):
        assert res["ran"] == "split"
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose([h[k] for h in res["history"]],
                                       [h[k] for h in want["history"]], rtol=RTOL, atol=0,
                                       err_msg=f"{k} rank {r}")
    got = ranks[0]["params"]
    assert set(got) == set(want["params"])
    for n in want["params"]:
        assert leaf_apart(got, want, n) <= CHANGE_RTOL, n


@pytest.mark.parametrize("case", QK_NORM + TRAIN[3:4] + TRAIN[5:6],
                         ids=[c[0] for c in QK_NORM + TRAIN[3:4] + TRAIN[5:6]])
def test_qk_norm_scales_train_as_unsplit(worlds, unsplit, case):
    """Where the heads split over "model", each rank's gradient of a
    replicated q_norm / k_norm scale comes from its own heads only: the
    plan passes the scale through `copy_to`, so the ranks' parts add into
    the whole gradient, and the scales move as the unsplit step moves
    them, the same on every rank."""
    want = unsplit_of(unsplit, case)
    ranks = ranks_of(worlds, case[3], case[0])
    assert all(res["plan"]["heads"] for res in ranks)
    norms = [n for n in want["params"] if n.endswith(("q_norm.scale", "k_norm.scale"))]
    assert len(norms) == 4
    for n in norms:
        assert leaf_apart(ranks[0]["params"], want, n) <= CHANGE_RTOL, n
        for res in ranks[1:]:
            assert np.array_equal(res["not_model_split"][n], ranks[0]["not_model_split"][n]), n


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_replicated_leaves_agree_across_model(worlds, case):
    """A leaf "model" does not split (norms, router, a guarded group) is
    the same block, bitwise, on every rank of a "data" block after the
    steps."""
    ranks = ranks_of(worlds, case[3], case[0])
    for res in ranks:
        first = next(o for o in ranks if o["data_rank"] == res["data_rank"])
        assert set(res["not_model_split"]) == set(first["not_model_split"])
        for n, t in res["not_model_split"].items():
            assert np.array_equal(t, first["not_model_split"][n]), n


@pytest.mark.parametrize("case", TRAIN, ids=[c[0] for c in TRAIN])
def test_split_moe_step_equals_the_references(worlds, reference_step, case):
    """The first split step against the JAX package's one-device step on
    the same weights and batch, in as many microbatches as the unsplit
    run's (each routing one rank's rows)."""
    _, arch, _, spec = case
    want = reference_step[arch, dims(spec)["data"] * MICROBATCHES]
    for r, res in enumerate(ranks_of(worlds, spec, case[0])):
        for k in ("loss", "grad_norm"):
            assert res["history"][0][k] == pytest.approx(want[k], rel=1e-4), (k, r)


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_split_moe_holds_the_specs_bytes(worlds, case):
    """Each rank holds the specs' bytes of params, m and v: E/m experts a
    rank where "model" divides E, all E under the guard."""
    _, arch, over, spec = case
    cfg = cfg_of(arch, over)
    want = expected_held_bytes(cfg, dims(spec))
    assert want < expected_held_bytes(cfg, {})
    m = dims(spec)["model"]
    for r, res in enumerate(ranks_of(worlds, spec, case[0])):
        assert {h["held_bytes"] for h in res["history"]} == {want}, r
        if cfg.family == "moe":
            e = cfg.n_experts
            split = e % m == 0
            assert res["plan"]["experts"] == split
            assert tuple(res["plan"]["e"]) == ((r % m * e // m, (r % m + 1) * e // m) if split
                                               else (0, e))
            sff = cfg.d_ff * cfg.n_shared_experts
            assert res["plan"]["shared"] == bool(sff)
            if sff:
                assert tuple(res["plan"]["sf"]) == (r % m * sff // m, (r % m + 1) * sff // m)


def test_guard_computes_the_experts_whole(worlds):
    """6 experts on 4 "model" ranks: the guard replicates the experts, and
    the MoE layers make no collective over "model" (8 experts on the same
    mesh make some: the counter sees them)."""
    guard = ranks_of(worlds, "1,4", "guard@1,4")
    split = ranks_of(worlds, "1,4", f"{QWEN3}@1,4")
    assert all(not res["plan"]["experts"] and res["moe_model_collectives"] == 0
               for res in guard)
    assert all(res["plan"]["experts"] and res["moe_model_collectives"] > 0 for res in split)


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_split_moe_prefill_equals_unsplit(worlds, unsplit, case):
    """Each rank's last-token logits of its rows, gathered over "model",
    against the unsplit prefill's rows."""
    want = unsplit_of(unsplit, case)["prefill"]
    for r, res in enumerate(ranks_of(worlds, case[3], case[0])):
        rows = slice(*res["rows"])
        assert res["prefill"].shape == want[rows].shape
        np.testing.assert_allclose(res["prefill"], want[rows], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"rank {r}")


# --------------------------------------------------------------------------
# drops: routing against the unsplit run and the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsplit_layers(weights):
    """One process's unsplit prefill of step 0's whole batch at
    DROPS' capacity: each MoE layer's (input, output) and routing."""
    cfg = cfg_of(DEEPSEEK, DROPS)
    model = from_reference(weights[key(DEEPSEEK, DROPS)][2], cfg, device="cpu")
    layers, dispatch = [], []
    hooks = [mod.register_forward_hook(
        lambda mod, args, o: layers.append((args[0].numpy(), o[0].numpy())))
        for mod in model.net.modules() if isinstance(mod, moe_mod.MoE)]
    plain = moe_mod._dispatch

    def recorded(*a):
        got = plain(*a)
        dispatch.append(tuple(x.numpy() for x in got))
        return got
    moe_mod._dispatch = recorded
    try:
        with torch.no_grad():
            model(lt.batch_for(cfg, lt.data_config(cfg, SEQ, BATCH), 0, "cpu"),
                  impl="chunked", last_only=True)
    finally:
        moe_mod._dispatch = plain
        for h in hooks:
            h.remove()
    return layers, dispatch


def test_split_drops_equal_unsplit(worlds, unsplit_layers):
    """At capacity factor 0.25 on (1, 4) every rank routes the whole batch
    as the unsplit run does: the same expert and slot for every
    assignment, the same dropped ones, the same [E, C] dispatch, of which
    it runs its block of experts; each MoE layer's output at RTOL."""
    layers, dispatch = unsplit_layers
    cap = dispatch[0][3].shape[1]
    assert (dispatch[0][1] == cap).any() and (dispatch[0][1] < cap).any()   # drops and keeps
    for r, res in enumerate(ranks_of(worlds, "1,4", "drops@1,4")):
        assert tuple(res["plan"]["e"]) == (2 * r, 2 * r + 2)
        assert len(res["dispatch"]) == len(dispatch) == 2
        for got, want in zip(res["dispatch"], dispatch):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        for (x, y), (wx, wy) in zip(res["layers"], layers):
            np.testing.assert_allclose(x, wx, rtol=RTOL, atol=RTOL * np.abs(wx).max())
            np.testing.assert_allclose(y, wy, rtol=RTOL, atol=RTOL * np.abs(wy).max())


def test_data_ranks_route_their_rows_apart(worlds, weights):
    """On (2, 1) each rank routes its own rows with their own capacity: its
    MoE output is the reference's `moe_ffn` of its rows apart, and not
    the reference's of both ranks' rows together, whose capacity and slots
    span the global batch (ROADMAP §3, deliberate differences)."""
    ranks = ranks_of(worlds, "2,1", "drops@2,1")
    cfg = cfg_of(DEEPSEEK, DROPS, ref_configs)
    params = weights[key(DEEPSEEK, DROPS)][1]["layers"]["moe"]
    moe = jax.jit(ref_moe_ffn, static_argnums=1)
    for layer in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[layer], params)
        xs = [res["layers"][layer][0] for res in ranks]
        for r, (res, x) in enumerate(zip(ranks, xs)):
            want = np.asarray(moe(p, cfg, jnp.asarray(x))[0])
            np.testing.assert_allclose(res["layers"][layer][1], want, rtol=RTOL,
                                       atol=RTOL * np.abs(want).max(),
                                       err_msg=f"layer {layer} rank {r}")
        together = np.asarray(moe(p, cfg, jnp.asarray(np.concatenate(xs)))[0])
        apart = np.concatenate([res["layers"][layer][1] for res in ranks])
        assert np.abs(together - apart).max() > 1e-3 * np.abs(together).max()


# --------------------------------------------------------------------------
# split decode and serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_expected(weights):
    """(arch, d) → (one process's unsplit decode, the reference's), logits
    [T, B, V] of each of the d row blocks decoded apart (each routes its
    own rows, as a "data" rank does), joined."""
    out = {}
    toks = tokens((BATCH_DEC, DECODE_STEPS), 1)
    for _, arch, spec in DECODE_CASES:
        d = dims(spec)["data"]
        if (arch, d) in out:
            continue
        ref, params, arrays = weights[key(arch, {})]
        model = from_reference(arrays, cfg_of(arch), device="cpu")
        step = jax.jit(ref.decode_step)
        port, want = [], []
        for rows in blocks(d, BATCH_DEC):
            n = rows.stop - rows.start
            p, w = [], []
            with torch.inference_mode():
                cache = model.init_cache(n, MAX_LEN)
                for i in range(DECODE_STEPS):
                    lg, cache = model.decode_step(torch.from_numpy(toks[rows, i:i + 1]).long(),
                                                  cache, i)
                    p.append(lg.numpy())
            ref_cache = ref.init_cache(n, MAX_LEN)
            for i in range(DECODE_STEPS):
                lg, ref_cache = step(params, jnp.asarray(toks[rows, i:i + 1]), ref_cache,
                                     jnp.int32(i))
                w.append(np.asarray(lg, np.float32))
            port.append(np.stack(p))
            want.append(np.stack(w))
        out[arch, d] = (np.concatenate(port, axis=1), np.concatenate(want, axis=1))
    return out


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_split_moe_decode_equals_unsplit_and_the_reference(worlds, decode_expected, case):
    """Every step's logits of the rank's rows, whole on every rank, within
    RTOL of the unsplit decode's and ATOL of the reference's; the rank's
    rows equal on every rank of a "model" group."""
    cid, arch, spec = case
    port, want = decode_expected[arch, dims(spec)["data"]]
    ranks = ranks_of(worlds, spec, cid, "split_decode")
    for r, got in enumerate(ranks):
        assert got["ran"] == "split"
        rows = slice(*got["rows"])
        assert got["logits"].shape == port[:, rows].shape
        np.testing.assert_allclose(got["logits"], port[:, rows], rtol=RTOL,
                                   atol=RTOL * np.abs(port).max(), err_msg=f"rank {r}")
        np.testing.assert_allclose(got["logits"], want[:, rows], atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        assert all(np.array_equal(o["logits"], got["logits"]) for o in ranks
                   if o["rows"] == got["rows"])


@pytest.mark.parametrize("case", ENGINE_CASES, ids=[c[0] for c in ENGINE_CASES])
def test_served_moe_tokens_equal_the_references(worlds, weights, case):
    """`ServeEngine.generate` on a placed MoE model, each rank its rows of
    the prompts: the reference engine's greedy tokens on those rows."""
    cid, arch, spec = case
    ref, params, _ = weights[key(arch, {})]
    prompts = tokens((BATCH_DEC, PROMPT), 2)
    for r, got in enumerate(ranks_of(worlds, spec, cid, "split_decode")):
        rows = slice(*got["rows"])
        want = RefServeEngine(ref, params, max_len=ENGINE_LEN,
                              batch_size=rows.stop - rows.start) \
            .generate(prompts[rows], NEW_TOKENS).tokens
        assert got["ran"] == "split"
        assert np.array_equal(got["tokens"], want), r


# --------------------------------------------------------------------------
# gather_many over two dtypes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
def test_gather_many_keeps_each_dtype(worlds, world):
    """A bf16 leaf and an f32 leaf gathered together come back whole in
    their own dtypes, and so do their gradients: each rank's block of the
    summed gradient (the ranks ran other rows) or of its own (the same
    rows), against the unsplit product in f32 of the bf16-rounded leaf."""
    a = split_case_arrays(SEED, SPLIT_CASE_SHAPES)
    w1 = torch.from_numpy(a["w_gate"]).bfloat16()
    w2 = torch.from_numpy(a["w_down"])
    for summed in (True, False):
        t1, t2 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        (((torch.from_numpy(a["x"]) @ t1.float()) @ t2) ** 2).sum().backward()
        for r, res in enumerate(worlds[world]):
            got = res["gather_dtypes"]["g"][f"summed={summed}"]
            assert got["dtypes"] == ("torch.bfloat16", "torch.float32") * 2
            np.testing.assert_array_equal(got["w1"], w1.float().numpy())
            np.testing.assert_array_equal(got["w2"], w2.numpy())
            g1 = t1.grad.float().numpy()
            n1, n2 = g1.shape[0] // world, t2.shape[1] // world
            np.testing.assert_allclose(got["grad1"], g1[r * n1:(r + 1) * n1], rtol=1e-2,
                                       atol=1e-2 * np.abs(g1).max(), err_msg=f"rank {r}")
            np.testing.assert_allclose(got["grad2"], t2.grad.numpy()[:, r * n2:(r + 1) * n2],
                                       rtol=RTOL, atol=1e-4, err_msg=f"rank {r}")
