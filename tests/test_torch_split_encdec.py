"""The enc-dec family on the split plan (`SplitPlan` over `enc_layers` and
`dec_layers`, `DecLayer.cross` under a plan, `SplitPlan.enc_slots`,
`models.attention.split_cross_decode`), on gloo ranks, against one
process's unsplit computation and the JAX package's.

One world of 2 ranks and one of 4 (`torch_dist_worker.spawn_world`, each
spawned once with every case, the two side by side) run
seamless-m4t-large-v2's smoke config in f32 (2 encoder and 2 decoder
layers, d 128, 4 heads of 32, 4 KV heads, ff 256, vocab 512) from the
reference's weights (`models.weights.from_reference`), placed by
`launch.sharding` with `Layout.gather_params` made to raise, on (1, 2),
(2, 1), (2, 2) and (1, 4). Each case:

  * two train steps: losses, grad norms and lrs at RTOL of one process's
    unsplit steps (in as many microbatches as the mesh's "data" ranks
    run), each leaf's change (the encoder's included) within CHANGE_RTOL
    of the unsplit change, the leaves "model" does not split equal on
    every rank of a "data" block, the specs' bytes held; the unsplit
    run's first step at rel 1e-4 of the reference's one-device step;
  * the split prefill's last-token logits at RTOL of the unsplit port's;
    6 split decode steps over an encoder output of ENC_LEN slots (split
    along its sequence over "model") at RTOL of the unsplit port's and
    ATOL of the reference's `decode_step`; the cache bytes a rank holds,
    leaf by leaf, the specs' (`cache_specs`: the self KV caches by rows
    and slots, `enc_out` by rows and encoder slots).

On (1, 4) the decode runs again over ODD_ENC_LEN slots, which 4 does not
divide: the guard keeps `enc_out` whole on every rank. On (1, 2) the same
steps run with a cross-attention that projects the encoder output
without `plan.enter` (`torch_dist_worker._mutant_cross`): its forward is
exact and its encoder leaves move wrongly.
"""
import concurrent.futures
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.models import encdec as ref_encdec
from repro.train import OptimizerConfig as RefOC
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train.data import DataConfig as RefDC
from repro.train.data import embeds_batch_at as ref_embeds_batch_at
from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as lt
from repro_torch.models import build
from repro_torch.models.weights import from_reference
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from torch_dist_worker import spawn_world

ARCH = "seamless-m4t-large-v2"
LAYERS = 2                  # encoder layers, and as many decoder layers
STEPS, MICROBATCHES, SEQ, BATCH = 2, 2, 16, 8
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
RTOL = 1e-5
CHANGE_RTOL = 1e-2          # tests/test_torch_parallel.py's measure of a leaf's change
ATOL = 1e-4                 # f32 logits against the reference (tests/test_torch_lm.py)
DECODE_STEPS, MAX_LEN = 6, 16
ENC_LEN, ODD_ENC_LEN = 16, 10   # 2 and 4 divide the first; 4 does not divide the second
MESHES = ("1,2", "2,1", "2,2", "1,4")
# (id, mesh, encoder slots of the decode, mutant, train steps)
CASES = [(f"encdec@{spec}", spec, ENC_LEN, None, STEPS) for spec in MESHES]
ODD = (f"encdec@1,4 enc_len={ODD_ENC_LEN}", "1,4", ODD_ENC_LEN, None, 0)
MUTANT = ("encdec@1,2 cross without enter", "1,2", ENC_LEN, "cross", STEPS)
DECODE_CASES = CASES + [ODD]
IDS = [c[0] for c in CASES]


def cfg_of(package=configs):
    return dataclasses.replace(package.ARCHS[ARCH].smoke(), n_enc_layers=LAYERS,
                               n_dec_layers=LAYERS, dtype="float32")


def world_of(spec):
    return math.prod(int(x) for x in spec.split(","))


def dims(spec):
    return dict(zip(("data", "model"), map(int, spec.split(","))))


def decode_tokens():
    return np.random.default_rng(1).integers(0, 512, (BATCH, DECODE_STEPS)).astype(np.int32)


def frames(enc_len):
    return np.random.default_rng(enc_len).normal(size=(BATCH, enc_len, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """(the reference's model, its params, them as numpy)."""
    ref = ref_build(cfg_of(ref_configs))
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world size → every rank's results (the two worlds run side by side)."""
    def run(world):
        cases = [dict(id=cid, arch=ARCH, layers=LAYERS, arrays=weights[2], spec=spec,
                      steps=steps, microbatches=MICROBATCHES, seq=SEQ, global_batch=BATCH,
                      frames=None if mutant else frames(enc_len), tokens=decode_tokens(),
                      enc_len=enc_len, max_len=MAX_LEN, mutant=mutant)
                 for cid, spec, enc_len, mutant, steps in CASES + [ODD, MUTANT]
                 if world_of(spec) == world]
        return spawn_world(world, {"split_encdec": cases}, dirs[world],
                           timeout=300)
    # made here, not in the threads: the first mktemp of a worker creates its
    # base directory, and two threads doing so at once collide
    dirs = {world: tmp_path_factory.mktemp("encdec") for world in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip((2, 4), pool.map(run, (2, 4))))


def ranks_of(worlds, case):
    return [res["split_encdec"][case[0]] for res in worlds[world_of(case[1])]]


def blocks(d, rows):
    """The d row blocks of a batch of `rows` rows, as the "data" ranks hold them."""
    return [slice(i * rows // d, (i + 1) * rows // d) for i in range(d)]


@pytest.fixture(scope="module")
def unsplit(weights):
    """d → one process's unsplit run standing for a mesh of d "data"
    ranks: the prefill's last-token logits of each rank's rows of step 0's
    batch, STEPS steps of d · MICROBATCHES microbatches, the parameters
    before and after; ("decode", S) → the decode logits [T, B, V] of
    every row over an encoder output of S slots."""
    cfg = cfg_of()
    out = {}
    model = from_reference(weights[2], cfg, device="cpu")
    toks = torch.from_numpy(decode_tokens()).long()
    with torch.inference_mode():
        for enc_len in (ENC_LEN, ODD_ENC_LEN):
            cache = model.init_cache(BATCH, MAX_LEN, enc_len=enc_len)
            model.net.set_encoder_output(cache, model.net.encode(torch.from_numpy(
                frames(enc_len))))
            dec = []
            for i in range(DECODE_STEPS):
                lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
                dec.append(lg.numpy())
            out["decode", enc_len] = np.stack(dec)
    for d in (1, 2):
        model = from_reference(weights[2], cfg, device="cpu")
        before = {n: p.detach().numpy().copy() for n, p in model.net.named_parameters()}
        dc = lt.data_config(cfg, SEQ, BATCH)
        batch = lt.batch_for(cfg, dc, 0, "cpu")
        with torch.inference_mode():
            prefill = np.concatenate([
                model({k: v[rows] for k, v in batch.items()}, impl="chunked",
                      last_only=True)[0].numpy() for rows in blocks(d, BATCH)])
        state = init_state(model)
        step = make_train_step(model, OptimizerConfig(**OC), microbatches=d * MICROBATCHES)
        hist = []
        for i in range(STEPS):
            state, met = step(state, lt.batch_for(cfg, dc, i, "cpu"))
            hist.append({k: float(met[k]) for k in ("loss", "grad_norm", "lr")})
        out[d] = dict(prefill=prefill, history=hist, before=before,
                      params={n: p.detach().numpy() for n, p in state.params.items()})
    return out


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The reference's one-device first step (loss, grad norm) in
    MICROBATCHES and 2 · MICROBATCHES microbatches, and its decode logits
    [T, B, V] over encoder outputs of ENC_LEN and ODD_ENC_LEN slots."""
    ref, params, _ = weights
    rbatch = ref_embeds_batch_at(RefDC(vocab=ref.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                       structure=8), 0, ref.cfg.d_model)  # launch.train's
    steps = {}
    for mb in (MICROBATCHES, 2 * MICROBATCHES):
        rstate = dataclasses.replace(ref_init_state(ref, jax.random.PRNGKey(0)), params=params)
        _, met = jax.jit(ref_make_train_step(ref, RefOC(**OC), microbatches=mb))(rstate, rbatch)
        steps[mb] = {k: float(met[k]) for k in ("loss", "grad_norm")}
    step, toks = jax.jit(ref.decode_step), decode_tokens()
    decode = {}
    for enc_len in (ENC_LEN, ODD_ENC_LEN):
        cache = ref.init_cache(BATCH, MAX_LEN, enc_len)
        cache["enc_out"] = ref_encdec.encode(params, ref.cfg, jnp.asarray(frames(enc_len)),
                                             remat=False)
        dec = []
        for i in range(DECODE_STEPS):
            lg, cache = step(params, jnp.asarray(toks[:, i:i + 1]), cache, jnp.int32(i))
            dec.append(np.asarray(lg, np.float32))
        decode[enc_len] = np.stack(dec)
    return dict(steps=steps, decode=decode)


def expected_held_bytes(cfg, mesh_shape):
    """The specs' arithmetic: every parameter's bytes, m's and v's (f32),
    divided by the ranks that split it."""
    params = dict(build(cfg, device="meta").net.named_parameters())
    specs = sh.param_specs(params, mesh_shape)
    return sum(p.numel() // math.prod(sh._axis_size(e, mesh_shape) for e in specs[n])
               * (p.element_size() + 8) for n, p in params.items())


def leaf_apart(got, want, n):
    """The norm of a leaf's split change less its unsplit change over the
    norm of the unsplit change."""
    moved = got[n] - want["before"][n]
    should = want["params"][n] - want["before"][n]
    assert np.linalg.norm(should) > 0, n
    return np.linalg.norm(moved - should) / np.linalg.norm(should)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def test_encdec_runs_the_split_plan():
    """seamless-m4t-large-v2 runs the split plan like every other family,
    and the gathered plan only where the layout asks for it."""
    lay = sh.named(None, {}, ())            # plan_for reads the family alone
    assert lay.plan_for(configs.ARCHS[ARCH]) == "split"
    lay._plan = "gathered"
    assert lay.plan_for(configs.ARCHS[ARCH]) == "gathered"


@pytest.mark.parametrize("block", ["self_attn.wq", "cross_attn.wk", "mlp.w_down"])
def test_a_decoder_split_unlike_the_encoder_raises(block):
    """`SplitPlan` takes one block of heads and of ff columns for the
    encoder and the decoder: a decoder leaf whose spec splits over
    "model" unlike the encoder's raises instead of computing wrongly."""
    from repro_torch.core.dist import Mesh1D
    cfg = cfg_of()
    params = dict(build(cfg, device="meta").net.named_parameters())
    shape = {"data": 1, "model": 2}
    mesh = types.SimpleNamespace(shape=shape, axis=lambda a: Mesh1D(
        group=None, size=shape[a], rank=0, device=None))        # no collective is made
    specs = sh.param_specs(params, shape)
    specs[f"dec_layers.0.{block}"] = sh.P(None, None)
    lay = sh.named(mesh, specs, ())
    with pytest.raises(ValueError, match=f"dec_layers.0.{block}"):
        sh.SplitPlan(lay, cfg, params)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_encdec_plan_choices(worlds, case):
    """Each rank's block of the 4 query heads (and the 4 KV heads, its
    own), of the 256 ff columns and of the 512 vocab rows over "model"."""
    m = dims(case[1])["model"]
    for r, res in enumerate(ranks_of(worlds, case)):
        assert res["ran"] == "split"
        k, plan = r % m, res["plan"]

        def block(n):
            return (k * n // m, (k + 1) * n // m)
        split = m > 1
        assert plan["heads"] == plan["ff"] == plan["vocab"] == split
        assert plan["own_q"] == plan["own_kv"] == split
        assert tuple(plan["q"]) == tuple(plan["kv"]) == block(4)
        assert tuple(plan["f"]) == block(256) and tuple(plan["v"]) == block(512)


# --------------------------------------------------------------------------
# the split train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_encdec_step_equals_unsplit(worlds, unsplit, case):
    """Every rank's losses, grad norms and lrs at RTOL of the unsplit
    run's; rank 0's gathered parameters moved as the unsplit run moved
    them, leaf by leaf (CHANGE_RTOL), the encoder's leaves among them."""
    want = unsplit[dims(case[1])["data"]]
    ranks = ranks_of(worlds, case)
    for r, res in enumerate(ranks):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose([h[k] for h in res["history"]],
                                       [h[k] for h in want["history"]], rtol=RTOL, atol=0,
                                       err_msg=f"{k} rank {r}")
    got = ranks[0]["params"]
    assert set(got) == set(want["params"])
    assert any(n.startswith("enc_layers.") for n in got)
    for n in want["params"]:
        assert leaf_apart(got, want, n) <= CHANGE_RTOL, n


def test_a_cross_attention_without_enter_fails_the_checks(worlds, unsplit):
    """The checks above see a cross-attention that projects the encoder
    output without `plan.enter`: the first loss is exact, but each rank's
    encoder gets only its own heads' part of the cross-attention's
    gradient, so the first grad norm parts from the unsplit one and the
    encoder's leaves move wrongly."""
    want = unsplit[1]
    first = ranks_of(worlds, MUTANT)[0]
    assert first["history"][0]["loss"] == pytest.approx(want["history"][0]["loss"], rel=RTOL)
    assert not np.isclose(first["history"][0]["grad_norm"], want["history"][0]["grad_norm"],
                          rtol=RTOL, atol=0)
    got = first["params"]
    enc = {n: leaf_apart(got, want, n) for n in want["params"] if n.startswith("enc_layers.")}
    assert max(enc.values()) > CHANGE_RTOL, enc


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_leaves_agree_across_model(worlds, case):
    """A leaf "model" does not split (the norms) is the same block,
    bitwise, on every rank of a "data" block after the steps."""
    ranks = ranks_of(worlds, case)
    for res in ranks:
        first = next(o for o in ranks if o["data_rank"] == res["data_rank"])
        assert set(res["not_model_split"]) == set(first["not_model_split"])
        for n, t in res["not_model_split"].items():
            assert np.array_equal(t, first["not_model_split"][n]), n


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_encdec_holds_the_specs_bytes(worlds, case):
    """Each rank holds the specs' bytes of params, m and v."""
    cfg = cfg_of()
    want = expected_held_bytes(cfg, dims(case[1]))
    assert want < expected_held_bytes(cfg, {})
    for r, res in enumerate(ranks_of(worlds, case)):
        assert {h["held_bytes"] for h in res["history"]} == {want}, r


def test_unsplit_step_equals_the_references(unsplit, reference_runs):
    """The unsplit run's first step, in d · MICROBATCHES microbatches,
    against the JAX package's one-device step on the same weights and
    batch."""
    for d in (1, 2):
        got = unsplit[d]["history"][0]
        want = reference_runs["steps"][d * MICROBATCHES]
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), (k, d)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_split_encdec_prefill_equals_unsplit(worlds, unsplit, case):
    """Each rank's last-token logits of its rows, gathered over "model",
    against the unsplit prefill's rows."""
    want = unsplit[dims(case[1])["data"]]["prefill"]
    for r, res in enumerate(ranks_of(worlds, case)):
        rows = slice(*res["rows"])
        assert res["prefill"].shape == want[rows].shape
        np.testing.assert_allclose(res["prefill"], want[rows], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"rank {r}")


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_split_encdec_decode_equals_unsplit_and_the_reference(worlds, unsplit,
                                                              reference_runs, case):
    """Every step's logits of the rank's rows, whole on every rank, within
    RTOL of the unsplit decode's and ATOL of the reference's
    `decode_step` over the same encoder output; equal on the ranks that
    hold the same rows."""
    port = unsplit["decode", case[2]]
    ref = reference_runs["decode"][case[2]]
    ranks = ranks_of(worlds, case)
    for r, got in enumerate(ranks):
        rows = slice(*got["decode_rows"])
        assert got["decode"].shape == port[:, rows].shape
        np.testing.assert_allclose(got["decode"], port[:, rows], rtol=RTOL,
                                   atol=RTOL * np.abs(port).max(), err_msg=f"rank {r}")
        np.testing.assert_allclose(got["decode"], ref[:, rows], atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        assert all(np.array_equal(o["decode"], got["decode"]) for o in ranks
                   if o["decode_rows"] == got["decode_rows"])


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_split_encdec_cache_holds_the_specs_bytes(worlds, case):
    """Each rank's cache, leaf by leaf, `cache_specs`' bytes: each self KV
    cache by rows and slots, the encoder output by rows and encoder slots
    (its block of the sequence over "model", or all of it where "model"
    does not divide it), holding the unsplit encoder output's slots."""
    cfg, shape, enc_len = cfg_of(), dims(case[1]), case[2]
    m = shape["model"]
    whole = build(cfg, device="meta").init_cache(BATCH, MAX_LEN, enc_len=enc_len)
    for r, res in enumerate(ranks_of(worlds, case)):
        specs = sh.cache_specs(whole, tuple(res["batch_axes"]), shape)
        want = {f"kv.{i}.{n}": lc[n].numel() * 4 // math.prod(
                    sh._axis_size(e, shape) for e in specs["kv"][i][n])
                for i, lc in enumerate(whole["kv"]) for n in ("k", "v")}
        want["enc_out"] = whole["enc_out"].numel() * 4 // math.prod(
            sh._axis_size(e, shape) for e in specs["enc_out"])
        assert res["cache_bytes"] == want, r
        split = m > 1 and enc_len % m == 0
        k = r % m
        assert tuple(res["enc_slots"]) == ((k * enc_len // m, (k + 1) * enc_len // m)
                                           if split else (0, enc_len))
        assert res["enc_len"] == enc_len
