"""The recurrent families on the split plan (`SplitPlan.mamba2_weights`,
`mlstm_weights`, `slstm_weights`, `_split_norm`; the hybrid's shared
attention block on the dense rows), on gloo ranks, against one process's
unsplit computation and the JAX package's.

One world of 2 ranks and one of 4 (`torch_dist_worker.spawn_world`, each
spawned once with every case) run zamba2-1.2b and xlstm-1.3b smoke
configs in f32 (zamba2 at 4 layers) from the reference's weights
(`models.weights.from_reference`), placed by `launch.sharding` with
`Layout.gather_params` made to raise, on (1, 2), (2, 1), (2, 2) and
(1, 4). zamba2's smoke config has 4 Mamba2 heads of 32 channels, N 16
and an in_proj of 292 columns (146 a rank at m = 2, 73 at m = 4, each
block crossing the z | x | B C | dt groups) and runs its shared
attention block after layers 1 and 3; xlstm's has an mLSTM layer of 4
heads of 32 and an sLSTM layer of 128 channels. Each case:

  * two train steps: losses, grad norms and lrs at RTOL of one
    process's unsplit steps (in as many microbatches as the mesh's
    "data" ranks run), each leaf's change within CHANGE_RTOL of the
    unsplit change, the norm scales, in_proj's and conv_w's B and C
    columns and a_log / dt_bias / d_skip among them, the leaves "model"
    does not split equal on every rank of a "data" block, the specs'
    bytes held; the unsplit run's first step at rel 1e-4 of the
    reference's one-device step;
  * the split prefill's last-token logits and 6 split decode steps at
    RTOL of the unsplit port's, the decode at ATOL of the reference's
    `decode_step`; the cache bytes a rank holds, leaf by leaf, the
    specs' except for the recorded differences (ROADMAP §3: Mamba2's
    conv holds the rank's x channels and B and C whole, the sLSTM state
    the rank's rows and channels);
  * on (1, 2), the same steps (no prefill or decode) with a faulty split RMSNorm
    (`torch_dist_worker._mutant_norms`): the scale without `copy_to`,
    or the cross-rank sum without its backward sum, each fails the
    leaf checks above; a norm without the cross-rank sum fails the
    losses.
"""
import concurrent.futures
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.train import OptimizerConfig as RefOC
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train.data import DataConfig as RefDC
from repro.train.data import batch_at as ref_batch_at
from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as lt
from repro_torch.models import build
from repro_torch.models.weights import from_reference
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from torch_dist_worker import spawn_world

ZAMBA, XLSTM = "zamba2-1.2b", "xlstm-1.3b"
LAYERS = {"zamba2-1.2b": 4, "xlstm-1.3b": 2}      # zamba2: two shared-attention sites
STEPS, MICROBATCHES, SEQ, BATCH = 2, 2, 16, 8
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
RTOL = 1e-5
CHANGE_RTOL = 1e-2          # tests/test_torch_parallel.py's measure of a leaf's change
ATOL = 1e-4                 # f32 logits against the reference (tests/test_torch_lm.py)
DECODE_STEPS, MAX_LEN = 6, 16
MESHES = ("1,2", "2,1", "2,2", "1,4")
CASES = [(f"{arch}@{spec}", arch, spec, None) for arch in (ZAMBA, XLSTM) for spec in MESHES]
MUTANTS = [(f"{arch}@1,2 {kind}", arch, "1,2", kind) for arch in (ZAMBA, XLSTM)
           for kind in ("scale_raw", "sum_no_backward", "local")]
IDS = [c[0] for c in CASES]


def cfg_of(arch, package=configs):
    return dataclasses.replace(package.ARCHS[arch].smoke(), n_layers=LAYERS[arch],
                               dtype="float32")


def world_of(spec):
    return math.prod(int(x) for x in spec.split(","))


def dims(spec):
    return dict(zip(("data", "model"), map(int, spec.split(","))))


def decode_tokens():
    return np.random.default_rng(1).integers(0, 512, (BATCH, DECODE_STEPS)).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """arch → (the reference's model, its params, them as numpy)."""
    out = {}
    for arch in (ZAMBA, XLSTM):
        ref = ref_build(cfg_of(arch, ref_configs))
        params = ref.init(jax.random.PRNGKey(0))
        out[arch] = (ref, params, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world size → every rank's results (the two worlds run side by side)."""
    def run(world):
        cases = [dict(id=cid, arch=arch, layers=LAYERS[arch], arrays=weights[arch][2],
                      spec=spec, steps=STEPS, microbatches=MICROBATCHES, seq=SEQ,
                      global_batch=BATCH, tokens=None if mutant else decode_tokens(),
                      max_len=MAX_LEN, mutant=mutant)
                 for cid, arch, spec, mutant in CASES + MUTANTS if world_of(spec) == world]
        return spawn_world(world, {"split_ssm": cases}, dirs[world],
                           timeout=300)
    # made here, not in the threads: the first mktemp of a worker creates its
    # base directory, and two threads doing so at once collide
    dirs = {world: tmp_path_factory.mktemp("ssm") for world in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip((2, 4), pool.map(run, (2, 4))))


def ranks_of(worlds, case):
    return [res["split_ssm"][case[0]] for res in worlds[world_of(case[2])]]


def blocks(d, rows):
    """The d row blocks of a batch of `rows` rows, as the "data" ranks hold them."""
    return [slice(i * rows // d, (i + 1) * rows // d) for i in range(d)]


@pytest.fixture(scope="module")
def unsplit(weights):
    """(arch, d) → one process's unsplit run standing for a mesh of d
    "data" ranks: the prefill's last-token logits of each rank's rows of
    step 0's batch, the decode logits [T, B, V] of every row, and STEPS
    steps of d · MICROBATCHES microbatches; the parameters before and
    after."""
    out = {}
    for arch in (ZAMBA, XLSTM):
        for d in (1, 2):
            cfg = cfg_of(arch)
            model = from_reference(weights[arch][2], cfg, device="cpu")
            before = {n: p.detach().numpy().copy() for n, p in model.net.named_parameters()}
            dc = lt.data_config(cfg, SEQ, BATCH)
            batch = lt.batch_for(cfg, dc, 0, "cpu")
            toks = torch.from_numpy(decode_tokens()).long()
            with torch.inference_mode():
                prefill = np.concatenate([
                    model({k: v[rows] for k, v in batch.items()}, impl="chunked",
                          last_only=True)[0].numpy() for rows in blocks(d, BATCH)])
                cache, dec = model.init_cache(BATCH, MAX_LEN), []
                for i in range(DECODE_STEPS):
                    lg, cache = model.decode_step(toks[:, i:i + 1], cache, i)
                    dec.append(lg.numpy())
            state = init_state(model)
            step = make_train_step(model, OptimizerConfig(**OC), microbatches=d * MICROBATCHES)
            hist = []
            for i in range(STEPS):
                state, met = step(state, lt.batch_for(cfg, dc, i, "cpu"))
                hist.append({k: float(met[k]) for k in ("loss", "grad_norm", "lr")})
            out[arch, d] = dict(
                prefill=prefill, decode=np.stack(dec), history=hist, before=before,
                params={n: p.detach().numpy() for n, p in state.params.items()})
    return out


def unsplit_of(unsplit, case):
    return unsplit[case[1], dims(case[2])["data"]]


@pytest.fixture(scope="module")
def reference_runs(weights):
    """arch → the reference's one-device first step (loss, grad norm) in
    MICROBATCHES and 2 · MICROBATCHES microbatches, and its decode logits
    [T, B, V]."""
    out = {}
    for arch in (ZAMBA, XLSTM):
        ref, params, _ = weights[arch]
        rbatch = ref_batch_at(RefDC(vocab=ref.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                    structure=8), 0)          # launch.train.data_config
        steps = {}
        for mb in (MICROBATCHES, 2 * MICROBATCHES):
            rstate = dataclasses.replace(ref_init_state(ref, jax.random.PRNGKey(0)),
                                         params=params)
            _, met = jax.jit(ref_make_train_step(ref, RefOC(**OC), microbatches=mb))(rstate,
                                                                                     rbatch)
            steps[mb] = {k: float(met[k]) for k in ("loss", "grad_norm")}
        step, toks = jax.jit(ref.decode_step), decode_tokens()
        cache, dec = ref.init_cache(BATCH, MAX_LEN), []
        for i in range(DECODE_STEPS):
            lg, cache = step(params, jnp.asarray(toks[:, i:i + 1]), cache, jnp.int32(i))
            dec.append(np.asarray(lg, np.float32))
        out[arch] = dict(steps=steps, decode=np.stack(dec))
    return out


def expected_held_bytes(cfg, mesh_shape):
    """The specs' arithmetic: every parameter's bytes, m's and v's (f32),
    divided by the ranks that split it."""
    params = dict(build(cfg, device="meta").net.named_parameters())
    specs = sh.param_specs(params, mesh_shape)
    return sum(p.numel() // math.prod(sh._axis_size(e, mesh_shape) for e in specs[n])
               * (p.element_size() + 8) for n, p in params.items())


def leaf_apart(got, want, n, cols=None):
    """The norm of a leaf's split change less its unsplit change over the
    norm of the unsplit change (of columns `cols` of it)."""
    pick = (lambda a: a) if cols is None else (lambda a: a[..., cols])
    moved = pick(got[n]) - pick(want["before"][n])
    should = pick(want["params"][n]) - pick(want["before"][n])
    assert np.linalg.norm(should) > 0, n
    return np.linalg.norm(moved - should) / np.linalg.norm(should)


def watched(cfg, names):
    """(leaf, columns) pairs that a split must sum over "model": every
    norm scale, in_proj's and conv_w's B and C columns, and each Mamba2
    layer's a_log, dt_bias and d_skip."""
    d, n = cfg.d_model, cfg.ssm_state
    out = [(k, None) for k in names if k.endswith("norm.scale")
           or k.endswith((".a_log", ".dt_bias", ".d_skip"))]
    out += [(k, slice(2 * d, 2 * d + 2 * n)) for k in names if k.endswith(".in_proj")]
    out += [(k, slice(d, d + 2 * n)) for k in names if k.endswith(".conv_w")]
    return out


# --------------------------------------------------------------------------
# the chunked recurrence's gradient past exp's overflow
# --------------------------------------------------------------------------

def test_chunked_attention_gradient_stays_finite_past_exp_overflow():
    """A chunk whose decays sum past 88 (log a of -10 a token over a chunk
    of 16): the reference's chunked form (`repro.models.ssm`, line 45)
    multiplies exp of the masked decays, inf above the diagonal, before
    its mask, so its gradient is NaN there; the port masks inside the
    exp. Its forward equals the reference's and its gradient the
    sequential oracle's (`linear_attention_ref`), all finite."""
    from repro.models.ssm import chunked_linear_attention as ref_chunked
    from repro_torch.models.ssm import chunked_linear_attention, linear_attention_ref
    rng = np.random.default_rng(3)
    b, s, h, n, p = 1, 32, 2, 4, 4
    arrays = [rng.standard_normal(shape).astype(np.float32) * 0.5
              for shape in ((b, s, h, n), (b, s, h, n), (b, s, h, p))]
    arrays.append(np.full((b, s, h), -10.0, np.float32))
    ref_y, ref_grad = jax.value_and_grad(
        lambda *a: jnp.sum(ref_chunked(*a, 16) ** 2), argnums=3)(*map(jnp.asarray, arrays))
    assert not np.isfinite(np.asarray(ref_grad)).all()      # the reference's NaN gradient

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        loss = torch.sum(fn(*ts) ** 2)
        loss.backward()
        return float(loss.detach()), [t.grad.numpy() for t in ts]
    got, got_g = grads(lambda *t: chunked_linear_attention(*t, 16))
    want, want_g = grads(linear_attention_ref)
    assert got == pytest.approx(float(ref_y), rel=1e-5)
    assert got == pytest.approx(want, rel=1e-5)
    for g, w in zip(got_g, want_g):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_is_the_references(dtype):
    """`layers.silu`'s gradient is jax.nn.silu's (to an f32 ulp: XLA's exp
    is not torch's), and 0 where exp(-x) overflows (x below -88), where autograd
    through x · (1 / (1 + exp(-x))) gave 0·inf, NaN: a full-size bf16
    zamba2 step met it on one card and on the split plan alike."""
    from repro_torch.models.layers import silu
    xs = np.concatenate([[-100.0, -89.0, -50.0, 0.0, 7.0],
                         np.random.default_rng(5).standard_normal(64) * 6]).astype(np.float32)
    x = torch.from_numpy(xs).to(getattr(torch, dtype)).requires_grad_()
    silu(x).sum().backward()
    want = jax.grad(lambda v: jax.nn.silu(v).sum())(jnp.asarray(xs, getattr(jnp, dtype)))
    got = x.grad.float().numpy()
    assert np.isfinite(got).all() and got[0] == 0
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2.5e-7, atol=0)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def test_plan_for_the_recurrent_families():
    """zamba2-1.2b and xlstm-1.3b run the split plan, as every family now
    does, seamless-m4t-large-v2 (enc-dec) included."""
    lay = sh.named(None, {}, ())            # plan_for reads the family alone
    for arch in (ZAMBA, XLSTM, "seamless-m4t-large-v2"):
        assert lay.plan_for(configs.ARCHS[arch]) == "split", arch


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_ssm_plan_choices(worlds, case):
    """Each rank's block of heads or channels over "model": zamba2's
    Mamba2 heads of 4 and its shared attention's 4 query heads, xlstm's
    mLSTM heads of 4 and sLSTM channels of 128."""
    cfg = cfg_of(case[1])
    m = dims(case[2])["model"]
    for r, res in enumerate(ranks_of(worlds, case)):
        assert res["ran"] == "split"
        k, plan = r % m, res["plan"]

        def block(n):
            return (k * n // m, (k + 1) * n // m)
        split = m > 1
        if cfg.family == "hybrid":
            assert plan["mamba"] == plan["heads"] == split and not plan["mlstm"]
            assert tuple(plan["mamba_heads"]) == block(4) and tuple(plan["q"]) == block(4)
        else:
            assert plan["mlstm"] == plan["slstm"] == split and not plan["mamba"]
            assert tuple(plan["mlstm_heads"]) == block(4)
            assert tuple(plan["channels"]) == block(cfg.d_model)


# --------------------------------------------------------------------------
# the split train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_ssm_step_equals_unsplit(worlds, unsplit, case):
    """Every rank's losses, grad norms and lrs at RTOL of the unsplit
    run's; rank 0's gathered parameters moved as the unsplit run moved
    them, leaf by leaf (CHANGE_RTOL)."""
    want = unsplit_of(unsplit, case)
    ranks = ranks_of(worlds, case)
    for r, res in enumerate(ranks):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose([h[k] for h in res["history"]],
                                       [h[k] for h in want["history"]], rtol=RTOL, atol=0,
                                       err_msg=f"{k} rank {r}")
    got = ranks[0]["params"]
    assert set(got) == set(want["params"])
    for n in want["params"]:
        assert leaf_apart(got, want, n) <= CHANGE_RTOL, n


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_norm_scales_and_shared_columns_train_as_unsplit(worlds, unsplit, case):
    """Each leaf a rank uses in part while "model" does not split it by
    that part (the split RMSNorm's scale, in_proj's and conv_w's B and C
    columns, a_log / dt_bias / d_skip) moves as the unsplit step moves it:
    the ranks' parts of its gradient add over "model"."""
    want = unsplit_of(unsplit, case)
    got = ranks_of(worlds, case)[0]["params"]
    pairs = watched(cfg_of(case[1]), want["params"])
    assert len(pairs) == (LAYERS[ZAMBA] * 6 if case[1] == ZAMBA else LAYERS[XLSTM])
    for n, cols in pairs:
        assert leaf_apart(got, want, n, cols) <= CHANGE_RTOL, (n, cols)


@pytest.mark.parametrize("case", MUTANTS, ids=[c[0] for c in MUTANTS])
def test_a_faulty_split_norm_fails_the_checks(worlds, unsplit, case):
    """The checks above see a split RMSNorm without its cross-rank sums:
    a scale without `copy_to` leaves the forward exact and moves the norm
    scales wrongly; a sum of squares without its backward sum moves the
    leaves before the norm wrongly (B and C, the gates); a norm over the
    rank's own channels changes the losses."""
    want = unsplit_of(unsplit, case)
    ranks = ranks_of(worlds, case)
    got = ranks[0]["params"]
    losses = [h["loss"] for h in ranks[0]["history"]]
    apart = {(n, str(cols)): leaf_apart(got, want, n, cols)
             for n, cols in watched(cfg_of(case[1]), want["params"])}
    kind = case[3]
    if kind == "local":
        assert not np.allclose(losses[0], want["history"][0]["loss"], rtol=RTOL, atol=0)
        return
    assert losses[0] == pytest.approx(want["history"][0]["loss"], rel=RTOL)
    if kind == "scale_raw":
        assert all(v > CHANGE_RTOL for (n, _), v in apart.items() if n.endswith(".norm.scale"))
    else:
        norm = ranks[0]["history"][0]["grad_norm"]
        assert not np.isclose(norm, want["history"][0]["grad_norm"], rtol=RTOL, atol=0)
        assert max(apart.values()) > CHANGE_RTOL, apart


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_leaves_agree_across_model(worlds, case):
    """A leaf "model" does not split (norms, a_log, dt_bias, d_skip) is the
    same block, bitwise, on every rank of a "data" block after the
    steps."""
    ranks = ranks_of(worlds, case)
    for res in ranks:
        first = next(o for o in ranks if o["data_rank"] == res["data_rank"])
        assert set(res["not_model_split"]) == set(first["not_model_split"])
        for n, t in res["not_model_split"].items():
            assert np.array_equal(t, first["not_model_split"][n]), n


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_ssm_holds_the_specs_bytes(worlds, case):
    """Each rank holds the specs' bytes of params, m and v."""
    cfg = cfg_of(case[1])
    want = expected_held_bytes(cfg, dims(case[2]))
    assert want < expected_held_bytes(cfg, {}) or world_of(case[2]) == 1
    for r, res in enumerate(ranks_of(worlds, case)):
        assert {h["held_bytes"] for h in res["history"]} == {want}, r


@pytest.mark.parametrize("arch", (ZAMBA, XLSTM))
def test_unsplit_step_equals_the_references(unsplit, reference_runs, arch):
    """The unsplit run's first step, in d · MICROBATCHES microbatches,
    against the JAX package's one-device step on the same weights and
    batch."""
    for d in (1, 2):
        got = unsplit[arch, d]["history"][0]
        want = reference_runs[arch]["steps"][d * MICROBATCHES]
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), (k, d)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_ssm_prefill_equals_unsplit(worlds, unsplit, case):
    """Each rank's last-token logits of its rows, gathered over "model",
    against the unsplit prefill's rows."""
    want = unsplit_of(unsplit, case)["prefill"]
    for r, res in enumerate(ranks_of(worlds, case)):
        rows = slice(*res["rows"])
        assert res["prefill"].shape == want[rows].shape
        np.testing.assert_allclose(res["prefill"], want[rows], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_ssm_decode_equals_unsplit_and_the_reference(worlds, unsplit, reference_runs,
                                                          case):
    """Every step's logits of the rank's rows, whole on every rank, within
    RTOL of the unsplit decode's and ATOL of the reference's
    `decode_step`; equal on the ranks that hold the same rows."""
    port = unsplit_of(unsplit, case)["decode"]
    ref = reference_runs[case[1]]["decode"]
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


def held_cache_bytes(cfg, spec, batch_axes):
    """path → the bytes a rank holds of each cache leaf: `cache_specs`'
    arithmetic, but for the recorded differences (ROADMAP §3): Mamba2's
    conv holds the rank's rows × K-1 × (its d/m x channels + 2N), an
    sLSTM state leaf the rank's rows × its d/m channels."""
    shape = dims(spec)
    whole = build(cfg, device="meta").init_cache(BATCH, MAX_LEN)
    specs = sh.cache_specs(whole, batch_axes, shape)
    rows = BATCH // math.prod(shape[a] for a in batch_axes)
    m = shape["model"]
    out = {}
    for group, layers in whole.items():
        for i, (lc, ls) in enumerate(zip(layers, specs[group])):
            for name, t in lc.items():
                if not isinstance(t, torch.Tensor):
                    continue
                split = math.prod(sh._axis_size(e, shape) for e in ls[name])
                got = t.numel() * 4 // split
                if group == "ssm" and name == "conv":
                    got = rows * (cfg.conv_width - 1) * (cfg.d_model // m + 2 * cfg.ssm_state) * 4
                elif group == "slstm":
                    got = rows * cfg.d_model // m * 4
                out[f"{group}.{i}.{name}"] = got
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_ssm_cache_holds_the_specs_bytes(worlds, case):
    """Each rank's cache, leaf by leaf: the specs' bytes (KV caches by
    rows and slots, Mamba2 and mLSTM h by heads, mLSTM m and n by rows),
    and the recorded differences where they part (Mamba2 conv, sLSTM
    c, n, m)."""
    cfg = cfg_of(case[1])
    for r, res in enumerate(ranks_of(worlds, case)):
        want = held_cache_bytes(cfg, case[2], tuple(res["batch_axes"]))
        assert res["cache_bytes"] == want, r
