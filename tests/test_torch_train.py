"""The port's training path (`repro_torch.train`) against the JAX reference
(`repro.train`), at smoke sizes on the CPU.

The reference model is initialised with its own key and its parameter
tree is carried into the port by `models.weights.from_reference`, so both
hold the same weights; batches come from each package's `batch_at`,
which draw the same tokens. Tolerances:
  * schedules: rel 1e-6 (the same f32 ops);
  * loss: rel 1e-5 in f32; each gradient leaf within 1e-4 of that leaf's
    largest |g| (two layers of f32 arithmetic summed in another order);
  * one AdamW step: loss, grad norm and lr at rel 1e-4, parameters at
    atol 2.5·lr. The first step moves an element by about ±lr whatever
    the size of its gradient, so a gradient near zero whose sign differs
    between the two sums moves the element 2·lr the other way;
  * a restart: atol 1e-6, as the reference's own test (same process, same
    arithmetic).
The mirrors of tests/test_train_substrate.py and test_arch_smoke.py keep
their names with `port_` in front.
"""
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.train import OptimizerConfig as RefOC
from repro.train import adamw_update as ref_adamw_update
from repro.train import checkpoint as ref_ckpt
from repro.train import init_state as ref_init_state
from repro.train import lr_at as ref_lr_at
from repro.train import make_loss_fn as ref_make_loss_fn
from repro.train import make_train_step as ref_make_train_step
from repro.train.data import DataConfig as RefDC
from repro.train.data import batch_at as ref_batch_at
from repro.train.data import embeds_batch_at as ref_embeds_batch_at
from repro_torch import configs
from repro_torch.models import build
from repro_torch.models.weights import from_reference, reference_path
from repro_torch.train import (OptimizerConfig, adamw_update, checkpoint as ckpt, init_state,
                               lr_at, make_loss_fn, make_train_step)
from repro_torch.train.data import DataConfig, batch_at, embeds_batch_at

FAMILIES = ["qwen2.5-3b", "deepseek-moe-16b", "zamba2-1.2b", "xlstm-1.3b",
            "seamless-m4t-large-v2"]


def cfg_pair(name, dtype="float32", **kw):
    """(the port's config, the reference's) of `name` at smoke size."""
    return tuple(dataclasses.replace(a[name].smoke(), dtype=dtype, **kw)
                 for a in (configs.ARCHS, ref_configs.ARCHS))


def make_pair(name, dtype="float32", **kw):
    """(reference model, its params, the port's model holding them)."""
    cfg, rcfg = cfg_pair(name, dtype, **kw)
    ref = ref_build(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")


def batches(cfg, seq=16, batch=4, step=0):
    """(the port's batch on the CPU, the reference's) of `step`."""
    kw = dict(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    if cfg.family == "encdec":
        return (embeds_batch_at(DataConfig(**kw), step, cfg.d_model, "cpu"),
                ref_embeds_batch_at(RefDC(**kw), step, cfg.d_model))
    return batch_at(DataConfig(**kw), step, "cpu"), ref_batch_at(RefDC(**kw), step)


def ref_leaf(tree, name):
    """The reference's value of the port's parameter `name`."""
    path, idx = reference_path(name)
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree if idx is None else tree[idx], np.float32)


def as_np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------------
# schedules and data
# --------------------------------------------------------------------------

SCHEDULES = [dict(schedule="cosine"), dict(schedule="wsd", wsd_decay_frac=0.2),
             dict(schedule="constant"), dict(schedule="cosine", warmup_steps=0)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_lr_at_matches_reference(kw):
    kw = dict(dict(lr=3e-4, warmup_steps=10, total_steps=100), **kw)
    oc, roc = OptimizerConfig(**kw), RefOC(**kw)
    got = np.array([float(lr_at(oc, s)) for s in range(101)])
    want = np.array([float(ref_lr_at(roc, s)) for s in range(101)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert lr_at(oc, torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


def test_port_wsd_schedule_shape():
    oc = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         schedule="wsd", wsd_decay_frac=0.2, min_lr_frac=0.1)
    assert float(lr_at(oc, 0)) == 0.0
    assert float(lr_at(oc, 10)) == pytest.approx(1.0)
    assert float(lr_at(oc, 50)) == pytest.approx(1.0)      # stable plateau
    assert float(lr_at(oc, 79)) == pytest.approx(1.0, abs=0.06)
    assert float(lr_at(oc, 100)) == pytest.approx(0.1)     # decayed floor


def test_port_cosine_schedule_monotone_tail():
    oc = OptimizerConfig(lr=1.0, warmup_steps=5, total_steps=50, schedule="cosine")
    lrs = [float(lr_at(oc, s)) for s in range(5, 51, 5)]
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_batches_are_the_references_bit_for_bit(shards):
    for shard in range(shards):
        kw = dict(vocab=100, seq_len=16, global_batch=8, seed=3, num_shards=shards,
                  shard=shard, structure=8)
        for step in (0, 5):
            got = embeds_batch_at(DataConfig(**kw), step, 24, "cpu")
            want = ref_embeds_batch_at(RefDC(**kw), step, 24)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int64
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got["embeds"].dtype == torch.float32
            assert np.array_equal(got["embeds"].numpy(), np.asarray(want["embeds"]))
            plain = batch_at(DataConfig(**kw), step, "cpu")
            assert np.array_equal(plain["tokens"].numpy(), got["tokens"].numpy())


def test_port_data_pipeline_deterministic_and_sharded():
    dc = DataConfig(vocab=100, seq_len=16, global_batch=8)
    b1, b2 = batch_at(dc, 5, "cpu"), batch_at(dc, 5, "cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    s0 = batch_at(DataConfig(vocab=100, seq_len=16, global_batch=8, num_shards=2, shard=0),
                  5, "cpu")
    s1 = batch_at(DataConfig(vocab=100, seq_len=16, global_batch=8, num_shards=2, shard=1),
                  5, "cpu")
    assert tuple(s0["tokens"].shape) == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_batch_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch_at(DataConfig(vocab=100, seq_len=4, global_batch=2), 0)


# --------------------------------------------------------------------------
# loss and gradients, five families
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, reference model, params, port model, port batch, ref batch).
    32 tokens: two chunks of the smoke configs' ssm_chunk 16, so the
    Mamba2 and mLSTM inter-chunk loops carry state across a chunk."""
    ref, params, port = make_pair(request.param)
    return (request.param, ref, params, port) + batches(port.cfg, seq=32)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_reference(family, remat):
    name, ref, params, port, batch, rbatch = family
    (want, rparts), rgrads = jax.value_and_grad(
        ref_make_loss_fn(ref, impl="ref", remat=remat), has_aux=True)(params, rbatch)
    loss, parts = make_loss_fn(port, impl="ref", remat=remat)(batch)
    named = dict(port.net.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(parts["ce"].detach()) == pytest.approx(float(rparts["ce"]), rel=1e-5)
    assert float(torch.as_tensor(parts["aux"]).detach()) == pytest.approx(
        float(rparts["aux"]), rel=1e-5, abs=1e-7)
    for (n, p), g in zip(named.items(), grads):
        w = ref_leaf(rgrads, n)
        got = np.zeros(w.shape, np.float32) if g is None else as_np(g)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got - w).max() <= 1e-4 * scale, (name, n, np.abs(got - w).max(), scale)


def _grads_of(fn, args, cot):
    """The gradients of sum(fn(*args) * cot) with respect to every arg."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (fn(*ts).float() * torch.from_numpy(cot)).sum().backward()
    return [as_np(t.grad) for t in ts]


@pytest.mark.parametrize("site", ["chunked_attention", "chunked_linear_attention"])
def test_in_place_slice_writes_carry_gradients(site):
    """The port fills `out[...]` (chunked attention, query chunk by query
    chunk) and `h_prevs[:, c]` (the inter-chunk scan) by slice writes into
    an empty tensor; autograd passes through them. Gradients against
    `jax.grad` of the reference's functions, several chunks each (the
    sLSTM's `hs[:, t]` is held by the xlstm case of the family test)."""
    from repro.models import attention as ref_attention
    from repro.models import ssm as ref_ssm
    from repro_torch.models import attention, ssm
    rng = np.random.default_rng(7)
    if site == "chunked_attention":
        args = [rng.normal(size=(2, 3, 32, 16)).astype(np.float32) for _ in range(3)]
        kw = dict(causal=True, q_chunk=8, k_chunk=8)
        port_fn = lambda q, k, v: attention.chunked_attention(q, k, v, **kw)  # noqa: E731
        ref_fn = lambda q, k, v: ref_attention.chunked_attention(q, k, v, **kw)  # noqa: E731
    else:
        args = [rng.normal(size=(2, 32, 3, 8)).astype(np.float32) for _ in range(2)] + [
            rng.normal(size=(2, 32, 3, 4)).astype(np.float32),
            -np.abs(rng.normal(size=(2, 32, 3))).astype(np.float32) * 0.3]
        port_fn = lambda q, k, v, a: ssm.chunked_linear_attention(q, k, v, a, 8)  # noqa: E731
        ref_fn = lambda q, k, v, a: ref_ssm.chunked_linear_attention(q, k, v, a, 8)  # noqa: E731
    out = np.asarray(ref_fn(*map(jnp.asarray, args)))
    cot = rng.normal(size=out.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(ref_fn(*a).astype(jnp.float32) * cot),
                    argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    for got, w in zip(_grads_of(port_fn, args, cot), want):
        w = np.asarray(w)
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), site


def test_remat_recomputes_the_layer_bodies():
    """With remat under grad, the backward runs each layer body again: the
    count of MLP calls doubles; without grad it does not. (A pre-hook: the
    recomputation stops once it has what the backward needs, before the
    last op of the body returns.)"""
    _, _, port = make_pair("qwen2.5-3b")
    batch, _ = batches(port.cfg)
    calls = []
    hooks = [layer.mlp.register_forward_pre_hook(lambda *a: calls.append(1))
             for layer in port.net.layers]
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        loss, _ = make_loss_fn(port, remat=remat)(batch)
        loss.backward()
        assert len(calls) == want, (remat, len(calls))
    calls.clear()
    with torch.inference_mode():
        make_loss_fn(port, remat=True)(batch)
    assert len(calls) == 2
    for h in hooks:
        h.remove()


# --------------------------------------------------------------------------
# one train step, microbatching, weight decay
# --------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """The reference's test_grad_accumulation_consistency, each side held
    against the other: qwen2.5-3b smoke (qkv biases and norms) in f32."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref, params, port = make_pair("qwen2.5-3b")
    batch, rbatch = batches(port.cfg, batch=8)
    rstate = ref_init_state(ref, jax.random.PRNGKey(0))
    rstate = dataclasses.replace(rstate, params=params)
    rstep = jax.jit(ref_make_train_step(ref, RefOC(**kw), microbatches=microbatches))
    rstate, rm = rstep(rstate, rbatch)
    state = init_state(port)
    state, m = make_train_step(port, OptimizerConfig(**kw), microbatches=microbatches)(
        state, batch)
    assert int(state.step) == 1 and state.step.dtype == torch.int32
    for k in ("loss", "ce", "lr", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-4), k
    assert float(m["aux"]) == float(rm["aux"]) == 0.0
    lr = float(m["lr"])
    for n, p in state.params.items():
        np.testing.assert_allclose(as_np(p), ref_leaf(rstate.params, n), atol=2.5 * lr,
                                   rtol=0, err_msg=n)
        np.testing.assert_allclose(as_np(state.opt["m"][n]), ref_leaf(rstate.opt["m"], n),
                                   atol=1e-5, rtol=1e-3, err_msg=n)


def test_port_grad_accumulation_consistency():
    """microbatches=1 vs 4 on the port's own bf16 smoke model: (nearly)
    identical updates, at the reference's tolerances."""
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=0.0)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8), 0, "cpu")
    outs = []
    for mb in (1, 4):
        m = build(cfg, device="cpu")
        state, metrics = make_train_step(m, oc, microbatches=mb)(init_state(m), batch)
        outs.append((float(metrics["loss"]), as_np(m.net.embed)))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-3)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=5e-3)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "zamba2-1.2b"])
def test_weight_decay_follows_the_references_rank(name):
    """With zero gradients AdamW's step is the decay alone, p·(1 − lr·wd).
    The reference decays every leaf of rank >= 2, and its per-layer leaves
    carry the [L] axis: a layer's [d] norm scale decays (its qkv bias too,
    zeros here), `ln_f` and the hybrid's unstacked `shared_attn` norms do
    not."""
    ref, params, port = make_pair(name)
    oc = OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=10, weight_decay=0.5)
    roc = RefOC(**dataclasses.asdict(oc))
    rparams, _, _ = jax.jit(lambda p, o: ref_adamw_update(roc, p, jax.tree.map(
        jnp.zeros_like, p), o))(params, ref_init_state(ref, jax.random.PRNGKey(0)).opt)
    named = dict(port.net.named_parameters())
    before = {n: as_np(p).copy() for n, p in named.items()}
    adamw_update(oc, named, {n: torch.zeros_like(p) for n, p in named.items()},
                 init_state(port).opt)
    factor = 1 - float(lr_at(oc, 1)) * oc.weight_decay
    for n, p in named.items():
        np.testing.assert_allclose(as_np(p), ref_leaf(rparams, n), rtol=1e-6, atol=0,
                                   err_msg=n)
    decayed = {n for n in named if not np.array_equal(as_np(named[n]), before[n])}
    assert "ln_f.scale" not in decayed
    if name == "qwen2.5-3b":
        assert {"layers.0.ln1.scale", "layers.1.ln2.scale", "layers.0.attn.wq"} <= decayed
        np.testing.assert_allclose(as_np(named["layers.0.ln1.scale"]),
                                   before["layers.0.ln1.scale"] * factor, rtol=1e-6)
    else:
        assert {"layers.0.dt_bias", "layers.1.norm.scale"} <= decayed
        assert not decayed & {"shared_attn.ln1.scale", "shared_attn.ln2.scale"}


# --------------------------------------------------------------------------
# training behaviour
# --------------------------------------------------------------------------

def test_port_loss_decreases_20_steps():
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    m = build(cfg, device="cpu")
    state = init_state(m)
    step = make_train_step(m, OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=100),
                           microbatches=2)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, structure=8)
    losses = []
    for i in range(20):
        state, metrics = step(state, batch_at(dc, i, "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_port_train_step_finite(name):
    """Every config of configs.ARCHS at smoke size takes a finite step that
    moves its parameters (bf16, remat on, one microbatch)."""
    cfg = configs.ARCHS[name].smoke()
    m = build(cfg, device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in m.net.named_parameters()}
    batch, _ = batches(cfg, seq=32, batch=2)
    state, metrics = make_train_step(
        m, OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10), remat=True)(
        init_state(m), batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(state.step) == 1
    delta = sum(float((p.float() - before[n].float()).abs().sum())
                for n, p in m.net.named_parameters())
    assert delta > 0


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_port_checkpoint_atomicity_and_retention():
    m = build(configs.ARCHS["qwen2.5-3b"].smoke(), device="cpu")
    state = init_state(m)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            ckpt.save(d, s, state, keep=2)
        assert sorted(ckpt.all_steps(d)) == [3, 4]
        assert ckpt.latest_step(d) == 4
        assert not any(x.startswith("tmp-") for x in os.listdir(d))


def test_port_checkpoint_restart_resumes_identically():
    """Train 6 steps straight against 3 + crash + restore + 3: the same
    final state (the data pipeline is stateless)."""
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)

    def fresh():
        m = build(cfg, device="cpu")
        return m, init_state(m), make_train_step(m, oc)

    _, straight, step = fresh()
    for i in range(6):
        straight, _ = step(straight, batch_at(dc, i, "cpu"))
    with tempfile.TemporaryDirectory() as d:
        _, state, step = fresh()
        for i in range(3):
            state, _ = step(state, batch_at(dc, i, "cpu"))
        ckpt.save(d, 3, state)
        del state                                   # "crash"
        _, like, step = fresh()
        resumed = ckpt.restore(d, ckpt.latest_step(d), like)
        assert int(resumed.step) == 3
        for i in range(3, 6):
            resumed, _ = step(resumed, batch_at(dc, i, "cpu"))
    for n, p in straight.params.items():
        np.testing.assert_allclose(as_np(p), as_np(resumed.params[n]), atol=1e-6, err_msg=n)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "zamba2-1.2b"])
def test_checkpoint_is_the_references_format(name):
    """The port writes the reference's keys, shapes and dtypes (bf16 stored
    as f32, per-layer leaves stacked), and a manifest like the reference's."""
    cfg, rcfg = cfg_pair(name, "bfloat16")
    ref = ref_build(rcfg)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(os.path.join(d, "ref"), 2, ref_init_state(ref, jax.random.PRNGKey(0)))
        ckpt.save(os.path.join(d, "port"), 2, init_state(build(cfg, device="cpu")))
        man = [json.load(open(os.path.join(d, w, "step-2", "manifest.json")))
               for w in ("ref", "port")]
        keys = [list(np.load(os.path.join(d, w, "step-2", "arrays.npz")).keys())
                for w in ("ref", "port")]
    assert man[0] == man[1]
    assert sorted(keys[0]) == sorted(keys[1])
    assert ".params/layers/ln1/scale" in man[1]["leaves"] if name == "qwen2.5-3b" else \
        ".params/shared_attn/ln1/scale" in man[1]["leaves"]


def test_reference_checkpoint_restores_into_the_port():
    """The reference trains 2 steps and saves; the port restores that into a
    fresh state of its own (other weights) and both take step 3 on the same
    batch."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref, params, _ = make_pair("qwen2.5-3b")
    port = build(cfg_pair("qwen2.5-3b")[0], device="cpu", seed=7)
    rstate = dataclasses.replace(ref_init_state(ref, jax.random.PRNGKey(0)), params=params)
    rstep = jax.jit(ref_make_train_step(ref, RefOC(**kw)))
    for i in range(2):
        rstate, _ = rstep(rstate, batches(port.cfg, step=i)[1])
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(d, 2, rstate)
        state = ckpt.restore(d, 2, init_state(port))
    assert int(state.step) == 2
    for n, p in state.params.items():
        assert np.array_equal(as_np(p), ref_leaf(rstate.params, n)), n
        assert np.array_equal(as_np(state.opt["v"][n]), ref_leaf(rstate.opt["v"], n)), n
    batch, rbatch = batches(port.cfg, step=2)
    rstate, rm = rstep(rstate, rbatch)
    state, m = make_train_step(port, OptimizerConfig(**kw))(state, batch)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-4)
    for n, p in state.params.items():
        np.testing.assert_allclose(as_np(p), ref_leaf(rstate.params, n), atol=2.5e-3, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "xlstm-1.3b"])
def test_port_checkpoint_restores_into_the_reference(name):
    """The port trains 2 steps and saves; `repro.train.checkpoint.restore`
    reads it into the reference's state, leaf for leaf the port's, and the
    reference's step 3 from it matches the port's."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref, _, port = make_pair(name)
    state, step = init_state(port), make_train_step(port, OptimizerConfig(**kw))
    for i in range(2):
        state, _ = step(state, batches(port.cfg, step=i)[0])
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, state)
        rstate = ref_ckpt.restore(d, 2, ref_init_state(ref, jax.random.PRNGKey(3)))
    assert int(rstate.step) == 2
    for n, p in state.params.items():
        assert np.array_equal(as_np(p), ref_leaf(rstate.params, n)), n
        assert np.array_equal(as_np(state.opt["m"][n]), ref_leaf(rstate.opt["m"], n)), n
    batch, rbatch = batches(port.cfg, step=2)
    rstate, rm = jax.jit(ref_make_train_step(ref, RefOC(**kw)))(rstate, rbatch)
    state, m = step(state, batch)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    for n, p in state.params.items():
        np.testing.assert_allclose(as_np(p), ref_leaf(rstate.params, n), atol=2.5e-3, rtol=0,
                                   err_msg=n)


def test_restore_rejects_a_checkpoint_of_another_shape():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, init_state(build(configs.ARCHS["qwen2.5-3b"].smoke(), device="cpu")))
        other = dataclasses.replace(configs.ARCHS["qwen2.5-3b"].smoke(), d_ff=128)
        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore(d, 1, init_state(build(other, device="cpu")))
        deeper = dataclasses.replace(configs.ARCHS["qwen2.5-3b"].smoke(), n_layers=3)
        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore(d, 1, init_state(build(deeper, device="cpu")))
