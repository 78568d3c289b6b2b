"""The port's LM substrate (dense qwen2.5-3b at smoke size) against the JAX
reference.

The reference model is initialised with its own key, and its parameter
tree is carried into the port by `models.weights.from_reference`, so both
hold the same weights. Inputs are numpy arrays from a seed. Tolerances:
f32 logits at atol 1e-4 (two layers of f32 arithmetic in another order;
measured differences are near 1e-6); bf16 logits at atol 5e-2 (logits of
order 1, bf16 keeps 8 bits, and the two frameworks round at other places:
measured differences near 1e-2). Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.models import build
from repro_torch.models.weights import from_reference
from repro_torch.serve import ServeEngine

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def smoke(dtype, arch=configs.ARCHS):
    return dataclasses.replace(arch["qwen2.5-3b"].smoke(), dtype=dtype)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(dtype, reference model, its params, the port's model with them)."""
    dtype = request.param
    ref = ref_build(smoke(dtype, ref_configs.ARCHS))
    params = ref.init(jax.random.PRNGKey(0))
    port = from_reference(jax.tree.map(np.asarray, params), smoke(dtype), device="cpu")
    return dtype, ref, params, port


def tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("d,theta", [(32, 1e6), (128, 1e6), (64, 1e4)])
def test_rope_matches_reference(d, theta):
    from repro.models.layers import apply_rope as ref_apply_rope
    from repro.models.layers import rope_freqs as ref_rope_freqs
    from repro_torch.models.layers import apply_rope, rope_freqs
    want = np.asarray(ref_rope_freqs(d, theta), np.float32)
    assert np.array_equal(rope_freqs(d, theta, "cpu").float().numpy(), want)
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 16, 3, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta).numpy(),
        np.asarray(ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), atol=1e-5)


def test_configs_are_the_references():
    assert configs.ARCHS.keys() == ref_configs.ARCHS.keys()
    for name, cfg in configs.ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_configs.ARCHS[name])
        assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(
            ref_configs.ARCHS[name].smoke())
    assert [dataclasses.asdict(c) for c in configs.LM_SHAPES] == \
        [dataclasses.asdict(c) for c in ref_configs.LM_SHAPES]


@pytest.mark.parametrize("impl,last_only", [("ref", False), ("chunked", False),
                                            ("kernel", True)])
def test_forward_matches_reference(pair, impl, last_only):
    dtype, ref, params, port = pair
    toks = tokens((2, 64))
    want, _ = ref.forward(params, {"tokens": jnp.asarray(toks)}, impl=impl, remat=False,
                          last_only=last_only)
    with torch.inference_mode():
        got, aux = port({"tokens": torch.from_numpy(toks).long()}, impl=impl,
                        last_only=last_only)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    assert float(aux) == 0.0
    close(got, want, dtype)


def test_decode_steps_match_reference(pair):
    dtype, ref, params, port = pair
    toks = tokens((2, 8), seed=1)
    ref_cache = ref.init_cache(2, 16)
    with torch.inference_mode():
        cache = port.init_cache(2, 16)
        for i in range(8):
            want, ref_cache = ref.decode_step(params, jnp.asarray(toks[:, i:i + 1]),
                                              ref_cache, jnp.int32(i))
            got, cache = port.decode_step(torch.from_numpy(toks[:, i:i + 1]).long(),
                                          cache, i)
            close(got, want, dtype)
    assert all(lc["length"] == 8 for lc in cache["kv"])


def test_serve_engine_matches_reference(pair):
    _, ref, params, port = pair
    prompts = tokens((2, 4), seed=2)
    want = RefServeEngine(ref, params, max_len=32, batch_size=2).generate(prompts, 6)
    got = ServeEngine(port, max_len=32, batch_size=2).generate(prompts, 6)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (2, 10)
    assert np.array_equal(got.tokens, want.tokens)
    assert np.array_equal(got.tokens[:, :4], prompts)
    assert got.steps == want.steps == 10


def test_train_decode_consistency():
    """The port on its own (its own init, bf16): the kernel-path forward's
    last-token logits agree with the decode chain's, at the reference's
    bf16 tolerance of 0.05."""
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    m = build(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(tokens((1, 8), seed=3)).long()
    with torch.inference_mode():
        lf, _ = m({"tokens": toks}, impl="kernel", last_only=True)
        cache = m.init_cache(1, 8)
        for i in range(8):
            ld, cache = m.decode_step(toks[:, i:i + 1], cache, i)
    err = float((lf[0, -1] - ld[0]).abs().max())
    assert err < 0.05, err


def test_build_is_seeded_and_defaults_to_the_card():
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    a, b = build(cfg, device="cpu", seed=5), build(cfg, device="cpu", seed=5)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert not torch.equal(a.net.embed, build(cfg, device="cpu", seed=6).net.embed)
    assert a.device.type == "cpu" and a.net.embed.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg)


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_every_config_builds(name):
    """Every config of configs.ARCHS builds on the CPU at smoke size and
    runs a forward; at full size the port holds exactly as many parameters
    as the reference's init (jax.eval_shape: shapes only)."""
    cfg = configs.ARCHS[name]
    m = build(cfg.smoke(), device="cpu")
    batch = {"tokens": torch.from_numpy(tokens((1, 8))).long()}
    if cfg.family == "encdec":
        batch["embeds"] = torch.zeros((1, 16, cfg.smoke().d_model))
    with torch.inference_mode():
        logits, _ = m(batch, impl="kernel", last_only=True)
    assert tuple(logits.shape) == (1, 1, cfg.smoke().vocab_padded)
    assert bool(torch.isfinite(logits).all())
    shapes = jax.eval_shape(ref_build(ref_configs.ARCHS[name]).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in build(cfg, device="meta").parameters()) == want


def test_carry_over_rejects_a_tree_that_does_not_fit(pair):
    dtype, ref, params, _ = pair
    arrays = jax.tree.map(np.asarray, params)
    del arrays["ln_f"]
    with pytest.raises(KeyError, match="ln_f.scale"):
        from_reference(arrays, smoke(dtype), device="cpu")


def test_full_size_parameter_count():
    """qwen2.5-3b at full width and depth holds 3,086,200,832 parameters,
    77,076,992 per layer (the abstract build: every parameter a meta
    tensor, nothing of that size allocated)."""
    m = build(configs.ARCHS["qwen2.5-3b"], device="meta")
    assert all(t.device.type == "meta" for t in list(m.parameters()) + list(m.buffers()))
    assert sum(p.numel() for p in m.parameters()) == 3_086_200_832
    assert sum(p.numel() for p in m.net.layers[0].parameters()) == 77_076_992
    assert len(m.net.layers) == 36 and m.net.embed.shape == (152_064, 2048)
