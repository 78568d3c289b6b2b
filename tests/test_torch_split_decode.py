"""The split decode of a dense model (`SplitPlan.cache_slots`,
`models.attention.split_attention_decode`, `Transformer.decode_step` and
`init_cache` under a plan) on gloo ranks, against one process's unsplit
decode and the JAX package's.

One world of 2 ranks and one of 4 (`torch_dist_worker.spawn_world`, each
spawned once with every case) run smoke configs at 2 layers in f32 from
the reference's weights (`models.weights.from_reference`), placed by
`launch.sharding` with `Layout.gather_params` made to raise:

  * qwen2.5-3b (2 KV heads: owned at m = 2, gathered over "model" at
    m = 4) on (1, 2), (2, 2) and (1, 4); minicpm-2b (MHA) on (1, 4); and
    minicpm-2b at 6 heads on (1, 4), whose head blocks are uneven (1, 2,
    1, 2): DECODE_STEPS tokens from an empty cache of MAX_LEN slots, so
    the filled slots cross the blocks of the first ranks, every step's
    logits within RTOL of one process's unsplit `decode_step` and ATOL of
    the reference's (the tolerance of tests/test_torch_lm.py), every
    rank's cache block equal (RTOL) to the matching narrow of the unsplit
    cache, and exactly `cache_specs`' bytes held;
  * qwen2.5-3b on (1, 4) with a cache of 18 slots (4 does not divide it:
    every rank holds every slot and attends with its own heads), and with
    64 slots over 6 steps (blocks of 16: ranks 1 to 3 hold no filled slot);
  * `ServeEngine.generate` of each rank's rows on a placed qwen2.5-3b, on
    every mesh: the reference engine's tokens.
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
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.models import build
from repro_torch.models.weights import from_reference
from torch_dist_worker import spawn_world

RTOL = 1e-5
ATOL = 1e-4          # f32 logits against the reference (tests/test_torch_lm.py)
BATCH, MAX_LEN, DECODE_STEPS = 4, 16, 10
PROMPT, NEW_TOKENS, ENGINE_LEN = 4, 6, 32
UNEVEN = {"n_heads": 6, "n_kv_heads": 6}
# (case id, arch, config overrides, mesh spec, max_len, steps)
CASES = [("qwen@1,2", "qwen2.5-3b", {}, "1,2", MAX_LEN, DECODE_STEPS),
         ("qwen@2,2", "qwen2.5-3b", {}, "2,2", MAX_LEN, DECODE_STEPS),
         ("qwen@1,4", "qwen2.5-3b", {}, "1,4", MAX_LEN, DECODE_STEPS),
         ("minicpm@1,4", "minicpm-2b", {}, "1,4", MAX_LEN, DECODE_STEPS),
         ("uneven@1,4", "minicpm-2b", UNEVEN, "1,4", MAX_LEN, DECODE_STEPS),
         ("whole@1,4", "qwen2.5-3b", {}, "1,4", 18, DECODE_STEPS),
         ("empty@1,4", "qwen2.5-3b", {}, "1,4", 64, 6)]
ENGINE_SPECS = ("1,2", "2,2", "1,4")
CONFIGS = {("qwen2.5-3b", ()), ("minicpm-2b", ()), ("minicpm-2b", tuple(UNEVEN.items()))}


def cfg_of(arch, overrides=(), package=configs):
    return dataclasses.replace(package.ARCHS[arch].smoke(), n_layers=2, dtype="float32",
                               **dict(overrides))


def world_of(spec):
    return math.prod(int(x) for x in spec.split(","))


def tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """(arch, overrides) → (the reference's model, its params, them as numpy)."""
    out = {}
    for arch, overrides in CONFIGS:
        ref = ref_build(cfg_of(arch, overrides, ref_configs))
        params = ref.init(jax.random.PRNGKey(0))
        out[arch, overrides] = (ref, params, jax.tree.map(np.asarray, params))
    return out


def key(case):
    return case[1], tuple(case[2].items())


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world size → every rank's results."""
    out = {}
    for world in (2, 4):
        payload = [(cid, arch, over, weights[arch, tuple(over.items())][2], spec,
                    tokens((BATCH, steps), 1), max_len, None)
                   for cid, arch, over, spec, max_len, steps in CASES if world_of(spec) == world]
        payload += [(f"engine@{spec}", "qwen2.5-3b", {}, weights["qwen2.5-3b", ()][2], spec,
                     tokens((BATCH, PROMPT), 2), ENGINE_LEN, NEW_TOKENS)
                    for spec in ENGINE_SPECS if world_of(spec) == world]
        out[world] = spawn_world(world, {"split_decode": payload},
                                 tmp_path_factory.mktemp("decode"), timeout=240)
    return out


def inputs(case):
    """What a case's decode depends on: (weights' key, max_len, steps)."""
    return key(case), case[4], case[5]


@pytest.fixture(scope="module")
def expected(weights):
    """inputs(case) → (one process's unsplit decode: logits [T, B, V] and
    the cache (k, v a layer); the JAX package's jitted decode: logits)."""
    out = {}
    for case in CASES:
        if inputs(case) in out:
            continue
        _, arch, over, _, max_len, steps = case
        ref, params, arrays = weights[key(case)]
        toks = tokens((BATCH, steps), 1)
        model = from_reference(arrays, cfg_of(arch, over), device="cpu")
        port, want = [], []
        with torch.inference_mode():
            cache = model.init_cache(BATCH, max_len)
            for i in range(steps):
                lg, cache = model.decode_step(torch.from_numpy(toks[:, i:i + 1]).long(),
                                              cache, i)
                port.append(lg.numpy())
        step = jax.jit(ref.decode_step)
        ref_cache = ref.init_cache(BATCH, max_len)
        for i in range(steps):
            lg, ref_cache = step(params, jnp.asarray(toks[:, i:i + 1]), ref_cache, jnp.int32(i))
            want.append(np.asarray(lg, np.float32))
        out[inputs(case)] = (np.stack(port), [(lc["k"].numpy(), lc["v"].numpy())
                                              for lc in cache["kv"]], np.stack(want))
    return out


def decoded(worlds, case):
    return [res["split_decode"][case[0]] for res in worlds[world_of(case[3])]]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_decode_equals_unsplit(worlds, expected, case):
    """Every step's logits of the rank's rows, whole on every rank (and
    equal across the ranks of a "model" group), against the unsplit
    decode's; the cache's length advanced on every rank."""
    want = expected[inputs(case)][0]
    ranks = decoded(worlds, case)
    for r, got in enumerate(ranks):
        assert got["ran"] == "split"
        rows = slice(*got["rows"])
        assert got["logits"].shape == want[:, rows].shape
        np.testing.assert_allclose(got["logits"], want[:, rows], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"rank {r}")
        assert got["length"] == {case[5]}
        same_rows = [o for o in ranks if o["rows"] == got["rows"]]
        assert all(np.array_equal(o["logits"], got["logits"]) for o in same_rows)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_decode_equals_the_references(worlds, expected, case):
    """Every step's logits of the rank's rows against the JAX package's
    `decode_step` on the same weights, at tests/test_torch_lm.py's f32
    tolerance."""
    want = expected[inputs(case)][2]
    for r, got in enumerate(decoded(worlds, case)):
        np.testing.assert_allclose(got["logits"], want[:, slice(*got["rows"])], atol=ATOL,
                                   rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_cache_blocks_equal_unsplit(worlds, expected, case):
    """Each rank holds its rows and its block of slots of the unsplit
    cache: the sequence's m-th part where m divides max_len, else all of
    it (the whole case); a block past the filled slots stays zero."""
    _, _, _, spec, max_len, steps = case
    m = int(spec.split(",")[1])
    want = expected[inputs(case)][1]
    for r, got in enumerate(decoded(worlds, case)):
        lo, hi = got["slots"]
        step = max_len // m if max_len % m == 0 else max_len
        assert (lo, hi) == ((r % m * step, (r % m + 1) * step) if step < max_len
                            else (0, max_len))
        rows = slice(*got["rows"])
        for (k, v), (wk, wv) in zip(got["cache"], want):
            for a, b in ((k, wk), (v, wv)):
                b = b[rows, lo:hi]
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(initial=1))
                assert not a[:, max(steps - lo, 0):].any()
    if case[0].startswith("empty"):
        assert all(not k.any() for got in decoded(worlds, case)[1:] for k, _ in got["cache"])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_cache_holds_the_specs_bytes(worlds, case):
    """Each rank's cache bytes are `cache_specs`' arithmetic on the whole
    cache: every leaf's bytes over the ranks that split it."""
    _, arch, over, spec, max_len, _ = case
    shape = dict(zip(("data", "model"), map(int, spec.split(","))))
    whole = build(cfg_of(arch, over), device="meta").init_cache(BATCH, max_len)
    for got in decoded(worlds, case):
        specs = sh.cache_specs(whole, got["batch_axes"], shape)
        want = sum(lc[n].numel() * lc[n].element_size()
                   // math.prod(sh._axis_size(e, shape) for e in s[n])
                   for lc, s in zip(whole["kv"], specs["kv"]) for n in ("k", "v"))
        assert got["cache_bytes"] == want
        if max_len % shape["model"] == 0:
            assert want * shape["model"] * shape["data"] == 2 * sum(
                lc["k"].numel() * 4 for lc in whole["kv"])


@pytest.mark.parametrize("spec", ENGINE_SPECS)
def test_served_tokens_equal_the_references(worlds, weights, spec):
    """`ServeEngine.generate` on a placed model, each rank its rows of the
    prompts: the reference engine's greedy tokens."""
    ref, params, _ = weights["qwen2.5-3b", ()]
    prompts = tokens((BATCH, PROMPT), 2)
    want = RefServeEngine(ref, params, max_len=ENGINE_LEN, batch_size=BATCH) \
        .generate(prompts, NEW_TOKENS).tokens
    for r, res in enumerate(worlds[world_of(spec)]):
        got = res["split_decode"][f"engine@{spec}"]
        assert got["ran"] == "split"
        assert np.array_equal(got["tokens"], want[slice(*got["rows"])]), r
