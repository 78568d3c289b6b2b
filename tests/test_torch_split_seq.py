"""The split plan's sequence split (`REPRO_ATTN_SHARD=seq`, the reference's
context parallelism: `SplitPlan.seq_rows`, `models.attention.
seq_attention`), on gloo ranks, against one process's unsplit computation
and the JAX package's.

One world of 2 ranks and one of 4 (`torch_dist_worker.spawn_world`, each
spawned once with every case, the two side by side) run, in f32 from the
reference's weights (`models.weights.from_reference`), placed by
`launch.sharding` with `Layout.gather_params` made to raise and the plan
built under REPRO_ATTN_SHARD=seq:

  * qwen2.5-3b's smoke config (4 heads over 2 KV heads, qkv bias) and
    chameleon-34b's (qk-norm) on (1, 2), (2, 2) and (1, 4); qwen's with 6
    heads over 2 KV heads on (1, 4), whose 6 heads 4 does not divide (the
    case the reference's comment names); deepseek-moe-16b's,
    zamba2-1.2b's (its shared attention) and seamless-m4t-large-v2's (the
    encoder, the decoder and cross-attention) on (1, 2). Each case: the
    prefill's last-token logits (`impl="chunked"`) at RTOL of the unsplit
    prefill's and bitwise equal on the ranks that hold the same rows, every
    attention site run on the rank's S/m rows; two train steps
    (`impl="ref"`): losses, grad norms and lrs at RTOL of one process's
    unsplit steps, each leaf's change within CHANGE_RTOL, the leaves
    "model" does not split equal on every rank of a "data" block, the
    specs' bytes held; the unsplit first step of the dense configs at rel
    1e-4 of the reference's one-device step with the variable set (its
    constraint is a no-op without a mesh).
  * The guard: a sequence of 18 tokens on (1, 4), which 4 does not
    divide, runs the head split with the same collectives over "model",
    and the same logits bitwise, as with the variable unset.
  * Two mutants on (1, 2) (`torch_dist_worker._mutant_seq`): the
    attention weights gathered without summing over "model", and the rows
    cut without `copy_to`. Each fails the leaf-change check.

Beside the worlds: `chunked_attention` over each rank's causal prefix, in
chunks of `prefix_chunk` (prefixes that 1,024 does not divide among them),
equals those rows of the whole attention; the guard's rules and the plan's
reading of the variable, on a plan of no collectives.
"""
import concurrent.futures
import dataclasses
import math
import types

import jax
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
from repro_torch.core.dist import Mesh1D
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as lt
from repro_torch.models import build
from repro_torch.models.attention import chunked_attention, prefix_chunk
from repro_torch.models.transformer import _attn_sites
from repro_torch.models.weights import from_reference
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from torch_dist_worker import spawn_world

LAYERS = 2                  # layers (enc-dec: encoder and decoder layers)
STEPS, MICROBATCHES, SEQ, BATCH = 2, 2, 16, 8
ODD_SEQ = 18                # 2 divides it, 4 does not: the guard's case
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
RTOL = 1e-5
CHANGE_RTOL = 1e-2          # tests/test_torch_parallel.py's measure of a leaf's change
# name → (arch, config overrides)
MODELS = {"qwen": ("qwen2.5-3b", {}), "chameleon": ("chameleon-34b", {}),
          "qwen-h6": ("qwen2.5-3b", dict(n_heads=6, n_kv_heads=2)),
          "moe": ("deepseek-moe-16b", {}), "zamba2": ("zamba2-1.2b", {}),
          "seamless": ("seamless-m4t-large-v2", {})}
DENSE = ("qwen", "chameleon", "qwen-h6")
# (id, model, mesh, sequence, REPRO_ATTN_SHARD, mutant, train steps)
CASES = [(f"{name}@{spec}", name, spec, SEQ, "seq", None, STEPS)
         for name in ("qwen", "chameleon") for spec in ("1,2", "2,2", "1,4")]
CASES += [("qwen-h6@1,4", "qwen-h6", "1,4", SEQ, "seq", None, STEPS)]
CASES += [(f"{name}@1,2", name, "1,2", SEQ, "seq", None, STEPS)
          for name in ("moe", "zamba2", "seamless")]
IDS = [c[0] for c in CASES]
GUARD = [(f"qwen@1,4 seq={ODD_SEQ} {shard}", "qwen", "1,4", ODD_SEQ, shard, None, 0)
         for shard in ("seq", None)]
MUTANTS = [(f"qwen@1,2 {kind}", "qwen", "1,2", SEQ, "seq", kind, STEPS)
           for kind in ("unsummed", "uncopied")]


def cfg_of(name, package=configs):
    arch, overrides = MODELS[name]
    cfg = package.ARCHS[arch].smoke()
    layers = dict(n_enc_layers=LAYERS, n_dec_layers=LAYERS) if cfg.family == "encdec" \
        else dict(n_layers=LAYERS)
    return dataclasses.replace(cfg, dtype="float32", **layers, **overrides)


def world_of(spec):
    return math.prod(int(x) for x in spec.split(","))


def dims(spec):
    return dict(zip(("data", "model"), map(int, spec.split(","))))


def sites(cfg):
    """Attention calls of one forward: a layer's each, the hybrid's shared
    block at its call sites, the enc-dec family's encoder, decoder and
    cross-attention."""
    if cfg.family == "encdec":
        return 3 * LAYERS
    return len(_attn_sites(cfg)) if cfg.family == "hybrid" else cfg.n_layers


@pytest.fixture(scope="module")
def weights():
    """name → (the reference's model, its params, them as numpy)."""
    out = {}
    for name in MODELS:
        ref = ref_build(cfg_of(name, ref_configs))
        params = ref.init(jax.random.PRNGKey(0))
        out[name] = (ref, params, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world size → every rank's results (the two worlds run side by side)."""
    def run(world):
        cases = [dict(id=cid, arch=MODELS[name][0], overrides=MODELS[name][1], layers=LAYERS,
                      arrays=weights[name][2], spec=spec, steps=steps,
                      microbatches=MICROBATCHES, seq=seq, global_batch=BATCH,
                      attn_shard=shard, mutant=mutant)
                 for cid, name, spec, seq, shard, mutant, steps in CASES + GUARD + MUTANTS
                 if world_of(spec) == world]
        return spawn_world(world, {"split_seq": cases}, dirs[world],
                           timeout=300)
    # made here, not in the threads: the first mktemp of a worker creates its
    # base directory, and two threads doing so at once collide
    dirs = {world: tmp_path_factory.mktemp("seq") for world in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip((2, 4), pool.map(run, (2, 4))))


def ranks_of(worlds, case):
    return [res["split_seq"][case[0]] for res in worlds[world_of(case[2])]]


def blocks(d, rows):
    """The d row blocks of a batch of `rows` rows, as the "data" ranks hold them."""
    return [slice(i * rows // d, (i + 1) * rows // d) for i in range(d)]


@pytest.fixture(scope="module")
def unsplit(weights):
    """(name, d) → one process's unsplit run standing for a mesh of d
    "data" ranks: the prefill's last-token logits of each rank's rows of
    step 0's batch, STEPS steps of d · MICROBATCHES microbatches, the
    parameters before and after."""
    out = {}
    for cid, name, spec, *_ in CASES + MUTANTS:
        d = dims(spec)["data"]
        if (name, d) in out:
            continue
        cfg = cfg_of(name)
        model = from_reference(weights[name][2], cfg, device="cpu")
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
        out[name, d] = dict(prefill=prefill, history=hist, before=before,
                            params={n: p.detach().numpy() for n, p in state.params.items()})
    return out


@pytest.fixture(scope="module")
def reference_steps(weights):
    """name → the reference's one-device first step (loss, grad norm) of a
    dense config under REPRO_ATTN_SHARD=seq, in MICROBATCHES microbatches."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_SHARD", "seq")
        for name in DENSE:
            ref, params, _ = weights[name]
            rstate = dataclasses.replace(ref_init_state(ref, jax.random.PRNGKey(0)),
                                         params=params)
            step = jax.jit(ref_make_train_step(ref, RefOC(**OC), microbatches=MICROBATCHES))
            rbatch = ref_batch_at(RefDC(vocab=ref.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        structure=8), 0)          # launch.train.data_config
            _, met = step(rstate, rbatch)
            out[name] = {k: float(met[k]) for k in ("loss", "grad_norm")}
    return out


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
# the plan's mode and its guard (no collective)
# --------------------------------------------------------------------------

def plan_on(monkeypatch, m, rank, setting="seq"):
    """The split plan of qwen's smoke config on a mesh (1, m) at "model"
    rank `rank`, built under REPRO_ATTN_SHARD=`setting` (None: unset); its
    axes hold no group, so no collective is made."""
    if setting is None:
        monkeypatch.delenv("REPRO_ATTN_SHARD", raising=False)
    else:
        monkeypatch.setenv("REPRO_ATTN_SHARD", setting)
    cfg = cfg_of("qwen")
    params = dict(build(cfg, device="meta").net.named_parameters())
    shape = {"data": 1, "model": m}
    mesh = types.SimpleNamespace(shape=shape, axis=lambda a: Mesh1D(
        group=None, size=shape[a], rank=rank if a == "model" else 0, device=None))
    return sh.SplitPlan(sh.named(mesh, sh.param_specs(params, shape), ()), cfg, params)


@pytest.mark.parametrize("setting,seq", [("seq", True), ("heads", False), ("", False),
                                         (None, False)])
def test_the_plan_reads_the_mode_once(monkeypatch, setting, seq):
    """Only "seq" turns the split on, as in the reference; the plan reads
    the variable when it is built, so a later change does not move it."""
    plan = plan_on(monkeypatch, 4, 3, setting)
    assert plan.seq is seq
    assert (plan.seq_rows(SEQ, "ref") is not None) is seq
    monkeypatch.setenv("REPRO_ATTN_SHARD", "heads" if seq else "seq")
    assert plan.seq is seq


@pytest.mark.parametrize("s,m,impl,rows", [
    (16, 4, "ref", (12, 16)), (18, 4, "ref", None), (18, 2, "ref", (9, 18)),
    (4096, 16, "chunked", (3840, 4096)), (2560, 2, "chunked", None),
    (3072, 2, "chunked", (1536, 3072)), (96, 4, "chunked", (72, 96)),
    (96, 4, "kernel", (72, 96)), (192, 4, "kernel", None), (1024, 4, "kernel", (768, 1024)),
    (16, 1, "ref", None)])
def test_the_guard_keeps_the_head_split(monkeypatch, s, m, impl, rows):
    """The last "model" rank's rows, or None where m does not divide S or
    S/m breaks the block rule: chunked's query chunk min(512, S/m) (1,280
    rows), the kernel's min(128, ·) on S/m and on every rank's causal
    prefix (48 rows: the prefix of 144 slots)."""
    assert plan_on(monkeypatch, m, m - 1).seq_rows(s, impl) == rows


@pytest.mark.parametrize("s,m,heads", [(4096, 16, 1), (3072, 2, 1), (96, 4, 3)])
def test_chunked_prefix_equals_the_whole_attention(s, m, heads):
    """Each rank's rows [S·r/m, S·(r+1)/m) of queries over its causal
    prefix [0, S·(r+1)/m), in kv chunks of `prefix_chunk(S/m)`, equal those
    rows of `attention_ref` over the whole sequence (f32, atol 1e-4: the
    sums of up to 4,096 terms, grouped otherwise; a wrong mask is off by
    about 0.1),
    whatever chunk `chunked_attention` would take by default (a prefix of
    1,280 or 1,536 slots, which 1,024 does not divide). Its largest
    divisor up to 1,024 divides every prefix."""
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn((1, heads, s, 16), generator=gen) for _ in range(3))
    whole = attention_ref(q[0], k[0], v[0], causal=True)
    n = s // m
    chunk = prefix_chunk(n)
    assert n % chunk == 0 and chunk <= 1024
    assert chunk == max(c for c in range(1, min(n, 1024) + 1) if n % c == 0)
    for r in range(m):
        lo, hi = n * r, n * (r + 1)
        got = chunked_attention(q[:, :, lo:hi], k[:, :, :hi], v[:, :, :hi], causal=True,
                                k_chunk=chunk)
        np.testing.assert_allclose(got[0].numpy(), whole[:, lo:hi].numpy(), atol=1e-4, rtol=0,
                                   err_msg=f"rank {r}")


# --------------------------------------------------------------------------
# the split train step and prefill
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_attention_ran_on_the_ranks_rows(worlds, case):
    """Every rank built its plan with the mode on and ran every attention
    site of the prefill on its S/m rows (`seq_join` of [rows, S/m, d]),
    and every site of each train microbatch twice (remat recomputes it)."""
    cfg, m = cfg_of(case[1]), dims(case[2])["model"]
    for r, res in enumerate(ranks_of(worlds, case)):
        assert res["ran"] == "split" and res["seq"] is True, r
        rows = res["rows"][1] - res["rows"][0]
        assert res["prefill_joins"] == [(rows, SEQ // m, cfg.d_model)] * sites(cfg), r
        assert res["step_joins"] == STEPS * MICROBATCHES * sites(cfg) * 2, r


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_seq_step_equals_unsplit(worlds, unsplit, case):
    """Every rank's losses, grad norms and lrs at RTOL of the unsplit
    run's; rank 0's gathered parameters moved as the unsplit run moved
    them, leaf by leaf (CHANGE_RTOL)."""
    want = unsplit[case[1], dims(case[2])["data"]]
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


@pytest.mark.parametrize("case", MUTANTS, ids=[c[0] for c in MUTANTS])
def test_a_faulty_sequence_split_fails_the_checks(worlds, unsplit, case):
    """The checks above see each mutant: its first loss is exact, but the
    attention weights' gradient (gathered without a summed backward) or
    x's (rows cut without `copy_to`) holds only the rank's rows' part, so
    some leaf moves wrongly."""
    want = unsplit[case[1], 1]
    first = ranks_of(worlds, case)[0]
    assert first["history"][0]["loss"] == pytest.approx(want["history"][0]["loss"], rel=RTOL)
    apart = {n: leaf_apart(first["params"], want, n) for n in want["params"]}
    assert max(apart.values()) > CHANGE_RTOL, apart


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_leaves_agree_across_model(worlds, case):
    """A leaf "model" does not split (the norms, the biases, the qk-norm
    scales) is the same block, bitwise, on every rank of a "data" block
    after the steps."""
    ranks = ranks_of(worlds, case)
    for res in ranks:
        first = next(o for o in ranks if o["data_rank"] == res["data_rank"])
        assert set(res["not_model_split"]) == set(first["not_model_split"])
        for n, t in res["not_model_split"].items():
            assert np.array_equal(t, first["not_model_split"][n]), n


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_seq_holds_the_specs_bytes(worlds, case):
    """Each rank holds the specs' bytes of params, m and v: the sequence
    split gathers the attention weights for a layer and keeps none."""
    cfg = cfg_of(case[1])
    want = expected_held_bytes(cfg, dims(case[2]))
    for r, res in enumerate(ranks_of(worlds, case)):
        assert {h["held_bytes"] for h in res["history"]} == {want}, r


@pytest.mark.parametrize("name", DENSE)
def test_unsplit_step_equals_the_references(unsplit, reference_steps, name):
    """The unsplit run's first step against the JAX package's one-device
    step under REPRO_ATTN_SHARD=seq, on the same weights and batch."""
    got = unsplit[name, 1]["history"][0]
    for k in ("loss", "grad_norm"):
        assert got[k] == pytest.approx(reference_steps[name][k], rel=1e-4), k


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_seq_prefill_equals_unsplit(worlds, unsplit, case):
    """Each rank's last-token logits of its rows (the last rank's rows'
    hidden state, gathered over "model" with the rest) at RTOL of the
    unsplit prefill's rows, bitwise equal on the ranks that hold the same
    rows."""
    want = unsplit[case[1], dims(case[2])["data"]]["prefill"]
    ranks = ranks_of(worlds, case)
    for r, res in enumerate(ranks):
        rows = slice(*res["rows"])
        assert res["prefill"].shape == want[rows].shape
        np.testing.assert_allclose(res["prefill"], want[rows], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"rank {r}")
        assert all(np.array_equal(o["prefill"], res["prefill"]) for o in ranks
                   if o["rows"] == res["rows"]), r


def test_a_sequence_4_does_not_divide_keeps_the_head_split(worlds):
    """At 18 tokens on (1, 4) the plan runs the head split: no attention
    site on the rank's rows, the same collectives over "model" in the same
    order as with the variable unset, and the same logits bitwise."""
    on, off = (ranks_of(worlds, case) for case in GUARD)
    for r, (a, b) in enumerate(zip(on, off)):
        assert a["seq"] is True and b["seq"] is False
        assert a["prefill_joins"] == b["prefill_joins"] == []
        assert a["model_collectives"] == b["model_collectives"] != [], r
        assert np.array_equal(a["prefill"], b["prefill"]), r
