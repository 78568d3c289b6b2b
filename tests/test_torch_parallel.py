"""The split plan of a dense model (`launch.parallel`, `launch.sharding.
SplitPlan`) on gloo ranks, against one process's unsplit computation and
the JAX package's one-device train step.

One world of 2 ranks and one of 4 (`torch_dist_worker.spawn_world`) run
every case:

  * the collectives with their gradients: a column-then-row split SwiGLU
    MLP (`copy_to`, `reduce_from`), the vocab embedding, the vocab cross
    entropy, `gather_over` and `gather_many` (summed and not), each
    against the unsplit function in f32 at rtol 1e-5;
  * two steps of a split train step of qwen2.5-3b's and phi4-mini-3.8b's
    smoke configs (2 layers, f32; phi4 ties its embeddings) on meshes
    (1, 2), (2, 2) and (1, 4) — at m = 4 qwen's and phi4's 2 KV heads are
    gathered over "model", each rank reading one — from the reference's
    weights (`models.weights.from_reference`): losses and grad norms at
    rtol 1e-5 of one process's unsplit step, each leaf's change over the
    two steps (gathered) within CHANGE_RTOL of the unsplit change in norm,
    every rank's held bytes equal to the specs' arithmetic; the first
    step's loss and grad norm at rel 1e-4 of the reference's
    `make_train_step` (the tolerance of tests/test_torch_train.py: its own
    sharded step fails under jax 0.9.0, ROADMAP §3);
  * the same steps on the gathered plan (the path of the other families)
    on (2, 2) and (1, 2), held to the unsplit step alike;
  * the split prefill's last-token logits (`impl="chunked"`), whole on
    every rank, at rtol 1e-5 of the unsplit prefill's.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from repro_torch.models.weights import from_reference
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from repro_torch.train.train_step import cross_entropy
from torch_dist_worker import SPLIT_CASE_SHAPES, spawn_world, split_case_arrays

SPLIT_ARCHS = ("qwen2.5-3b", "phi4-mini-3.8b")
MESHES = {2: ("1,2",), 4: ("2,2", "1,4")}
CASES = [(arch, spec) for specs in MESHES.values() for spec in specs for arch in SPLIT_ARCHS]
GATHERED_CASES = [("qwen2.5-3b", "2,2"), ("phi4-mini-3.8b", "1,2")]
STEPS, MICROBATCHES, SEQ, BATCH = 2, 2, 16, 8
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SEED = 7
RTOL = 1e-5
# A leaf's change over the steps, split against unsplit: the norm of the
# difference over the norm of the unsplit change. AdamW moves an element by
# about lr a step whatever its gradient's size, so an element-wise bound
# near lr would pass a leaf left unchanged; this one fails it, and absorbs
# the few elements whose near-zero gradient flips sign between the two.
CHANGE_RTOL = 1e-2


def cfg_of(arch, package=configs):
    return dataclasses.replace(package.ARCHS[arch].smoke(), n_layers=2, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    """arch → (the reference's model, its params, them as numpy)."""
    out = {}
    for arch in SPLIT_ARCHS:
        ref = ref_build(cfg_of(arch, ref_configs))
        params = ref.init(jax.random.PRNGKey(0))
        out[arch] = (ref, params, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world size → every rank's results."""
    out = {}
    for world, specs in MESHES.items():
        cases = [(f"{arch}@{spec}", arch, spec, None) for spec in specs for arch in SPLIT_ARCHS]
        cases += [(f"{arch}@{spec} gathered", arch, spec, "gathered")
                  for arch, spec in GATHERED_CASES if spec in specs]
        payload = {"split_functions": [("f", SEED)],
                   "split_steps": [(cid, arch, weights[arch][2], spec, STEPS, MICROBATCHES,
                                    SEQ, BATCH, plan) for cid, arch, spec, plan in cases]}
        out[world] = spawn_world(world, payload, tmp_path_factory.mktemp("split"), timeout=240)
    return out


def ranks_of(worlds, spec):
    return worlds[math.prod(int(x) for x in spec.split(","))]


@pytest.fixture(scope="module")
def unsplit(weights):
    """arch → one process's unsplit prefill logits and STEPS steps (losses,
    grad norms, the parameters after them), from the reference's weights."""
    out = {}
    for arch in SPLIT_ARCHS:
        cfg = cfg_of(arch)
        model = from_reference(weights[arch][2], cfg, device="cpu")
        before = {n: p.detach().numpy().copy() for n, p in model.net.named_parameters()}
        dc = lt.data_config(cfg, SEQ, BATCH)
        with torch.no_grad():
            prefill, _ = model(lt.batch_for(cfg, dc, 0, "cpu"), impl="chunked", last_only=True)
        state = init_state(model)
        step = make_train_step(model, OptimizerConfig(**OC), microbatches=MICROBATCHES)
        hist = []
        for i in range(STEPS):
            state, met = step(state, lt.batch_for(cfg, dc, i, "cpu"))
            hist.append({k: float(met[k]) for k in ("loss", "grad_norm", "lr")})
        out[arch] = dict(prefill=prefill.numpy(), history=hist, before=before,
                         params={n: p.detach().numpy() for n, p in state.params.items()})
    return out


@pytest.fixture(scope="module")
def reference_step(weights):
    """arch → the reference's one-device first step (loss, grad norm)."""
    out = {}
    for arch in SPLIT_ARCHS:
        ref, params, _ = weights[arch]
        rstate = dataclasses.replace(ref_init_state(ref, jax.random.PRNGKey(0)), params=params)
        step = jax.jit(ref_make_train_step(ref, RefOC(**OC), microbatches=MICROBATCHES))
        rbatch = ref_batch_at(RefDC(vocab=ref.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                    structure=8), 0)          # launch.train.data_config
        _, met = step(rstate, rbatch)
        out[arch] = {k: float(met[k]) for k in ("loss", "grad_norm")}
    return out


# --------------------------------------------------------------------------
# the collectives with their gradients
# --------------------------------------------------------------------------

def unsplit_functions():
    """The unsplit counterparts of `run_split_functions`' cases."""
    a = {k: torch.from_numpy(v) for k, v in split_case_arrays(SEED, SPLIT_CASE_SHAPES).items()}
    t = {k: v.clone().requires_grad_() for k, v in a.items()}
    y = (F.silu(t["x"] @ t["w_gate"]) * (t["x"] @ t["w_up"])) @ t["w_down"]
    (y * a["cot"]).sum().backward()
    out = {"mlp": {"y": y.detach(), **{k: t[k].grad for k in ("x", "w_gate", "w_up",
                                                               "w_down")}}}
    tokens = torch.arange(12).reshape(4, 3) * 5 % 16
    e = t["table"][tokens]
    (e * a["cot"]).sum().backward()
    out["embed"] = {"y": e.detach(), "table": t["table"].grad}
    labels = torch.arange(6).reshape(2, 3) * 3 % 16
    ce = cross_entropy(t["logits"], labels)
    ce.backward()
    out["ce"] = {"loss": float(ce.detach()), "logits": t["logits"].grad}
    w = a["w_gate"].clone().requires_grad_()
    ((a["x"] @ w) ** 2).sum().backward()
    out["gather"] = {"w": a["w_gate"], "grad": w.grad}
    w1, w2 = a["w_gate"].clone().requires_grad_(), a["w_down"].clone().requires_grad_()
    (((a["x"] @ w1) @ w2) ** 2).sum().backward()
    out["gather_many"] = {"w1": a["w_gate"], "w2": a["w_down"], "grad1": w1.grad,
                          "grad2": w2.grad}
    return {k: {n: np.asarray(v) for n, v in d.items()} for k, d in out.items()}


def block(t, dim, rank, n):
    step = t.shape[dim] // n
    return np.take(t, range(rank * step, (rank + 1) * step), axis=dim)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_split_mlp_equals_unsplit(worlds, world):
    """Column-split w_gate and w_up behind `copy_to`, row-split w_down into
    `reduce_from`: output and input gradient whole on every rank, each
    weight's gradient the rank's block of the unsplit one."""
    want = unsplit_functions()["mlp"]
    for r, res in enumerate(worlds[world]):
        got = res["split_functions"]["f"]["mlp"]
        np.testing.assert_allclose(got["y"], want["y"], rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got["x"], want["x"], rtol=RTOL, atol=1e-6)
        for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0)):
            np.testing.assert_allclose(got[name], block(want[name], dim, r, world),
                                       rtol=RTOL, atol=1e-6, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("world", sorted(MESHES))
def test_vocab_embed_equals_lookup(worlds, world):
    want = unsplit_functions()["embed"]
    for r, res in enumerate(worlds[world]):
        got = res["split_functions"]["f"]["embed"]
        np.testing.assert_allclose(got["y"], want["y"], rtol=RTOL, atol=0)
        np.testing.assert_allclose(got["table"], block(want["table"], 0, r, world),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_vocab_cross_entropy_equals_cross_entropy(worlds, world):
    """The max, the sum of exponentials and the gold logit reduced over the
    ranks' vocab blocks: the loss of the whole logits, and each rank's
    block of its gradient."""
    want = unsplit_functions()["ce"]
    for r, res in enumerate(worlds[world]):
        got = res["split_functions"]["f"]["ce"]
        assert got["loss"] == pytest.approx(want["loss"], rel=RTOL)
        np.testing.assert_allclose(got["logits"], block(want["logits"], 2, r, world),
                                   rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_gather_over_gradients(worlds, world):
    """All-gather forward; backward the sum over the ranks cut to the rank's
    block when the ranks ran other rows (each its block of x), the rank's
    block of its own gradient when they ran the same rows (all of x)."""
    want = unsplit_functions()["gather"]
    for r, res in enumerate(worlds[world]):
        f = res["split_functions"]["f"]
        for summed in (True, False):
            got = f[f"gather_summed={summed}"]
            np.testing.assert_array_equal(got["w"], want["w"])
            np.testing.assert_allclose(got["grad"], block(want["grad"], 0, r, world),
                                       rtol=RTOL, atol=1e-5, err_msg=f"summed={summed}")


@pytest.mark.parametrize("world", sorted(MESHES))
def test_gather_many_equals_gather_over(worlds, world):
    """Two leaves in one all-gather, w_gate split by rows and w_down by
    columns: each joined along its own dim; backward, each its block of
    the summed gradient (the ranks ran other rows) or of its own (the
    same rows)."""
    want = unsplit_functions()["gather_many"]
    for r, res in enumerate(worlds[world]):
        f = res["split_functions"]["f"]
        for summed in (True, False):
            got = f[f"gather_many_summed={summed}"]
            np.testing.assert_array_equal(got["w1"], want["w1"])
            np.testing.assert_array_equal(got["w2"], want["w2"])
            for k, dim in (("grad1", 0), ("grad2", 1)):
                np.testing.assert_allclose(got[k], block(want[k], dim, r, world), rtol=RTOL,
                                           atol=1e-4, err_msg=f"{k} summed={summed}")


# --------------------------------------------------------------------------
# the split train step and prefill
# --------------------------------------------------------------------------

def expected_held_bytes(arch, mesh_shape):
    """The specs' arithmetic: every parameter's bytes, m's and v's (f32),
    divided by the ranks that split it."""
    from repro_torch.models import build
    params = dict(build(cfg_of(arch), device="meta").net.named_parameters())
    specs = sh.param_specs(params, mesh_shape)
    return sum(p.numel() // math.prod(sh._axis_size(e, mesh_shape) for e in specs[n])
               * (p.element_size() + 8) for n, p in params.items())


def assert_steps_equal_unsplit(ranks, cid, want):
    """Every rank's losses, grad norms and lrs at RTOL of the unsplit
    step's; rank 0's gathered parameters moved as the unsplit step moved
    them, leaf by leaf (CHANGE_RTOL)."""
    for r, res in enumerate(ranks):
        hist = res["split_steps"][cid]["history"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose([h[k] for h in hist], [h[k] for h in want["history"]],
                                       rtol=RTOL, atol=0, err_msg=f"{k} rank {r}")
    got = ranks[0]["split_steps"][cid]["params"]
    assert set(got) == set(want["params"])
    for n, p in want["params"].items():
        moved, should = got[n] - want["before"][n], p - want["before"][n]
        assert np.linalg.norm(should) > 0, n
        apart = np.linalg.norm(moved - should) / np.linalg.norm(should)
        assert apart <= CHANGE_RTOL, (n, apart)


@pytest.mark.parametrize("arch,spec", CASES)
def test_split_step_equals_unsplit(worlds, unsplit, arch, spec):
    assert_steps_equal_unsplit(ranks_of(worlds, spec), f"{arch}@{spec}", unsplit[arch])


@pytest.mark.parametrize("arch,spec", GATHERED_CASES)
def test_gathered_step_equals_unsplit(worlds, unsplit, arch, spec):
    """A dense model made to run the gathered plan (the whole parameters
    gathered at the step's start, each gradient reduce-scattered into the
    rank's block): the unsplit step's losses and changes, the specs'
    bytes held."""
    cid = f"{arch}@{spec} gathered"
    ranks = ranks_of(worlds, spec)
    assert_steps_equal_unsplit(ranks, cid, unsplit[arch])
    want = expected_held_bytes(arch, dict(zip(("data", "model"), map(int, spec.split(",")))))
    for res in ranks:
        got = res["split_steps"][cid]
        assert got["ran"] == "gathered" and got["plan"] is None
        assert {h["held_bytes"] for h in got["history"]} == {want}


@pytest.mark.parametrize("arch,spec", CASES)
def test_split_step_equals_the_references(worlds, reference_step, arch, spec):
    """The first split step against the JAX package's one-device step on
    the same weights and batch."""
    for r, res in enumerate(ranks_of(worlds, spec)):
        first = res["split_steps"][f"{arch}@{spec}"]["history"][0]
        for k in ("loss", "grad_norm"):
            assert first[k] == pytest.approx(reference_step[arch][k], rel=1e-4), (k, r)


@pytest.mark.parametrize("arch,spec", CASES)
def test_split_step_holds_the_specs_bytes(worlds, arch, spec):
    dims = [int(x) for x in spec.split(",")]
    want = expected_held_bytes(arch, dict(zip(("data", "model"), dims)))
    whole = expected_held_bytes(arch, {})
    for r, res in enumerate(ranks_of(worlds, spec)):
        held = {h["held_bytes"] for h in res["split_steps"][f"{arch}@{spec}"]["history"]}
        assert held == {want}, r
    assert want < whole


@pytest.mark.parametrize("arch,spec", CASES)
def test_split_prefill_equals_unsplit(worlds, unsplit, arch, spec):
    """Each rank's last-token logits of its rows, gathered over "model",
    against the unsplit prefill's rows."""
    want = unsplit[arch]["prefill"]
    for r, res in enumerate(ranks_of(worlds, spec)):
        got = res["split_steps"][f"{arch}@{spec}"]
        rows = slice(*got["rows"])
        assert got["prefill"].shape == want[rows].shape
        np.testing.assert_allclose(got["prefill"], want[rows], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"rank {r}")


@pytest.mark.parametrize("arch,spec", CASES)
def test_split_plan_choices(worlds, arch, spec):
    """Heads, ff and vocab split over "model"; each rank's query heads its
    block of H; KV heads its own block only where "model" divides them
    (2 KV heads: at m = 2, not at m = 4, where each rank reads one)."""
    m = int(spec.split(",")[1])
    cfg = cfg_of(arch)
    for r, res in enumerate(ranks_of(worlds, spec)):
        assert res["split_steps"][f"{arch}@{spec}"]["ran"] == "split"
        plan = res["split_steps"][f"{arch}@{spec}"]["plan"]
        assert plan["heads"] and plan["ff"] and plan["vocab"]
        lo, hi = plan["q"]
        assert (lo, hi) == (r % m * cfg.n_heads // m, (r % m + 1) * cfg.n_heads // m)
        assert plan["own_q"] and plan["own_kv"] == (cfg.n_kv_heads % m == 0)
        group = cfg.n_heads // cfg.n_kv_heads
        assert tuple(plan["kv"]) == (lo // group, (hi - 1) // group + 1)
