"""The port's launch layer (`repro_torch.launch`: mesh, sharding, train)
against the reference's `repro.launch`, and sharded training on gloo ranks.

Specs are compared leaf for leaf at full size for every config of
`configs.ARCHS`: the reference's from `jax.eval_shape`, the port's from
its abstract build (`build(cfg, device="meta")`). A port leaf of a layer
stack is the reference's stacked leaf without its leading [L] entry.

Sharded training runs in worlds of gloo ranks (`torch_dist_worker`):
8 ranks run `run("qwen2.5-3b", "4,2", 6, ckpt_every=3)` and then resume on
"2,2,2" up to step 10 (the reference's tests/test_launch_train.py); 4
ranks run "2,2" and "4,1". Every rank's losses are held against the port's
own single-process run of the same steps at atol 2e-2: the smoke config is
bf16, and a sharded step sums its rows' gradients in another grouping, so
parameters differ by a bf16 ulp (2^-8 relative) here and there from the
first step on; the losses (about 6.2) measured within 5e-3 of each other
over 10 steps. Each rank's held bytes must equal the specs' arithmetic
exactly.
"""
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.launch import sharding as ref_sh
from repro.models import build as ref_build
from repro.train import init_state as ref_init_state
from repro_torch import configs
from repro_torch.launch import mesh, sharding as sh
from repro_torch.launch.train import run
from repro_torch.models import build
from repro_torch.models.weights import reference_path
from torch_dist_worker import reduce_case_grad, spawn_world

AXES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
        {"data": 4, "model": 2}, {"data": 2, "model": 2}]


def ref_flat(specs):
    """The reference's spec tree as {key path: tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(s)
            for path, s in leaves}


def as_reference(name, spec):
    """A port leaf's spec in the reference's layout: (reference key path,
    the spec with the [L] entry of a stack member put back)."""
    path, idx = reference_path(name)
    return path, ((None,) if idx is not None else ()) + tuple(spec)


# --------------------------------------------------------------------------
# mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [((4, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model")),
                                         ((8, 1), ("data", "model")),
                                         ((1, 8), ("data", "model"))])
def test_batch_axes_match_reference(eight_devices, shape, names):
    ref = jax.make_mesh(shape, names)
    port = types.SimpleNamespace(shape=dict(zip(names, shape)))
    assert mesh.batch_axes(port) == ref_mesh.batch_axes(ref)
    for b in (1, 2, 4, 6, 8, 16):
        assert mesh.effective_batch_axes(port, b) == ref_mesh.effective_batch_axes(ref, b), b


def test_production_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_production_mesh()


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shapes():
    """name → (the reference's parameter shapes, the port's meta model)."""
    cache = {}

    def get(name):
        if name not in cache:
            ref = ref_build(ref_configs.ARCHS[name])
            cache[name] = (jax.eval_shape(ref.init, jax.random.PRNGKey(0)), ref,
                           build(configs.ARCHS[name], device="meta"))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_param_specs_match_reference(shapes, name):
    ref_shapes, _, port = shapes(name)
    params = dict(port.net.named_parameters())
    for axes in AXES:
        want = ref_flat(ref_sh.param_specs(ref_shapes, axes))
        got = dict(as_reference(n, s) for n, s in sh.param_specs(params, axes).items())
        assert got == want, axes
        assert all(isinstance(s, sh.P) for s in sh.param_specs(params, axes).values())


def port_cache_flat(tree):
    """The port's cache spec tree as the reference's {key path: tuple}:
    every layer of a list must have the same spec, which gets its [L]
    entry back."""
    out = {}
    for group, node in tree.items():
        stacked = isinstance(node, list)
        members = node if stacked else [node]
        if isinstance(members[0], dict):
            leaves = {f"{group}/{k}": [m[k] for m in members] for k in members[0]}
        else:
            leaves = {group: members}
        for key, specs in leaves.items():
            assert len(set(specs)) == 1, key
            out[key] = ((None,) if stacked else ()) + tuple(specs[0])
    return out


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_cache_specs_match_reference(shapes, name):
    _, ref, port = shapes(name)
    kw = {"enc_len": 64} if configs.ARCHS[name].family == "encdec" else {}
    ref_cache = jax.eval_shape(lambda: ref.init_cache(16, 256, **kw))
    port_cache = port.init_cache(16, 256, **kw)
    for axes in AXES:
        for baxes in (("data",), ("pod", "data"), ()):
            want = ref_flat(ref_sh.cache_specs(ref_cache, baxes, axes))
            want = {k: v for k, v in want.items() if not k.endswith("/length")}
            assert port_cache_flat(sh.cache_specs(port_cache, baxes, axes)) == want


def test_port_param_sharding_rules(shapes):
    """The reference's test_param_sharding_rules on the port's specs."""
    _, _, port = shapes("qwen2.5-3b")
    specs = sh.param_specs(dict(port.net.named_parameters()), {"data": 16, "model": 16})
    assert specs["embed"] == sh.P("model", "data")
    assert specs["layers.0.attn.wq"] == sh.P("data", "model")
    assert specs["layers.35.mlp.w_down"] == sh.P("model", "data")
    assert specs["ln_f.scale"] == sh.P(None)
    assert specs["layers.0.ln1.scale"] == sh.P(None)
    assert specs["layers.0.attn.wk"] == sh.P("data", "model")     # 256 divides 16


def test_port_divisibility_guard(shapes):
    _, _, port = shapes("xlstm-1.3b")
    specs = sh.param_specs(dict(port.net.named_parameters()), {"data": 16, "model": 16})
    assert specs["mlstm.0.wf"] == sh.P("data", None)      # [d, 4 heads]: 4 % 16 != 0


def test_batch_and_state_specs_match_reference():
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int64),
             "embeds": torch.zeros((8, 16, 4))}
    for baxes in (("pod", "data"), ("data",), ()):
        want = ref_flat(ref_sh.batch_specs(
            {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in batch.items()},
            baxes))
        assert {k: tuple(v) for k, v in sh.batch_specs(batch, baxes).items()} == want
    ref = ref_build(ref_configs.ARCHS["qwen2.5-3b"].smoke())
    rstate = jax.eval_shape(lambda: ref_init_state(ref, jax.random.PRNGKey(0)))
    want = ref_sh.state_specs(rstate, {"data": 4, "model": 2})
    from repro_torch.train import init_state
    got = sh.state_specs(init_state(build(cfg, device="cpu")), {"data": 4, "model": 2})
    assert tuple(got["opt"]["step"]) == tuple(want.opt["step"]) == ()
    for group in ("m", "v"):
        flat = ref_flat(want.opt[group])
        assert dict(as_reference(n, s) for n, s in got["opt"][group].items()) == flat


# --------------------------------------------------------------------------
# sharded training on gloo ranks
# --------------------------------------------------------------------------

def expected_held_bytes(mesh_shape: dict) -> int:
    """The specs' arithmetic: every parameter's bytes, m's and v's (f32),
    divided by the ranks that split it."""
    cfg = run_cfg()
    params = dict(build(cfg, device="cpu").net.named_parameters())
    specs = sh.param_specs(params, mesh_shape)
    total = 0
    for n, p in params.items():
        ways = math.prod(sh._axis_size(e, mesh_shape) for e in specs[n])
        total += p.numel() // ways * (p.element_size() + 8)
    return total


def run_cfg():
    from repro_torch.launch.train import model_config
    return model_config("qwen2.5-3b", smoke=True)


@pytest.fixture(scope="module")
def single():
    """The port's own single-process run of 10 steps."""
    history = []
    run("qwen2.5-3b", "1", 10, device="cpu", history=history, log_every=100)
    return [h["loss"] for h in history]


def test_single_process_run_trains(single):
    assert len(single) == 10 and all(np.isfinite(single))


def test_eight_ranks_train_and_resume_elastically(single, tmp_path):
    d = str(tmp_path / "ckpt")
    res = spawn_world(8, {"train": [
        ("a", ("qwen2.5-3b", "4,2", 6), dict(ckpt_dir=d, ckpt_every=3, log_every=100)),
        ("b", ("qwen2.5-3b", "2,2,2", 10), dict(ckpt_dir=d, ckpt_every=100, log_every=100))]},
        tmp_path, timeout=240)
    held = {"a": expected_held_bytes({"data": 4, "model": 2}),
            "b": expected_held_bytes({"pod": 2, "data": 2, "model": 2})}
    assert "resumed from step 6 (re-sharded onto 2,2,2)" in res[0]["train"]["b"]["stdout"]
    assert "resumed" not in res[1]["train"]["b"]["stdout"]        # rank 0 prints
    for rank, r in enumerate(res):
        a, b = r["train"]["a"]["history"], r["train"]["b"]["history"]
        assert [h["step"] for h in a] == list(range(6))
        assert [h["step"] for h in b] == list(range(6, 10))
        losses = [h["loss"] for h in a + b]
        np.testing.assert_allclose(losses, single, atol=2e-2, rtol=0, err_msg=f"rank {rank}")
        assert losses == [h["loss"] for h in res[0]["train"]["a"]["history"]
                          + res[0]["train"]["b"]["history"]]
        assert r["train"]["a"]["loss"] == losses[5] and r["train"]["b"]["loss"] == losses[9]
        assert {h["held_bytes"] for h in a} == {held["a"]}, rank
        assert {h["held_bytes"] for h in b} == {held["b"]}, rank


def test_four_ranks_agree_across_meshes(single, tmp_path):
    res = spawn_world(4, {"train": [("a", ("qwen2.5-3b", "2,2", 4), dict(log_every=100)),
                                    ("b", ("qwen2.5-3b", "4,1", 4), dict(log_every=100))]},
                      tmp_path, timeout=240)
    for rank, r in enumerate(res):
        for case, shape in (("a", {"data": 2, "model": 2}), ("b", {"data": 4, "model": 1})):
            h = r["train"][case]["history"]
            np.testing.assert_allclose([x["loss"] for x in h], single[:4], atol=2e-2, rtol=0)
            assert {x["held_bytes"] for x in h} == {expected_held_bytes(shape)}
    whole = expected_held_bytes({})
    quarter = expected_held_bytes({"data": 2, "model": 2})
    assert whole / 4 < quarter < whole / 2     # a quarter, plus the norms held whole


REDUCE_CASES = {
    # (mesh shape, axis names, batch axes, {leaf: (spec, shape)})
    "2,2": ((2, 2), ("data", "model"), ("data",), {
        "w": (("data", "model"), (8, 6)), "e": (("model", "data"), (6, 8)),
        "c": ((None, "model"), (3, 4)), "n": ((None,), (5,)),
        "w_bf16": (("data", None), (4, 3))}),
    "4,1": ((4, 1), ("data", "model"), ("data",), {
        "w": (("data", "model"), (8, 6)), "e": (("model", "data"), (6, 8)),
        "n": ((None,), (5,))}),
    "2,2,2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), {
        "w": ((("pod", "data"), "model"), (8, 4)), "e": (("model", "data"), (6, 4)),
        "c": ((None, "model"), (3, 4)), "n": ((None,), (5,))}),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_reduce_grads_gives_each_rank_its_block_of_the_batch_mean(case, tmp_path):
    """`Layout.reduce_grads` on gloo ranks: each rank's block is its block
    of the mean over the batch axes of every rank's whole gradient (split
    dims reduce-scattered over a batch axis, narrowed over "model"; a dim
    over ("pod", "data") splits row-major), in f32, and the caller's dict
    is emptied; `global_norm` of the blocks is the whole mean's norm."""
    shape, names, baxes, leaves = REDUCE_CASES[case]
    res = spawn_world(math.prod(shape), {"reduce": [(case, shape, names, baxes, leaves)]},
                      tmp_path)
    world = np.arange(math.prod(shape)).reshape(shape)
    keys = {tuple(c for c, n in zip(np.unravel_index(r, shape), names) if n in baxes): r
            for r in world.flat}
    whole = {}
    for i, (n, (_, s)) in enumerate(leaves.items()):
        draws = [reduce_case_grad(s, names, baxes, n, i, np.unravel_index(r, shape))
                 for r in keys.values()]
        whole[n] = torch.stack([d.float() for d in draws]).mean(0).numpy()
    norm = math.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in whole.values()))
    sizes = dict(zip(names, shape))
    for r in res:
        out, coords = r["reduce"][case], dict(zip(names, r["reduce"][case]["coords"]))
        assert out["left"] == 0
        np.testing.assert_allclose(out["norm"], norm, rtol=1e-6)
        for n, (spec, _) in leaves.items():
            want = whole[n]
            for dim, entry in enumerate(spec):
                for a in sh._axes(entry):        # row-major: outer axis first
                    step = want.shape[dim] // sizes[a]
                    want = np.take(want, range(coords[a] * step, (coords[a] + 1) * step),
                                   axis=dim)
            got = out["blocks"][n]
            assert got.dtype == np.float32 and got.shape == want.shape, n
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=n)


def test_resumed_moments_match_the_unbroken_run(tmp_path):
    """The bound `chip_smoke.py` holds m and v to across a restore onto
    another mesh (MOMENT_RTOL = 0.1), on a 4-layer bf16 smoke model over 4
    gloo ranks, checkpointed on "2,2": on "4,1" and on "1,4" a resumed run
    lies within it of the unbroken "2,2" run, and so does an unbroken run
    (bf16 noise alone: the meshes sum the rows' gradients in other
    groupings); a restore whose m and v are lost lies far beyond it.
    Losses agree within chip_smoke's TRAIN_LOSS_RTOL = 1e-4."""
    res = spawn_world(4, {"moments": [("m", "qwen2.5-3b", 4, "2,2", ["4,1", "1,4"], 5, 3)]},
                      tmp_path, timeout=240)[0]["moments"]["m"]
    want = res["unbroken-a"]
    for spec in ("4,1", "1,4"):
        r = res[spec]
        assert r["resumed"]["apart"] < 0.1 and r["unbroken"]["apart"] < 0.1, (spec, r)
        assert r["dropped"]["apart"] > 0.4, (spec, r)
        np.testing.assert_allclose(r["unbroken"]["losses"], want, rtol=1e-4, err_msg=spec)
        np.testing.assert_allclose(r["resumed"]["losses"], want[3:], rtol=1e-4, err_msg=spec)


def fake_mesh(shape: dict, coords: dict):
    """A mesh's surface as `Layout` reads it (shape, each axis's rank),
    for one rank at `coords`, with no process group."""
    axes = {a: types.SimpleNamespace(rank=coords[a], size=n) for a, n in shape.items()}
    return types.SimpleNamespace(shape=shape, rank=0, axis=axes.__getitem__)


@pytest.mark.parametrize("coords", [dict(data=0, model=0), dict(data=1, model=1),
                                    dict(data=1, model=0)])
def test_port_elastic_checkpoint_restore_other_mesh(tmp_path, coords):
    """Save whole, restore with a layout (the re-mesh path): each leaf is
    this rank's block of the whole one, rows by "data" and columns by
    "model" as the spec says, replicated leaves whole; `place` on a whole
    state keeps the same blocks."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import init_state
    cfg = configs.ARCHS["qwen2.5-3b"].smoke()
    whole = init_state(build(cfg, device="cpu"))
    ckpt.save(str(tmp_path), 0, whole)
    shape = {"data": 2, "model": 2}
    lay = sh.named(fake_mesh(shape, coords), sh.param_specs(whole.params, shape))
    restored = ckpt.restore(str(tmp_path), 0, init_state(build(cfg, device="cpu", seed=9)),
                            shardings=lay)
    assert restored.layout is lay
    i, j = coords["data"], coords["model"]
    wq = whole.params["layers.0.attn.wq"]                 # P("data", "model")
    d, x = wq.shape
    assert torch.equal(restored.params["layers.0.attn.wq"],
                       wq[i * d // 2:(i + 1) * d // 2, j * x // 2:(j + 1) * x // 2])
    emb = whole.params["embed"]                           # P("model", "data")
    v, d = emb.shape
    assert torch.equal(restored.params["embed"],
                       emb[j * v // 2:(j + 1) * v // 2, i * d // 2:(i + 1) * d // 2])
    assert torch.equal(restored.params["ln_f.scale"], whole.params["ln_f.scale"])
    placed = sh.place(init_state(build(cfg, device="cpu")), lay)
    for n, p in restored.params.items():
        assert torch.equal(p, placed.params[n]), n
        assert lay.full_shape(n, p) == tuple(whole.params[n].shape)
        assert torch.equal(restored.opt["m"][n], placed.opt["m"][n])


def test_run_without_ranks_needs_a_one_rank_mesh():
    with pytest.raises(RuntimeError, match="torchrun"):
        run("qwen2.5-3b", "4,2", 1, device="cpu")
