"""The port's examples (`examples/torch_*.py`) at their smallest arguments on
the CPU (`--device cpu`), each held against the reference computed through
`repro`'s API on the same inputs: quickstart's three backends against the
reference's `local`; graph_analytics on GR and RM (sssp and tc equal, pr
at rtol 1e-4 / atol 1e-5, bc at rtol 1e-4 / atol 1e-4 with its nan
positions compared: tests/test_torch_programs.py's rules; tc against the
reference's oracle, since the reference's `local` tc takes about 30 s on
RM); query_server's verified flags and a tuning store reloaded; serve_lm
deterministic; train_lm's restored run equal to an unbroken one. Without a
card and without `--device cpu` every example raises."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import repro.core as rc
import repro.graph as rg
from repro.graph.algorithms_ref import triangle_count_ref

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "graph_analytics", "query_server", "serve_lm", "train_lm")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The examples' tensors are small: one intra-op thread runs them about
    as fast, and keeps this file from crowding the host's other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def example(name):
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_backends_equal_the_references():
    qs = example("quickstart")
    out = qs.main(CPU)
    g = rg.uniform_random(1000, 8, seed=42)
    want = np.asarray(rc.compile_program(qs.SSSP_SOURCE, backend="local")(g, src=0)["dist"])
    for backend, got in out["dist"].items():
        assert got.dtype == want.dtype and np.array_equal(got, want), backend
    assert out["cuda_identical"] and out["distributed_identical"]
    assert (out["nodes"], out["edges"]) == (g.num_nodes, g.num_edges)
    assert out["reached"] == int((want < 2**30).sum())
    assert not tdist.is_initialized()


def test_quickstart_refuses_a_group_it_did_not_make():
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            example("quickstart").main(CPU)
    finally:
        tdist.destroy_process_group()


def test_graph_analytics_equals_the_reference():
    out = example("graph_analytics").main(["--graphs", "GR,RM"] + CPU)
    graphs = rg.load_suite(["GR", "RM"])
    srcs = np.array([0, 3, 11, 17], np.int32)
    assert list(out) == ["GR", "RM"]
    for gname, g in graphs.items():
        got = out[gname]
        sssp = np.asarray(rc.compile_bundled("sssp", backend="local")(g, src=0)["dist"])
        assert np.array_equal(got["sssp"]["dist"], sssp) and got["sssp"]["verified"] is True
        pr = np.asarray(rc.compile_bundled("pr", backend="local")(
            g, beta=1e-4, delta=0.85, maxIter=100)["pageRank"])
        np.testing.assert_allclose(got["pr"]["pageRank"], pr, rtol=1e-4, atol=1e-5)
        assert got["tc"]["triangles"] == triangle_count_ref(g)
        bc = np.asarray(rc.compile_bundled("bc", backend="local")(g, sourceSet=srcs)["BC"])
        nan = np.isnan(bc)
        assert np.array_equal(np.isnan(got["bc"]["BC"]), nan)
        np.testing.assert_allclose(got["bc"]["BC"][~nan], bc[~nan], rtol=1e-4, atol=1e-4)


def test_query_server_verifies_every_answer():
    out = example("query_server").main(["--smoke", "--backend", "local"] + CPU)
    assert out["sssp_verified"] and out["lone_verified"] and out["bc_verified"]
    assert out["sssp_queries"] == 2 * 16 and out["max_batch"] <= 8
    assert out["autotune"] == []


def test_query_server_reloads_its_tuning_store(tmp_path):
    qs = example("query_server")
    argv = ["--smoke", "--autotune", "--tune-budget", "2", "--tune-store",
            str(tmp_path / "tune.json"), "--backend", "local"] + CPU
    first, second = qs.main(argv), qs.main(argv)
    assert [t["from_store"] for t in first["autotune"]] == [False] * 4
    assert [t["from_store"] for t in second["autotune"]] == [True] * 4
    assert second["sssp_verified"] and second["bc_verified"]


def test_serve_lm_tokens_are_deterministic():
    serve = example("serve_lm")
    one, two = serve.main(CPU), serve.main(CPU)
    assert one["tokens"].shape == (4, 8 + 12) and one["tokens"].dtype == np.int32
    assert np.array_equal(one["tokens"], two["tokens"])
    assert one["loss"] == two["loss"] and np.isfinite(one["loss"])


def test_train_lm_restart_equals_an_unbroken_run():
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.train import OptimizerConfig, init_state, make_train_step
    from repro_torch.train.data import DataConfig, batch_at

    steps, seq, batch = 6, 16, 4
    out = example("train_lm").main(["--steps", str(steps), "--seq", str(seq),
                                    "--batch", str(batch)] + CPU)
    assert out["restored_step"] == steps // 2 + 1
    cfg = dataclasses.replace(ARCHS["minicpm-2b"].smoke(), n_layers=4, vocab=1024)
    model = build(cfg, device="cpu", seed=0)
    state = init_state(model)
    step = make_train_step(model, OptimizerConfig(
        lr=3e-3, warmup_steps=20, total_steps=steps, schedule="wsd"),
        microbatches=2, impl="ref")
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, structure=8)
    for i in range(steps):
        state, m = step(state, batch_at(dc, i, device="cpu"))
    assert out["final_loss"] == float(m["loss"])
    assert out["device"] == "CPU"


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_card_raises(name, monkeypatch):
    """No card and no `--device cpu`: the example raises before it builds
    anything; it never carries on on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])
