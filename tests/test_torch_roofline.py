"""The port's offline launch tools — `launch.hlo_cost` (the dispatch-level
cost census), `launch.roofline`, `launch.dryrun`, `launch.report` — and the
abstract build `models.build(cfg, device="meta")` they stand on, against
the reference's `repro.launch` and on programs of known cost.

Mirrors tests/test_roofline.py: a single matmul's 2·64·128·256 FLOPs, ten
trips counting 10×, nested trips 50×, a data-dependent loop on meta
flagged, the roofline terms and bottleneck (with the H100's constants),
`param_count` and `model_flops` equal to the reference's for every config
and cell. Its XLA-undercount case has no counterpart (eager torch runs
every trip; `xla_cost_dict` is not ported). Beyond it: the census equal
to `FlopCounterMode` on smoke-size train steps of every family, the bytes
of c10d collectives on a fake world, the dry run's microbatch scaling
against the census of the whole step, one smoke-size dry-run cell that
allocates nothing and whose record `report.render_table` reads, and the
abstract build's parameters equal in shape and dtype to
`jax.eval_shape(model.init)`'s for every config.
"""
import dataclasses
import json
from unittest import mock

import jax
import pytest
import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.configs.base import shape_cells_for as ref_cells
from repro.launch import roofline as ref_roofline
from repro.models import build as ref_build
from repro_torch import configs
from repro_torch.configs.base import shape_cells_for
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as lt
from repro_torch.launch.hlo_cost import Census, analyze
from repro_torch.models import build
from repro_torch.models.weights import leaf_groups
from repro_torch.train import OptimizerConfig, init_state, make_train_step

META = torch.device("meta")


# --- the census on programs of known cost -----------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_matmul_flops(device):
    x = torch.zeros((64, 128), device=device)
    w = torch.zeros((128, 256), device=device)
    res = analyze(lambda a, b: a @ b, x, w)
    assert res["flops"] == 2 * 64 * 128 * 256
    assert res["dot_bytes"] == 4 * (64 * 128 + 128 * 256 + 64 * 256)
    assert res["num_computations"] == 1 and res["collective_bytes"] == 0


def scanned(x, ws):
    for w in ws:
        x = x @ w
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_trips_multiply(device):
    x = torch.zeros((128, 128), device=device)
    ws = torch.zeros((10, 128, 128), device=device)
    res = analyze(scanned, x, ws)
    assert res["flops"] == 2 * 128 ** 3 * 10
    assert not res["unknown_trip_bodies"]


def test_nested_loops_multiply():
    x = torch.zeros((128, 128), device=META)
    ws = torch.zeros((10, 128, 128), device=META)

    def nested(x, ws):
        for _ in range(5):
            x = scanned(x, ws)
        return x
    assert analyze(nested, x, ws)["flops"] == 2 * 128 ** 3 * 10 * 5


def fixpoint(s):
    while torch.max(s) > 1e-3:
        s = (s @ s) * 0.5
    return s


def test_data_dependent_while_flagged():
    """On meta the trip count is unknowable: the body is counted once and
    the read flagged. On real tensors every trip runs and nothing is."""
    res = analyze(fixpoint, torch.zeros((8, 8), device=META))
    assert res["unknown_trip_bodies"] and "fixpoint" in res["unknown_trip_bodies"][0]
    assert res["flops"] == 2 * 8 ** 3
    real = analyze(fixpoint, torch.full((8, 8), 0.1))
    assert not real["unknown_trip_bodies"]
    trips = 0
    s = torch.full((8, 8), 0.1)
    while torch.max(s) > 1e-3:
        s, trips = (s @ s) * 0.5, trips + 1
    assert real["flops"] == 2 * 8 ** 3 * trips and trips > 1


def test_peak_bytes_count_live_tensors():
    x = torch.zeros((256, 256), device=META)

    def two_temps(x):
        a = x @ x            # 256 KiB
        b = a @ x            # 256 KiB more while a lives
        del a
        return b @ x
    res = analyze(two_temps, x)
    assert res["argument_bytes"] == 256 * 256 * 4
    assert res["peak_bytes"] == 3 * 256 * 256 * 4


def smoke_step(name, microbatches=2, impl="ref", rows=4, seq=16):
    cfg = dataclasses.replace(configs.ARCHS[name].smoke(), dtype="float32")
    model = build(cfg, device="cpu")
    state = init_state(model)
    step = make_train_step(model, OptimizerConfig(), microbatches=microbatches, impl=impl)
    dc = lt.data_config(cfg, seq, rows)
    return step, state, lt.batch_for(cfg, dc, 0, "cpu")


@pytest.mark.parametrize("name", ["qwen2.5-3b", "deepseek-moe-16b", "zamba2-1.2b",
                                  "xlstm-1.3b", "seamless-m4t-large-v2"])
def test_census_flops_equal_flop_counter_mode(name):
    """Both modes over one step: the census's FLOPs are FlopCounterMode's."""
    step, state, batch = smoke_step(name)
    census = Census()
    with FlopCounterMode(display=False) as fc, census:
        step(state, batch)
    assert census.flops == fc.get_total_flops() > 0


def test_collective_bytes_on_a_fake_world():
    with dryrun.fake_world(4):
        mesh = lt.make_mesh("2,2", device="meta")
        x = torch.zeros((8, 16), dtype=torch.bfloat16, device=META)

        def exchange(x):
            parts = [torch.empty_like(x) for _ in range(2)]
            tdist.all_gather(parts, x, group=mesh.axis("data").group)
            y = torch.cat(parts)
            tdist.all_reduce(y, group=mesh.axis("model").group)
            out = torch.empty((4, 16), dtype=torch.bfloat16, device=META)
            tdist.reduce_scatter_tensor(out, x, group=mesh.axis("data").group)
            return y, out
        census = Census([x])
        with census:
            exchange(x)
        assert roofline.collective_bytes(exchange, x) == census.collective_bytes
    assert not tdist.is_initialized()
    gathered, summed, scattered = 2 * 8 * 16 * 2, 16 * 16 * 2, 4 * 16 * 2
    assert census.collective_bytes == gathered + summed + scattered
    rows = {op: (n, b) for b, n, op, _ in census.breakdown()}
    assert rows["c10d.allgather_"] == (1, gathered)
    assert rows["c10d.allreduce_"] == (1, summed)
    assert len(rows) == 3


def test_dry_run_scaling_equals_the_whole_steps_census():
    """The dry run counts two microbatches and scales the dot counts to all
    of them; the census of the whole step, every microbatch run, on the
    same (2, 2) fake world, gives the same FLOPs, dot bytes and collective
    bytes."""
    cfg = dataclasses.replace(configs.ARCHS["qwen2.5-3b"].smoke(), n_layers=2)
    with dryrun.fake_world(4):
        mesh = lt.make_mesh("2,2", device="meta")
        rec = dryrun.train_census(cfg, seq=32, global_batch=16, microbatches=4,
                                  impl="ref", mesh=mesh)
        model = build(cfg, device=META)
        state = lt.shard(init_state(model), mesh, 16)
        step = make_train_step(model, OptimizerConfig(total_steps=10_000), microbatches=4,
                               impl="ref")
        whole = analyze(step, state, dryrun.input_specs(cfg, "train", 8, 32))
    assert rec["census"]["microbatches_run"] == 2 and rec["census"]["rows"] == 8
    for k in ("flops", "dot_bytes", "collective_bytes"):
        assert rec[k] == whole[k] > 0, k
    assert rec["held_bytes"] == sh.held_bytes(state)


# --- roofline ------------------------------------------------------------------

def test_roofline_terms_and_bottleneck():
    rec = {"flops": 9.89e14, "dot_bytes": 3.35e12, "collective_bytes": 4.5e11,
           "num_devices": 256}
    t = roofline.terms(rec)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    rec["flops"] = 2e15
    assert roofline.terms(rec)["bottleneck"] == "compute"
    assert roofline.terms(rec)["step_lower_bound_s"] == pytest.approx(2e15 / 989e12)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == (989e12, 3.35e12, 450e9)


CELLS = [(name, cell.name) for name, cfg in configs.ARCHS.items()
         for cell in shape_cells_for(cfg)]


@pytest.mark.parametrize("name,shape", CELLS)
def test_param_count_and_model_flops_match_reference(name, shape):
    cfg, ref = configs.ARCHS[name], ref_configs.ARCHS[name]
    cell = next(c for c in shape_cells_for(cfg) if c.name == shape)
    ref_cell = next(c for c in ref_cells(ref) if c.name == shape)
    for active in (False, True):
        assert roofline.param_count(cfg, active) == ref_roofline.param_count(ref, active)
    assert roofline.model_flops(cfg, cell) == ref_roofline.model_flops(ref, ref_cell)
    rec = {"flops": 3e14, "dot_bytes": 2e12, "collective_bytes": 1e9}
    got, want = roofline.summarize(rec, cfg, cell), ref_roofline.summarize(rec, ref, ref_cell)
    assert got["model_flops"] == want["model_flops"]
    assert got["useful_fraction"] == want["useful_fraction"]


# --- the abstract build and the dry run --------------------------------------

def stacked_shapes(model) -> dict:
    """The port's parameters as the reference's leaves: key path → (shape
    with the [L] axis of a stack, dtype name)."""
    params = dict(model.net.named_parameters())
    out = {}
    for path, members in leaf_groups(params).items():
        p = params[members[0][0]]
        lead = (len(members),) if members[0][1] is not None else ()
        out[path] = (lead + tuple(p.shape), str(p.dtype).removeprefix("torch."))
    return out


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_abstract_build_matches_eval_shape(name):
    model = build(configs.ARCHS[name], device="meta")
    tensors = list(model.parameters()) + list(model.buffers())
    assert tensors and all(t.device.type == "meta" for t in tensors)
    shapes = jax.eval_shape(ref_build(ref_configs.ARCHS[name]).init, jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert stacked_shapes(model) == want


class Devices(TorchDispatchMode):
    """Every device an op of the run wrote a tensor to."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree_util.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


def short_cells(cfg):
    """The cells of `cfg` at 512 tokens."""
    return tuple(dataclasses.replace(c, seq_len=512) for c in shape_cells_for(cfg))


@pytest.fixture(scope="module")
def smoke_cell(tmp_path_factory):
    """One dry-run cell at smoke size: qwen2.5-3b's smoke config at 2
    layers in the train_4k cell cut to 512 tokens (its global batch of
    256 kept), on the 16x16 fake mesh."""
    out = tmp_path_factory.mktemp("launch_out")
    cfg = dataclasses.replace(configs.ARCHS["qwen2.5-3b"].smoke(), n_layers=2)
    devices = Devices()
    with mock.patch.dict(configs.ARCHS, {"qwen2.5-3b": cfg}), \
            mock.patch.object(dryrun, "shape_cells_for", short_cells), \
            mock.patch.object(report, "shape_cells_for", short_cells), devices:
        rec = dryrun.run_cell("qwen2.5-3b", "train_4k", False, str(out))
        table = report.render_table(str(out))
    return out, rec, table, devices.seen


def test_dry_run_cell_allocates_nothing(smoke_cell):
    out, rec, _, seen = smoke_cell
    assert seen == {"meta"}
    assert not tdist.is_initialized()
    with open(out / "qwen2.5-3b__train_4k__16x16.json") as f:
        saved = json.load(f)
    for key in ("arch", "shape", "mesh", "kind", "lower_s", "compile_s", "flops", "dot_bytes",
                "collective_bytes", "unknown_trip_bodies", "xla_cost_flops_bodies_once",
                "xla_bytes_accessed_bodies_once", "memory", "num_devices", "roofline"):
        assert key in saved, key
    assert set(saved["memory"]) == {"temp_size_in_bytes", "argument_size_in_bytes",
                                    "output_size_in_bytes", "generated_code_size_in_bytes"}
    assert saved["num_devices"] == 256 and saved["kind"] == "train"
    assert saved["flops"] > 0 and saved["collective_bytes"] > 0
    assert saved["census"]["rows"] == 16 and saved["census"]["microbatches"] == 16
    assert saved["memory"]["temp_size_in_bytes"] > 0
    assert saved["memory"]["argument_size_in_bytes"] > saved["held_bytes"] > 0
    assert saved["roofline"] == roofline.terms(rec)


def test_report_renders_the_dry_runs_record(smoke_cell):
    _, rec, table, _ = smoke_cell
    lines = table.splitlines()
    row = next(line for line in lines if line.startswith("| qwen2.5-3b | train_4k |"))
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[2] == f"{rec['roofline']['compute_s']:.3f}"
    assert cells[5] == rec["roofline"]["bottleneck"] and cells[8] == "Y"
    assert sum("MISSING" in line for line in lines) == len(CELLS) - 1
    assert report.CARD_BYTES == 81_559 * 2 ** 20
