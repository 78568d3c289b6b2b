"""Multi-pod dry run: every (arch × shape × mesh) cell, abstractly.

PyTorch counterpart of `repro.launch.dryrun`. For each cell it brings up an
in-process fake process group of 256 (512) ranks at rank 0 (torch's
`FakeStore` and its "fake" backend, whose collectives return at once and
move nothing), builds the model on the meta device
(`models.build(cfg, device="meta")`, the counterpart of
`jax.eval_shape(model.init)`), places the state by `launch.sharding`'s
specs on `make_production_mesh`, and runs the cell's program once on meta
under the census of `launch.hlo_cost`: nothing is allocated and nothing
launches on any device. It records the census (dot FLOPs, dot bytes,
collective bytes; per rank), the memory a rank holds and its peak, and the
roofline terms. Output: one JSON per cell under launch_out/, with the
reference's keys (those of XLA's own cost analysis, and the generated code
size, are null), so `launch.report` reads the records of either package.

The programs are the port's own, as a rank of it runs them, on the plan
the layout gives the model (`Layout.plan_for`; the record's "plan"):

  * train   — `make_train_step(..., impl="chunked", remat=True)` on this
              rank's rows of the global batch in `_microbatches`
              microbatches. The census runs two microbatches (one where
              the cell has one) and scales the dot FLOPs and bytes to all
              of them: every microbatch has the same shapes, and nothing
              outside them multiplies matrices. On the "gathered" plan the
              collectives run once a step (the gathers at its start, the
              gradients' reduce-scatter and the norm's all-reduce at its
              end) and are not scaled. On the "split" plan (every family)
              each microbatch gathers
              every layer over "data" (one all-gather a layer and dtype,
              twice under remat), reduces its heads', ff columns',
              experts' and channels' products over "model" and
              reduce-scatters its gradients, so
              a cell of more than two microbatches is also counted with
              one: the difference is one microbatch's collectives, and the
              rest runs once a step;
  * prefill — the forward with `last_only` over this rank's rows
              (`impl="chunked"`): on the split plan its heads, ff columns
              (or experts, or recurrent heads and channels) and vocab
              block, each layer gathered over "data" as it runs; on the
              gathered plan the parameters gathered whole first;
  * decode  — one `decode_step` of this rank's rows against
              `init_cache` of them: on the split plan its heads, ff
              columns (or experts, or recurrent heads and channels) and
              vocab block, each layer gathered over "data" as it runs,
              and its block of the cache (the KV sequence over "model",
              as `sharding.cache_specs` splits it; a recurrent state's
              heads or channels; the enc-dec family's encoder output, its
              block of the encoder sequence); on the gathered plan the
              parameters gathered whole first and the whole sequence.

On the split plan a rank holds one layer whole at most (its block of the
experts, in an MoE layer; a Mamba2 layer's in_proj and conv_w, an sLSTM
layer's wo), and computes its share of the heads, ff columns, experts,
recurrent channels and vocab; on the gathered plan (no family's by
default: `Layout._plan = "gathered"`, to compare the two) every parameter
is in its peak and its collective bytes, and the "model" ranks repeat one
another's work. The kernels of
the port launch through ctypes and are invisible to the census, so every
program runs the plain "chunked" attention, as the reference's dry run
does.

Two knobs of the reference's dry run: REPRO_MICROBATCHES=<n> sets a train
cell's microbatches (`_microbatches`); REPRO_ATTN_SHARD=seq builds every
split plan with the sequence split (`launch.sharding.SplitPlan.seq_rows`:
a rank's attention runs its S/m rows of the sequence, every head, over
K and V gathered once a layer), and the census then counts the last
"model" rank (`counted_rank`), whose causal prefix is the whole sequence;
the record names the mode ("attn_shard") and the rank ("counted_rank").
With neither set, every record is as before.

Memory, per rank: `argument_size_in_bytes` is what the rank holds when the
program starts — its blocks of the parameters and of m and v
(`sharding.held_bytes`), its inputs and, for decode, its cache;
`temp_size_in_bytes` is the most bytes of tensors live at once during the
program above those; `output_size_in_bytes` the bytes of what the program
returns that it did not take in.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--arch ... --shape ...]
    REPRO_ATTN_SHARD=seq python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b
    REPRO_MICROBATCHES=4 python -m repro_torch.launch.dryrun --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as tdist

from ..configs import ARCHS
from ..configs.base import ShapeCell, shape_cells_for
from ..models import build
from ..train import OptimizerConfig, init_state, make_train_step
from . import hlo_cost, roofline
from . import sharding as sh
from .mesh import effective_batch_axes, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "launch_out")
META = torch.device("meta")
COUNTED_MICROBATCHES = 2


def _microbatches(cell: ShapeCell, data_shards: int) -> int:
    """One sequence per microbatch per data shard (activation and MoE
    dispatch memory); REPRO_MICROBATCHES, where set, overrides it (the
    reference's knob)."""
    if os.environ.get("REPRO_MICROBATCHES"):
        return int(os.environ["REPRO_MICROBATCHES"])
    return max(cell.global_batch // data_shards, 1)


def counted_rank(model_ranks: int) -> int:
    """The rank whose program the census counts: rank 0, or under the
    sequence split (REPRO_ATTN_SHARD=seq) the last "model" rank of the
    first "data" block, rank m - 1 of the row-major mesh, whose causal
    attention runs over the whole sequence (rank 0's over its first S/m
    slots: the least work)."""
    if os.environ.get("REPRO_ATTN_SHARD") == "seq":
        return model_ranks - 1
    return 0


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """An in-process fake process group of `size` ranks, this process `rank`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def input_specs(cfg, kind: str, rows: int, seq: int) -> dict:
    """Meta stand-ins of a program's inputs, as `launch.train.batch_for`
    gives them: int64 tokens (and labels to train), f32 frame embeddings
    for the stub frontends."""
    def tok():
        return torch.empty((rows, seq), dtype=torch.int64, device=META)
    batch = {"tokens": tok()}
    if kind == "train":
        batch["labels"] = tok()
    if cfg.input_kind == "embeddings" or cfg.family == "encdec":
        batch["embeds"] = torch.empty((rows, seq, cfg.d_model), dtype=torch.float32,
                                      device=META)
    return batch


def _layout(params, mesh, global_batch):
    """The layout of `params` on `mesh` by the reference's specs."""
    specs = sh.param_specs(params, dict(mesh.shape))
    return sh.named(mesh, specs, effective_batch_axes(mesh, global_batch))


def _census(fn, arguments) -> dict:
    """The census of `fn()` and the memory record of the run."""
    census = hlo_cost.Census(arguments)
    # weak: an argument freed in the run gives its address to a new tensor
    taken = [weakref.ref(t.untyped_storage()) for t in hlo_cost.tensors(arguments)]
    t0 = time.perf_counter()
    with census:
        out = fn()
    taken = {st._cdata for st in (r() for r in taken) if st is not None}
    rec = census.result()
    rec["census_s"] = time.perf_counter() - t0
    rec["memory"] = {
        "argument_size_in_bytes": census.argument_bytes,
        "temp_size_in_bytes": census.peak_bytes - census.argument_bytes,
        "output_size_in_bytes": sum(t.numel() * t.element_size()
                                    for t in hlo_cost.tensors(out)
                                    if t.untyped_storage()._cdata not in taken),
        "generated_code_size_in_bytes": None}
    return rec


def train_census(cfg, *, seq: int, global_batch: int, microbatches: int,
                 impl: str = "chunked", mesh=None) -> dict:
    """The census of one train step of `cfg` on meta: this rank's rows of
    a `global_batch` × `seq` batch (all of it without a mesh) in
    `microbatches` microbatches, remat on; two microbatches are run and
    the dot counts scaled to all of them (on the split plan the
    collectives too)."""
    rows = global_batch
    if mesh is not None:
        rows //= math.prod(mesh.shape[a] for a in effective_batch_axes(mesh, global_batch))
    if rows % microbatches:
        raise ValueError(f"{rows} rows a rank do not split into {microbatches} microbatches")
    counted = min(microbatches, COUNTED_MICROBATCHES)

    def step_census(run):
        """The census of a step that runs `run` of the microbatches."""
        model = build(cfg, device=META)
        state = init_state(model)
        if mesh is not None:
            state = sh.place(state, _layout(state.params, mesh, global_batch))
        batch = input_specs(cfg, "train", rows // microbatches * run, seq)
        step = make_train_step(model, OptimizerConfig(total_steps=10_000),
                               microbatches=run, impl=impl, remat=True)
        arguments = [list(state.params.values()), state.opt["m"], state.opt["v"], batch]
        return state, _census(lambda: step(state, batch)[1], arguments)

    state, rec = step_census(counted)
    ran = state.layout.plan_for(cfg) if mesh is not None else None
    held = sh.held_bytes(state)
    rec["memory"]["argument_size_in_bytes"] = held + hlo_cost.nbytes(
        input_specs(cfg, "train", rows, seq))                # the whole step's inputs
    rec["flops"] = rec["flops"] // counted * microbatches
    rec["dot_bytes"] = rec["dot_bytes"] // counted * microbatches
    scaled = "dot FLOPs and bytes x microbatches / microbatches_run"
    if ran == "split" and microbatches > counted:
        one = step_census(1)[1]["collective_bytes"]
        each = rec["collective_bytes"] - one
        rec["collective_bytes"] = one + each * (microbatches - 1)
        scaled += ("; collective bytes: one microbatch's (the 2-microbatch run's less "
                   "the 1-microbatch run's) x microbatches, plus the rest")
    rec.update(held_bytes=held, plan=ran,
               census={"microbatches": microbatches, "microbatches_run": counted,
                       "rows": rows, "seq": seq, "impl": impl, "remat": True,
                       "scaled": scaled})
    return rec


def serve_census(cfg, cell: ShapeCell, mesh) -> dict:
    """The census of a prefill or one decode step of `cell` on meta, this
    rank's rows: on the split plan the rank's blocks (of the cache too),
    on the gathered plan the parameters gathered whole first."""
    model = build(cfg, device=META)
    params = dict(model.net.named_parameters())
    layout = _layout(params, mesh, cell.global_batch)
    ran = sh.place_model(model, layout)
    rows = cell.global_batch // layout.batch_shards
    held = sum(p.numel() * p.element_size() for p in params.values())
    if cell.kind == "prefill":
        batch = input_specs(cfg, "prefill", rows, cell.seq_len)

        def program():
            if ran == "gathered":
                layout.gather_params(params)
            return model(batch, impl="chunked", remat=True, last_only=True)[0]
        arguments = [list(params.values()), batch]
    else:
        kw = {"enc_len": cell.seq_len} if cfg.family == "encdec" else {}
        cache = model.init_cache(rows, cell.seq_len, **kw)
        tok = torch.empty((rows, 1), dtype=torch.int64, device=META)

        def program():
            if ran == "gathered":
                layout.gather_params(params)
            return model.decode_step(tok, cache, cell.seq_len - 1)
        arguments = [list(params.values()), tok, cache]
    with torch.no_grad():
        rec = _census(program, arguments)
    rec.update(held_bytes=held, plan=ran,
               census={"rows": rows, "seq": cell.seq_len,
                       "impl": "chunked" if cell.kind == "prefill" else None})
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = OUT_DIR):
    cfg = ARCHS[arch]
    cell = next(c for c in shape_cells_for(cfg) if c.name == shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    world = 512 if multi_pod else 256
    rank = counted_rank(16)          # make_production_mesh's "model" axis, the last
    t0 = time.perf_counter()
    with fake_world(world, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device=META)
        if cell.kind == "train":
            data_shards = math.prod(mesh.shape[a] for a in
                                    effective_batch_axes(mesh, cell.global_batch))
            rec = train_census(cfg, seq=cell.seq_len, global_batch=cell.global_batch,
                               microbatches=_microbatches(cell, data_shards), mesh=mesh)
        else:
            rec = serve_census(cfg, cell, mesh)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "kind": cell.kind,
           "lower_s": time.perf_counter() - t0 - rec["census_s"], "compile_s": None,
           **rec, "xla_cost_flops_bodies_once": None, "xla_bytes_accessed_bodies_once": None,
           "num_devices": world}
    if os.environ.get("REPRO_ATTN_SHARD") == "seq":
        rec.update(attn_shard="seq", counted_rank={"rank": rank, "model": rank, "data": 0})
    rec["roofline"] = roofline.terms(rec)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    r, mem = rec["roofline"], rec["memory"]
    print(f"[dryrun] {arch} × {shape} × {mesh_name}: census {rec['census_s']:.0f}s | "
          f"flops/dev {rec['flops']:.3e} | "
          f"args/dev {mem['argument_size_in_bytes'] / 2**30:.2f} GiB | "
          f"temp/dev {mem['temp_size_in_bytes'] / 2**30:.2f} GiB | "
          f"coll/dev {rec['collective_bytes'] / 2**30:.3f} GiB | plan {rec['plan']} | "
          f"bottleneck {r['bottleneck']} ({r['step_lower_bound_s'] * 1e3:.1f} ms)",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name a cell (--arch and/or --shape) or pass --all")

    cells = []
    for arch, cfg in ARCHS.items():
        if args.arch and arch != args.arch:
            continue
        for cell in shape_cells_for(cfg):
            if args.shape and cell.name != args.shape:
                continue
            cells.append((arch, cell.name))
    ok = fail = 0
    for arch, shape in cells:
        try:
            run_cell(arch, shape, args.multi_pod, args.out)
            ok += 1
        except Exception:
            fail += 1
            print(f"[dryrun] FAIL {arch} × {shape}", file=sys.stderr)
            traceback.print_exc()
    print(f"[dryrun] done: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
