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

The programs are the port's own, as a rank of it runs them:

  * train   — `make_train_step(..., impl="chunked", remat=True)` on this
              rank's rows of the global batch in `_microbatches`
              microbatches. The census runs two microbatches (one where
              the cell has one) and scales the dot FLOPs and bytes to all
              of them: every microbatch has the same shapes, and nothing
              outside them multiplies matrices. Collectives run once a
              step (the gathers at its start, the gradients' reduce-scatter
              and the norm's all-reduce at its end), so they are not scaled;
  * prefill — the parameters gathered whole, then the forward with
              `last_only` over this rank's rows (`impl="chunked"`);
  * decode  — the parameters gathered whole, then one `decode_step` of this
              rank's rows against `init_cache` of them.

The dry run shows what the port's sharding does: each rank gathers every
parameter whole before it computes (ROADMAP T2), so the gathers are in
its collective bytes and the whole parameters in its peak. The kernels of
the port launch through ctypes and are invisible to the census, so every
program runs the plain "chunked" attention, as the reference's dry run
does.

Memory, per rank: `argument_size_in_bytes` is what the rank holds when the
program starts — its blocks of the parameters and of m and v
(`sharding.held_bytes`), its inputs and, for decode, its cache;
`temp_size_in_bytes` is the most bytes of tensors live at once during the
program above those; `output_size_in_bytes` the bytes of what the program
returns that it did not take in.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--arch ... --shape ...]
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
    dispatch memory)."""
    return max(cell.global_batch // data_shards, 1)


@contextlib.contextmanager
def fake_world(size: int):
    """An in-process fake process group of `size` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
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
    the dot counts scaled to all of them."""
    model = build(cfg, device=META)
    state = init_state(model)
    rows = global_batch
    if mesh is not None:
        state = sh.place(state, _layout(state.params, mesh, global_batch))
        rows //= state.layout.batch_shards
    if rows % microbatches:
        raise ValueError(f"{rows} rows a rank do not split into {microbatches} microbatches")
    counted = min(microbatches, COUNTED_MICROBATCHES)
    batch = input_specs(cfg, "train", rows // microbatches * counted, seq)
    step = make_train_step(model, OptimizerConfig(total_steps=10_000),
                           microbatches=counted, impl=impl, remat=True)
    held = sh.held_bytes(state)
    arguments = [list(state.params.values()), state.opt["m"], state.opt["v"], batch]
    rec = _census(lambda: step(state, batch)[1], arguments)
    rec["memory"]["argument_size_in_bytes"] = held + hlo_cost.nbytes(
        input_specs(cfg, "train", rows, seq))                # the whole step's inputs
    rec["flops"] = rec["flops"] // counted * microbatches
    rec["dot_bytes"] = rec["dot_bytes"] // counted * microbatches
    rec.update(held_bytes=held,
               census={"microbatches": microbatches, "microbatches_run": counted,
                       "rows": rows, "seq": seq, "impl": impl, "remat": True,
                       "scaled": "dot FLOPs and bytes x microbatches / microbatches_run"})
    return rec


def serve_census(cfg, cell: ShapeCell, mesh) -> dict:
    """The census of a prefill or one decode step of `cell` on meta, this
    rank's rows, the parameters gathered whole first."""
    model = build(cfg, device=META)
    params = dict(model.net.named_parameters())
    layout = _layout(params, mesh, cell.global_batch)
    layout.shard_params(params)
    rows = cell.global_batch // layout.batch_shards
    held = sum(p.numel() * p.element_size() for p in params.values())
    if cell.kind == "prefill":
        batch = input_specs(cfg, "prefill", rows, cell.seq_len)

        def program():
            layout.gather_params(params)
            return model(batch, impl="chunked", remat=True, last_only=True)[0]
        arguments = [list(params.values()), batch]
    else:
        kw = {"enc_len": cell.seq_len} if cfg.family == "encdec" else {}
        cache = model.init_cache(rows, cell.seq_len, **kw)
        tok = torch.empty((rows, 1), dtype=torch.int64, device=META)

        def program():
            layout.gather_params(params)
            return model.decode_step(tok, cache, cell.seq_len - 1)
        arguments = [list(params.values()), tok, cache]
    with torch.no_grad():
        rec = _census(program, arguments)
    rec.update(held_bytes=held, census={"rows": rows, "seq": cell.seq_len,
                                        "impl": "chunked" if cell.kind == "prefill" else None})
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = OUT_DIR):
    cfg = ARCHS[arch]
    cell = next(c for c in shape_cells_for(cfg) if c.name == shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    world = 512 if multi_pod else 256
    t0 = time.perf_counter()
    with fake_world(world):
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
          f"coll/dev {rec['collective_bytes'] / 2**30:.3f} GiB | "
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
