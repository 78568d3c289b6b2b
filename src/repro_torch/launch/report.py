"""Render the roofline table from launch_out/*.json (the dry run's records).

PyTorch counterpart of `repro.launch.report`; it reads the records of
either package's dry run. A cell fits when a rank's arguments and temps
together stay under one card's memory.
"""
from __future__ import annotations

import glob
import json
import os

from ..configs import ARCHS
from ..configs.base import shape_cells_for
from . import roofline

# the device memory nvidia-smi reports for an NVIDIA H100 80GB HBM3
CARD_BYTES = 81_559 * 2**20


def load_cells(out_dir: str, mesh: str = "16x16"):
    cells = {}
    for path in glob.glob(os.path.join(out_dir, f"*__{mesh}.json")):
        with open(path) as f:
            rec = json.load(f)
        cells[(rec["arch"], rec["shape"])] = rec
    return cells


def render_table(out_dir: str, mesh: str = "16x16") -> str:
    cells = load_cells(out_dir, mesh)
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck |"
        " MODEL_FLOPS | useful frac | fits/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, cfg in ARCHS.items():
        for cell in shape_cells_for(cfg):
            rec = cells.get((arch, cell.name))
            if rec is None:
                lines.append(f"| {arch} | {cell.name} | — | — | — | MISSING | | | |")
                continue
            t = rec["roofline"]
            mf = roofline.model_flops(cfg, cell) / rec["num_devices"]
            useful = mf / rec["flops"] if rec["flops"] else 0.0
            held = (rec["memory"]["temp_size_in_bytes"] or 0) \
                + (rec["memory"]["argument_size_in_bytes"] or 0)
            fits = "Y" if held < CARD_BYTES else f"N({held / 2**30:.0f}G)"
            lines.append(
                f"| {arch} | {cell.name} | {t['compute_s']:.3f} | "
                f"{t['memory_s']:.3f} | {t['collective_s']:.3f} | "
                f"{t['bottleneck']} | {mf:.2e} | {useful:.2f} | {fits} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="launch_out")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    print(render_table(args.out, args.mesh))


if __name__ == "__main__":
    main()
