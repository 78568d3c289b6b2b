"""The dry run's two knobs of the reference's (`launch.dryrun`):
REPRO_ATTN_SHARD=seq (every split plan with the sequence split, the census
of the last "model" rank, the record naming both) and
REPRO_MICROBATCHES=<n> (a train cell's microbatches). With neither set the
records are as before.

The cells are qwen2.5-3b's smoke config at 2 layers in its prefill_32k and
train_4k cells cut to 512 tokens (their global batches kept), on the fake
16x16 mesh of 256 ranks, as tests/test_torch_roofline.py's smoke cell.
"""
import dataclasses
import json
from unittest import mock

import pytest

from repro_torch import configs
from repro_torch.configs.base import shape_cells_for
from repro_torch.launch import dryrun
from repro_torch.models import attention

ARCH = "qwen2.5-3b"
SEQ = 512
TIMING = ("lower_s", "census_s")        # host seconds: the one part of a record that varies


def short_cells(cfg):
    """The cells of `cfg` at SEQ tokens."""
    return tuple(dataclasses.replace(c, seq_len=SEQ) for c in shape_cells_for(cfg))


def cfg_of():
    return dataclasses.replace(configs.ARCHS[ARCH].smoke(), n_layers=2)


def run(shape, out, attention_flops=None):
    """`run_cell` of ARCH's `shape` at SEQ tokens into `out`; with
    `attention_flops` (a list) each `chunked_attention` call's dot FLOPs
    (4 · B · H · SQ · SKV · D) are appended to it."""
    calls = []
    plain = attention.chunked_attention

    def counted(q, k, v, **kw):
        b, h, sq, d = q.shape
        calls.append(4 * b * h * sq * k.shape[2] * d)
        return plain(q, k, v, **kw)
    with mock.patch.dict(configs.ARCHS, {ARCH: cfg_of()}), \
            mock.patch.object(dryrun, "shape_cells_for", short_cells), \
            mock.patch.object(attention, "chunked_attention", counted):
        rec = dryrun.run_cell(ARCH, shape, False, str(out))
    if attention_flops is not None:
        attention_flops.extend(calls)
    with open(out / f"{ARCH}__{shape}__16x16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    return rec


def without_timing(rec):
    return {k: v for k, v in rec.items() if k not in TIMING}


def test_seq_counts_the_last_model_rank(monkeypatch, tmp_path):
    """Under REPRO_ATTN_SHARD=seq the prefill cell's record names the mode
    and the counted rank, rank 15 of the 16x16 mesh ("model" rank m - 1 =
    15 of the first "data" block), and its attention dot FLOPs are that
    rank's: in each of the L layers its n = S/m = 32 rows of every head
    over its causal prefix of P = (r + 1)·n = 512 slots, QK and PV each
    2·b·H·n·P·D, with b = 32 / 16 = 2 rows a "data" rank, H = 4, D = 32:
    L · 4·b·H·n·P·D. The head split's census (the mode unset, rank 0)
    runs every head over all S² pairs: 4·b·H·S·S·D a layer (4 heads do
    not split over 16 ranks)."""
    cfg = cfg_of()
    b, h, d, m = 32 // 16, cfg.n_heads, cfg.hd, 16
    n = SEQ // m
    seq_flops, head_flops = [], []
    monkeypatch.setenv("REPRO_ATTN_SHARD", "seq")
    rec = run("prefill_32k", tmp_path, seq_flops)
    assert rec["attn_shard"] == "seq"
    assert rec["counted_rank"] == {"rank": m - 1, "model": m - 1, "data": 0}
    assert rec["plan"] == "split" and rec["flops"] > 0
    assert seq_flops == [4 * b * h * n * (m * n) * d] * cfg.n_layers
    monkeypatch.delenv("REPRO_ATTN_SHARD")
    base = run("prefill_32k", tmp_path, head_flops)
    assert "attn_shard" not in base and "counted_rank" not in base
    assert head_flops == [4 * b * h * SEQ * SEQ * d] * cfg.n_layers


def test_counted_rank_follows_the_mode(monkeypatch):
    """Rank 0 unless the mode is "seq"; then the last of `model_ranks`."""
    monkeypatch.delenv("REPRO_ATTN_SHARD", raising=False)
    assert dryrun.counted_rank(16) == 0
    monkeypatch.setenv("REPRO_ATTN_SHARD", "heads")
    assert dryrun.counted_rank(16) == 0
    monkeypatch.setenv("REPRO_ATTN_SHARD", "seq")
    assert dryrun.counted_rank(16) == 15 and dryrun.counted_rank(4) == 3


@pytest.mark.parametrize("setting,want", [(None, 16), ("4", 4), ("", 16), ("1", 1)])
def test_microbatches_knob(monkeypatch, setting, want):
    """REPRO_MICROBATCHES overrides one sequence per microbatch per data
    shard (train_4k: 256 rows over 16 data shards); unset or empty, the
    default."""
    if setting is None:
        monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    else:
        monkeypatch.setenv("REPRO_MICROBATCHES", setting)
    cell = next(c for c in shape_cells_for(configs.ARCHS[ARCH]) if c.name == "train_4k")
    assert dryrun._microbatches(cell, 16) == want


def test_microbatches_knob_reaches_the_record(monkeypatch, tmp_path):
    """REPRO_MICROBATCHES=4: the train cell's record runs 4 microbatches
    of its 16 rows a rank (counting 2), and names no sequence split."""
    monkeypatch.delenv("REPRO_ATTN_SHARD", raising=False)
    monkeypatch.setenv("REPRO_MICROBATCHES", "4")
    rec = run("train_4k", tmp_path)
    assert rec["census"]["microbatches"] == 4 and rec["census"]["rows"] == 16
    assert rec["census"]["microbatches_run"] == 2
    assert "attn_shard" not in rec and "counted_rank" not in rec


def test_unset_knobs_leave_the_records(monkeypatch, tmp_path):
    """With neither knob set, or the mode at a value other than "seq", the
    record is the same, timings aside, with the keys of every earlier
    record."""
    monkeypatch.delenv("REPRO_MICROBATCHES", raising=False)
    monkeypatch.delenv("REPRO_ATTN_SHARD", raising=False)
    unset = run("prefill_32k", tmp_path)
    monkeypatch.setenv("REPRO_ATTN_SHARD", "heads")
    other = run("prefill_32k", tmp_path)
    assert without_timing(unset) == without_timing(other)
    assert set(unset) == {"arch", "shape", "mesh", "kind", "lower_s", "compile_s", "flops",
                          "dot_bytes", "collective_bytes", "unknown_trip_bodies",
                          "num_computations", "collective_breakdown", "census_s", "memory",
                          "held_bytes", "plan", "census", "xla_cost_flops_bodies_once",
                          "xla_bytes_accessed_bodies_once", "num_devices", "roofline"}
