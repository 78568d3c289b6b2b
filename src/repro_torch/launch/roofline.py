"""Roofline analysis from the dry run's census.

PyTorch counterpart of `repro.launch.roofline`. Three terms per (arch ×
shape × mesh), all in seconds, for one card:

    compute    = census FLOPs / 989e12          # bf16 dense peak, H100 SXM
    memory     = census dot bytes / 3.35e12     # HBM3
    collective = census collective bytes / 450e9 # NVLink 4, one direction

Every number of the census is per rank (`launch.hlo_cost` counts what this
process dispatches; in SPMD every rank runs the same program), so no term
divides by the card count.

Sources of the constants: NVIDIA's H100 data sheet, SXM part, dense rates
without sparsity — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 1,979 TOP/s int8, 3.35 TB/s of HBM3 — at the full 700 W
power limit (a card set lower runs slower); NVLink 4 gives an H100 18
links of 25 GB/s each way, 450 GB/s each way (900 GB/s both ways). The
collective term assumes every byte crosses NVLink: that holds inside one
node of 8 cards. At 256 cards most bytes cross nodes over InfiniBand,
whose rate depends on the cluster (a 400 Gb/s NIC a card moves 50 GB/s),
so there the term is a lower bound.

MODEL_FLOPS (6·N·D dense, 6·N_active·D MoE) over the census FLOPs is the
share of the counted compute that is "useful" (it catches remat's
recompute and the attention's own products).
"""
from __future__ import annotations

from .hlo_cost import analyze

# H100 SXM, per card (see the module docstring)
PEAK_FLOPS = 989e12          # bf16 on the tensor cores, dense
F32_FLOPS = 67e12            # f32 outside the tensor cores
INT8_OPS = 1979e12           # int8 on the tensor cores, dense
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s, one direction (18 links x 25 GB/s)


def collective_bytes(fn, *args, **kwargs) -> int:
    """Sum of output-shape bytes of every collective `fn(*args, **kwargs)`
    dispatches (the census of `launch.hlo_cost`; a consistent census for
    comparing schedules, not an exact wire-byte count)."""
    return analyze(fn, *args, **kwargs)["collective_bytes"]


def model_flops(cfg, cell) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE); D = tokens processed."""
    n = param_count(cfg, active_only=True)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens          # forward only
    tokens = cell.global_batch           # one token per sequence
    return 2.0 * n * tokens


def param_count(cfg, active_only=False) -> float:
    """Analytic parameter count from the config."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    hd = cfg.hd
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    if cfg.family in ("dense",):
        per_layer = attn + 3 * d * ff
        layers = cfg.n_layers * per_layer
    elif cfg.family == "moe":
        e_used = cfg.moe_top_k if active_only else cfg.n_experts
        shared = 3 * d * ff * cfg.n_shared_experts
        per_layer = attn + 3 * d * ff * e_used + shared + d * cfg.n_experts
        layers = cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        n, p = cfg.ssm_state, cfg.ssm_head_dim
        mamba = d * (2 * d + 2 * n + d // p) + d * d
        layers = cfg.n_layers * mamba + (attn + 3 * d * ff)   # + shared attn block
    elif cfg.family == "ssm":
        mlstm = 3 * d * cfg.n_heads * hd + 2 * d * cfg.n_heads + \
            d * cfg.n_heads * hd + cfg.n_heads * hd * d
        layers = cfg.n_layers * mlstm
    elif cfg.family == "encdec":
        enc = cfg.n_enc_layers * (attn + 3 * d * ff)
        dec = cfg.n_dec_layers * (2 * attn + 3 * d * ff)
        layers = enc + dec
    else:
        layers = 0
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    return float(layers + embed)


def terms(rec: dict) -> dict:
    """rec carries PER-RANK census numbers, so no further division by the
    card count."""
    compute = rec["flops"] / PEAK_FLOPS
    memory = rec.get("dot_bytes", 0.0) / HBM_BW
    coll = rec["collective_bytes"] / NVLINK_BW
    dom = max((compute, "compute"), (memory, "memory"), (coll, "collective"))
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "bottleneck": dom[1],
        "step_lower_bound_s": max(compute, memory, coll),
    }


def summarize(rec: dict, cfg=None, cell=None) -> dict:
    t = terms(rec)
    if cfg is not None and cell is not None:
        mf = model_flops(cfg, cell)
        t["model_flops"] = mf
        t["useful_fraction"] = mf / rec["flops"] if rec["flops"] else 0.0
    return t
