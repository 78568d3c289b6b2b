"""The benchmark's own graph generator and CSR builder, on the device.

A Kronecker (R-MAT) edge list is drawn with a `torch.Generator` on the
graph's device, and its eleven CSR fields are built there under the rules
of the port's host builder (`repro_torch.graph.csr.from_edges` with
`drop_self_loops=True`):

* self-loops are dropped;
* of duplicate (src, dst) pairs the first occurrence keeps its weight;
* the forward arrays are in stable (src, dst) order, the reverse arrays in
  (dst, src) order;
* `edge_key` is src * N + dst wrapped to int32.

The edges come from the configuration's own seed and a run's seed draws a
permutation of the vertex ids, so every run does the same work on other
arrays. The port receives the finished fields as its `CSRGraph`; this
module is the yardstick's, so a change to the port's builders cannot move
it.
"""
from __future__ import annotations

import torch

FIELDS = ("indptr", "indices", "weights", "edge_src", "rev_indptr",
          "rev_indices", "rev_weights", "rev_edge_dst", "out_degree",
          "in_degree", "edge_key")


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def kronecker_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
                    weight_lo: int, weight_hi: int, gen: torch.Generator,
                    device):
    """R-MAT edges: one uniform draw per bit picks a quadrant with
    probabilities a, b, c and d = 1 - a - b - c; weights uniform integers
    in [weight_lo, weight_hi]. Returns (n, src int64, dst int64, w int32),
    duplicates and self-loops included."""
    n = 1 << scale
    e = n * edge_factor
    src = torch.zeros(e, dtype=torch.int64, device=device)
    dst = torch.zeros(e, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(e, generator=gen, device=device, dtype=torch.float64)
        go_right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.to(torch.int64) << bit
        dst |= go_right.to(torch.int64) << bit
        del r, go_right, go_down
    w = torch.randint(weight_lo, weight_hi + 1, (e,), generator=gen,
                      device=device, dtype=torch.int32)
    return n, src, dst, w


def _indptr(rows: torch.Tensor, n: int):
    counts = torch.bincount(rows, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr.to(torch.int32), counts.to(torch.int32)


def csr_fields(n: int, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> dict:
    """The eleven CSR fields (int32, on the edges' device) of the graph the
    edge list describes, after dropping self-loops and duplicates."""
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    del keep
    key = src * n + dst
    del src, dst
    key_sorted, order = torch.sort(key, stable=True)
    del key
    first = torch.ones_like(key_sorted, dtype=torch.bool)
    first[1:] = key_sorted[1:] != key_sorted[:-1]
    key_sorted = key_sorted[first]
    w = w[order[first]]
    del order, first
    src = torch.div(key_sorted, n, rounding_mode="floor")
    dst = key_sorted - src * n
    f = {}
    f["indptr"], f["out_degree"] = _indptr(src, n)
    f["indices"] = dst.to(torch.int32)
    f["weights"] = w
    f["edge_src"] = src.to(torch.int32)
    f["edge_key"] = key_sorted.to(torch.int32)
    del key_sorted
    rkey = dst * n + src
    order = torch.argsort(rkey, stable=True)
    del rkey
    f["rev_indptr"], f["in_degree"] = _indptr(dst, n)
    f["rev_indices"] = src[order].to(torch.int32)
    f["rev_weights"] = w[order]
    f["rev_edge_dst"] = dst[order].to(torch.int32)
    return {k: f[k].contiguous() for k in FIELDS}


def build(config: dict, seed: int, device) -> tuple:
    """The configuration's graph, its vertices labelled from `seed`:
    (fields, meta, labels). The edges are drawn from the configuration's
    own `graph.seed`, so every run does the same work; `seed` draws a
    permutation of the vertex ids (labels[v] is the id of generated vertex
    v), so each seed hands the program other arrays. meta has num_nodes,
    num_edges, max_out_degree and max_in_degree."""
    spec = config["graph"]
    if spec["kind"] != "kronecker":
        raise ValueError(f"unknown graph kind {spec['kind']!r}")
    lo, hi = spec["weights"]
    n, src, dst, w = kronecker_edges(config["scale"], spec["edge_factor"], spec["a"],
                                     spec["b"], spec["c"], lo, hi,
                                     generator(spec["seed"], device), device)
    labels = torch.randperm(n, generator=generator(seed, device), device=device)
    src, dst = labels[src], labels[dst]
    fields = csr_fields(n, src, dst, w)
    meta = dict(num_nodes=n, num_edges=int(fields["indices"].shape[0]),
                max_out_degree=max(int(fields["out_degree"].max()), 1),
                max_in_degree=max(int(fields["in_degree"].max()), 1))
    return fields, meta, labels


def digest(fields: dict) -> list:
    """A cheap content check of the inputs: the int64 sum of each field
    weighted by position mod 997, so a write anywhere shows."""
    out = []
    for k in FIELDS:
        t = fields[k].to(torch.int64)
        pos = torch.arange(t.shape[0], device=t.device) % 997 + 1
        out.append(int((t * pos).sum()))
    return out


def to_port(fields: dict, meta: dict):
    """The port's `CSRGraph` over the benchmark's tensors."""
    from repro_torch.graph.csr import CSRGraph
    return CSRGraph(**fields, **meta)
