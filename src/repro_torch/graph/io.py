"""Edge-list I/O — the paper's graph loader (§3.1) reads edge lists into CSR.

PyTorch counterpart of `repro.graph.io`: the same text format (a `# nodes=
edges=` header, then one `src dst weight` line per edge in CSR order), so a
file written by either package loads to the same CSR arrays in the other,
and the port writes byte for byte what the reference writes. The writer
turns the integers into decimal text in numpy, a column at a time, instead
of the reference's Python loop over edges.

As the reference's loader, `load_edgelist` takes the node count from the
largest id it reads and ignores the header: a graph whose highest-numbered
vertices have no edge comes back with fewer nodes.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and line[0] not in "#%":
                yield line.split()


def load_edgelist(path: str, *, undirected: bool = False,
                  weighted: bool | None = None, device=None) -> CSRGraph:
    """Load `src dst [weight]` lines (comments start with # or %) into a
    CSRGraph on `device` (None: the card). A weight is read as a float and
    truncated to an integer; the graph is weighted when every line has one
    (or as `weighted` says)."""
    rows = list(_data_lines(path))
    src = np.fromiter((int(p[0]) for p in rows), np.int64, len(rows))
    dst = np.fromiter((int(p[1]) for p in rows), np.int64, len(rows))
    wts = [int(float(p[2])) for p in rows if len(p) > 2]
    if weighted is None:
        weighted = len(wts) == len(src) and len(wts) > 0
    w = np.asarray(wts, np.int64) if weighted else None
    n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    return from_edges(n, src, dst, w, undirected=undirected, device=device)


def _decimal(x: np.ndarray):
    """(the ASCII characters of each integer of `x`, right-aligned in a
    [len(x), D] uint8 array, D the widest; and each one's width, sign
    included)."""
    x = x.astype(np.int64)
    mag = np.abs(x)
    cols = len(str(int(mag.max(initial=0)))) + 1         # the digits and a sign
    chars = np.empty((len(x), cols), np.uint8)
    width = np.ones(len(x), np.int64)
    for k in range(cols - 1, -1, -1):
        chars[:, k] = ord("0") + mag % 10
        mag //= 10
        width += mag > 0
    neg = x < 0
    chars[neg, cols - 1 - width[neg]] = ord("-")
    return chars, width + neg


def _edge_lines(columns) -> bytes:
    """`a b c\\n` for each row of the integer columns, as Python's str()
    writes each integer."""
    fields = [_decimal(c) for c in columns]
    line = sum(w for _, w in fields) + len(fields)       # spaces and the newline
    size = int(line.sum())
    out = np.empty(size + 1, np.uint8)                   # the last byte takes unused digits
    at = np.cumsum(line) - line                          # where each line starts
    for j, (chars, width) in enumerate(fields):
        cols = chars.shape[1]
        for k in range(cols):
            pos = at + width - (cols - k)
            out[np.where(pos >= at, pos, size)] = chars[:, k]
        at += width
        out[at] = ord("\n") if j == len(fields) - 1 else ord(" ")
        at += 1
    return out[:size].tobytes()


def save_edgelist(g: CSRGraph, path: str) -> None:
    """Write `g` as the reference does: the header, then `v u w` for every
    edge in CSR order."""
    cols = [t.cpu().numpy() for t in (g.edge_src, g.indices, g.weights)]
    with open(path, "wb") as f:
        f.write(f"# nodes={g.num_nodes} edges={g.num_edges}\n".encode())
        f.write(_edge_lines(cols))
