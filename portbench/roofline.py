"""Frozen peaks of the card and the byte counts of the port's kernels.

The peak is NVIDIA's published figure for one H100 SXM (80 GB HBM3) at its
full 700 W; a card set to a lower power limit runs below it, so every run
that reports a roofline share prints the card's `power.limit` beside it.
Byte counts come from the graph's CSR sizes (N vertices, E edges), never
from a layout the program chose, so a later layout or kernel leaves them
as they are.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12


def minplus_sweep_bytes(n: int, e: int) -> int:
    """One min-plus pull sweep: each edge's in-neighbour index and weight
    read once (8 bytes), x and the frontier read and y written (12 bytes a
    vertex)."""
    return 8 * e + 12 * n


def plustimes_sweep_bytes(n: int, e: int) -> int:
    """One plus-times pull sweep: each edge's in-neighbour index read once
    (4 bytes), x read and y written (8 bytes a vertex)."""
    return 4 * e + 8 * n


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reports them, or
    "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"
