"""Queries per sweep over the window (drain included):
`GraphService.stats()`'s coalesced queries over its sweeps, as the
difference across the window."""


def read(run):
    return run.window.get("notes", {}).get("mean_batch")
