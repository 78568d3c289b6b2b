"""BFS levels per batched BFS over the window: the port's counters
`rt.bfs_levels_batch.levels` / `.calls` (one batched BFS a bc call)."""


def read(run):
    c = run.counters
    if run.workload.get("program") != "bc" or not c.get("bfs_levels_batch.calls"):
        return None
    return c["bfs_levels_batch.levels"] / c["bfs_levels_batch.calls"]
