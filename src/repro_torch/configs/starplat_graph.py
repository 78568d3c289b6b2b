"""The paper's own workload configs: graph suite x algorithm x backend."""
GRAPH_CONFIGS = {
    "algorithms": ("sssp", "sssp_pull", "pr", "tc", "bc"),
    "backends": ("local", "distributed", "pallas"),
    "suite": ("TW", "SW", "OK", "WK", "LJ", "PK", "US", "GR", "RM", "UR"),
}
