"""Share of its HBM roofline that the traced min-plus `ell_sweep` launches
reach: the least time of those launches (bytes from the CSR's N and E,
`roofline.minplus_sweep_bytes`, over the published HBM rate) over their
profiled kernel time (the sweep and its combine kernel). Nothing to read
where the trace holds no min-plus sweep."""
from portbench import roofline


def read(run):
    t = run.traced
    if run.workload.get("program") != "sssp" or not t:
        return None
    launches, secs = 0, 0.0
    for name, (s, count) in t["kernels"].items():
        if "ell_sweep" in name and "MinPlus" in name:
            secs += s
            if "ell_sweep_combine" not in name:
                launches += count
    if not launches or secs <= 0:
        return None
    least = roofline.least_seconds(
        launches * roofline.minplus_sweep_bytes(run.meta["num_nodes"], run.meta["num_edges"]))
    return 100.0 * least / secs
