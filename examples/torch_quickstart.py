"""Quickstart on the PyTorch/CUDA port: compile a StarPlat program and run it
on the port's three backends (`local`, `cuda`, `distributed`).

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

The distributed backend runs one rank per shard on `torch.distributed`;
here it runs a one-rank process group that the example makes in this
process (NCCL on the card, gloo on the CPU) and destroys at the end.
"""
import argparse
import contextlib

import numpy as np
import torch.distributed as tdist

from repro_torch.core import compile_program, dist
from repro_torch.graph import resolve_device, uniform_random

SSSP_SOURCE = """
// Single-source shortest paths (paper Fig. 3)
function Compute_SSSP(Graph g, node src) {
  propNode<int> dist;
  propNode<bool> modified;
  g.attachNodeProperty(dist = INF, modified = False);
  src.dist = 0;
  src.modified = True;
  bool finished = False;
  fixedPoint until (finished : !modified) {
    forall(v in g.nodes().filter(modified == True)) {
      forall(nbr in g.neighbors(v)) {
        edge e = g.getEdge(v, nbr);
        <nbr.dist, nbr.modified> = <Min(nbr.dist, v.dist + e.weight), True>;
      }
    }
  }
}
"""


@contextlib.contextmanager
def one_rank_group(device):
    """A process group of one rank in this process, from an in-process
    store (no torchrun variables, no socket), destroyed on exit."""
    if tdist.is_initialized():
        raise RuntimeError(
            "a process group is already initialized: the quickstart makes its "
            "own one-rank group and does not reuse another (run it in a "
            "process of its own)")
    kw = {"device_id": device} if device.type == "cuda" else {}
    tdist.init_process_group(dist.BACKEND_FOR[device.type], store=tdist.HashStore(),
                             rank=0, world_size=1, **kw)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    g = uniform_random(1000, 8, seed=42, device=args.device)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges\n")

    print("=== DSL source ===")
    print(SSSP_SOURCE)

    local = compile_program(SSSP_SOURCE, backend="local")
    print("=== generated torch (local backend, first 25 lines) ===")
    print("\n".join(local.source.splitlines()[:25]))
    print("    ...\n")

    # bind(g) is the uniform per-graph entry point on every backend
    dist_local = local.bind(g)(src=0)["dist"].cpu().numpy()
    reach = dist_local < 2**30
    print(f"local backend:   reached {reach.sum()} nodes, "
          f"max dist {dist_local[reach].max()}")

    cuda = compile_program(SSSP_SOURCE, backend="cuda")
    dist_cuda = cuda.bind(g)(src=0)["dist"].cpu().numpy()
    same = np.array_equal(dist_cuda, dist_local)
    print(f"cuda backend:    identical result: {same} "
          f"(sliced-ELL min-plus kernel)")

    distp = compile_program(SSSP_SOURCE, backend="distributed")
    with one_rank_group(g.device):
        mesh = dist.make_mesh_1d(device=g.device)
        dist_dist = distp.bind(g, mesh=mesh)(src=0)["dist"].cpu().numpy()
    same_d = np.array_equal(dist_dist, dist_local)
    print(f"distributed backend: identical result: {same_d} "
          f"({len(distp.source.splitlines())}-line per-rank body on "
          "torch.distributed; one rank a card via torchrun and "
          "bind(g, mesh=dist.make_mesh_1d()) — see docs/torch_port.md)")
    return {"nodes": g.num_nodes, "edges": g.num_edges, "reached": int(reach.sum()),
            "max_dist": int(dist_local[reach].max()), "cuda_identical": bool(same),
            "distributed_identical": bool(same_d),
            "dist": {"local": dist_local, "cuda": dist_cuda, "distributed": dist_dist}}


if __name__ == "__main__":
    main()
