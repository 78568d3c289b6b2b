"""The reference side of the port's distributed tests (parent process only).

The reference's `bind(g, mesh=...)` / `dist.run` trims a sharded output
with `v[:num_nodes]`, which raises `ShardingTypeError` for every padded
run at P > 1 under jax 0.9; its untrimmed runner `repro.core.dist._runner`
works at every shard count, so the reference runs through it here and its
property outputs are trimmed on the host.
"""
from __future__ import annotations

import numpy as np


def graph_spec(g) -> dict:
    """A reference graph as the arrays `torch_dist_worker.build_graph` takes."""
    from repro_torch.graph import FIELDS
    return dict(arrays={f: np.asarray(getattr(g, f)) for f in FIELDS},
                num_nodes=g.num_nodes, num_edges=g.num_edges,
                max_out_degree=int(g.max_out_degree), max_in_degree=int(g.max_in_degree))


def ref_run(g, name: str, shards: int, sched: dict, params: dict) -> dict:
    """The reference's distributed result on `shards` forced host devices,
    property outputs trimmed to N."""
    from repro.core import Schedule, compile_bundled, dist
    prog = compile_bundled(name, backend="distributed", schedule=Schedule(**sched))
    mesh = dist.make_mesh_1d(shards)
    gd = dist.prepare(g, mesh, ell=prog.dist_meta["needs_ell"])
    names = tuple(k for k, v in params.items() if v is not None)
    out = dist._runner(prog, gd, mesh, names, prog.dist_meta)(gd, *(params[k] for k in names))
    props = prog.dist_meta["out_props"]
    return {k: (np.asarray(v)[: g.num_nodes] if k in props else np.asarray(v))
            for k, v in out.items()}


def assert_agree(got: dict, want: dict, what: str):
    """Every output: the same keys, shapes and dtypes; integers and bools
    equal; floats at rtol 1e-4 / atol 1e-4 with nan positions equal;
    `_gather_elems` (float32) exactly equal."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        x = np.asarray(got[k])
        assert x.shape == w.shape and x.dtype == w.dtype, (what, k, x.shape, x.dtype,
                                                           w.shape, w.dtype)
        if k == "_gather_elems" or w.dtype.kind != "f":
            assert np.array_equal(x, w), f"{what}.{k}: {x} vs {w}"
        else:
            nan = np.isnan(w)
            assert np.array_equal(np.isnan(x), nan), f"{what}.{k}: nan positions differ"
            np.testing.assert_allclose(x[~nan], w[~nan], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}.{k}")


def assert_ranks_agree(results: list, section: str = "programs"):
    """Every rank returned bit-for-bit what rank 0 did (the outputs are
    global: gathered properties, replicated scalars)."""
    first = results[0][section]
    for r, res in enumerate(results[1:], 1):
        for cid, out in first.items():
            for k, v in out.items():
                assert np.array_equal(np.asarray(res[section][cid][k]), np.asarray(v),
                                      equal_nan=np.asarray(v).dtype.kind == "f"), (r, cid, k)
