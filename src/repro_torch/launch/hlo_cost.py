"""Cost census of one program run, counted at torch's dispatcher.

PyTorch counterpart of `repro.launch.hlo_cost`, which walks XLA's optimized
HLO. The port has no HLO: it runs `fn(*args)` eagerly under a
`TorchDispatchMode` and counts every aten and c10d op that reaches the
dispatcher, below autograd, so a backward, remat's recompute and every
collective are counted as they run:

  * dot FLOPs        (the matmul family — mm, addmm, bmm, baddbmm, the
                      convolutions and the attention ops — by
                      `torch.utils.flop_counter`'s formulas, op for op what
                      `FlopCounterMode` counts)
  * dot bytes        (operands plus result of each of those ops)
  * collective bytes (the output-shape bytes of every c10d op: all-gather,
                      all-reduce, reduce-scatter, all-to-all, broadcast)

Eager torch runs every trip of a loop, so trip counts are exact on real
tensors. On the meta device a value read on the host (`.item()`, `bool()`,
`int()` of a tensor: a data-dependent loop condition) has no answer: the
census answers it so that a `while` loop runs its body once, and flags the
read's place in `unknown_trip_bodies` — the reference's honest static
answer for a loop whose trip count it cannot read.

Deliberate differences from the reference: the census counts dispatched
ops, not HLO, so what XLA would fuse or eliminate is counted as it runs;
the port's own kernels launch through ctypes, not aten, so their work is
invisible here (as a Pallas call is an opaque custom call in the
reference's HLO; the dry run runs `impl="chunked"` for that reason); and
`xla_cost_dict`, the reference's normalizer of XLA's `cost_analysis()`,
has no counterpart.

The census also tracks the bytes of live tensors (by storage, on any
device, meta included): `peak_bytes` is the most that were live at once
during the run, counted from the bytes of the `arguments` given.
"""
from __future__ import annotations

import os
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_TORCH_DIR = os.path.dirname(torch.__file__)
_READ = torch.ops.aten._local_scalar_dense.default       # .item(), bool(), int() of a tensor


def tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _shape(t) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"


def _caller() -> str:
    """file:line (function) of the innermost frame outside torch and this
    module: where a host read of a tensor value happened."""
    for fr in reversed(traceback.extract_stack()):
        if not fr.filename.startswith(_TORCH_DIR) and fr.filename != __file__:
            return f"{fr.filename}:{fr.lineno} ({fr.name})"
    return "?"


class Census(TorchDispatchMode):
    """with Census(arguments=...) as c: fn(...); then c.result(). The counts
    are per process (in SPMD, per rank)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0
        self.collective_bytes = 0
        self.ops = 0
        self.collectives = defaultdict(lambda: [0, 0])     # (op, shape) -> [count, bytes]
        self.unknown = []
        self._reads = set()
        self._live = {}                                    # storage key -> bytes
        self.live_bytes = self.peak_bytes = 0
        for t in tensors(arguments):
            self._track(t.untyped_storage())
        self.argument_bytes = self.live_bytes

    # -- live bytes ----------------------------------------------------------
    def _track(self, st):
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += self._live[key]
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _READ and args[0].device.type == "meta":
            return self._unknown_read(args[0])
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:                         # as FlopCounterMode: count the parts
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_bytes += nbytes((args, kwargs)) + nbytes(out)
        elif func.namespace == "c10d":
            result = tensors(out[0] if isinstance(out, tuple) else out)
            moved = nbytes(result)
            self.collective_bytes += moved
            if result:
                row = self.collectives[(str(packet), _shape(result[0]))]
                row[0] += 1
                row[1] += moved
        inputs = {t.untyped_storage()._cdata for t in tensors((args, kwargs))}
        for t in tensors(out):
            st = t.untyped_storage()
            if st._cdata not in inputs:
                self._track(st)
        return out

    def _unknown_read(self, t):
        """A host read of a meta tensor's value: the first read at a place
        answers true (a `while` body runs once), later ones false; the
        place is flagged."""
        where = _caller()
        if where not in self.unknown:
            self.unknown.append(where)
        first = where not in self._reads
        self._reads.add(where)
        if t.dtype.is_floating_point:
            return float(first)
        return first if t.dtype == torch.bool else int(first)

    # -- the record ------------------------------------------------------------
    def breakdown(self, top: int = 12):
        """(bytes, count, op, shape) rows of the collectives, largest first:
        which all-gather is eating the step."""
        rows = sorted(((b, n, op, shape) for (op, shape), (n, b) in self.collectives.items()),
                      reverse=True)
        return rows[:top]

    def result(self) -> dict:
        return {"flops": self.flops, "dot_bytes": self.dot_bytes,
                "collective_bytes": self.collective_bytes,
                "unknown_trip_bodies": sorted(self.unknown),
                "num_computations": self.ops,
                "collective_breakdown": self.breakdown()}


def analyze(fn, *args, arguments=None, **kwargs) -> dict:
    """The census of one call `fn(*args, **kwargs)` (its output is dropped),
    with `peak_bytes` counted from `arguments` (default: `args`)."""
    census = Census(args if arguments is None else arguments)
    with census:
        fn(*args, **kwargs)
    return dict(census.result(), argument_bytes=census.argument_bytes,
                peak_bytes=census.peak_bytes)
