"""Schedule: the explicit, per-compile tuning surface of the engine.

StarPlat's premise is one algorithmic specification lowered to multiple
backends; GraphIt showed that the *schedule* — how that specification is
executed — must be a first-class object separate from the algorithm for
per-program tuning (and autotuning) to work. A `Schedule` captures every
knob of the frontier-aware, degree-bucketed execution engine as a frozen,
hashable value:

  * it threads through ``compile_program(source, backend, schedule=...)``
    into code generation, where the knobs are baked into the generated
    source as literals (same ``Schedule`` => byte-identical source);
  * it keys the compile cache, so two programs compiled under different
    schedules coexist in one process;
  * its layout fields key the per-graph derived structures owned by
    ``repro_torch.core.context.GraphContext``.

The old module-level ``repro_torch.graph.ENGINE`` singleton is a deprecated shim
that materializes a ``Schedule`` via ``ENGINE.snapshot()`` at compile /
prepare time; mutating it after compile never changes a compiled program.

This module is intentionally dependency-free (no jax, no repro_torch imports) so
every layer — graph views, runtime, codegen, kernels — can use it.

Knob-by-knob reference (type, default, valid range, consuming backend,
measured perf guidance): ``docs/schedule.md`` — its table is asserted
against ``dataclasses.fields(Schedule)`` by tests/test_docs.py, so the
two cannot drift. ``repro_torch.autotune`` searches this space per graph.
"""
from __future__ import annotations

import dataclasses
import numbers

# TPU VPU lanes are 8x128; bucket widths (and row padding) must stay a
# multiple of the sublane count so every bucket tile stays vector-aligned.
LANE_MULTIPLE = 8

_DIRECTIONS = ("auto", "push", "pull")
_DIST_FRONTIERS = ("dense", "compact", "auto")
_PRIORITIES = ("none", "delta")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Frozen engine configuration for one compiled program.

    Fields
    ------
    num_buckets:
        Degree buckets in the sliced-ELL view (>= 1).
    min_width:
        Width of the narrowest bucket; a positive multiple of
        ``LANE_MULTIPLE`` (8) so tiles stay VPU-aligned.
    growth:
        Geometric width growth between buckets; an integer > 1.
    push_threshold_frac:
        Frontier occupancy (as a fraction of N, in [0, 1]) below which a
        relax/BFS step runs push-style (scatter from the few active
        sources) instead of pull (gather/kernel over in-edges). Only
        consulted when ``direction == "auto"``.
    batch_sources:
        Sources traversed per batched chunk in ``forall(src in sourceSet)``
        (>= 0; 0 or 1 disables batching — sequential per-source loop).
    direction:
        Traversal direction policy: ``"auto"`` switches push/pull on-device
        by frontier occupancy; ``"push"`` / ``"pull"`` pin one direction.
        Both directions compute the identical relaxation, so pinning never
        changes results — only the execution schedule.
    block_rows:
        Row-block (grid tile height) cap for the per-bucket ELL kernels on
        the pallas backend: either one int (uniform cap for every bucket)
        or a tuple of per-bucket caps of length ``num_buckets``. Each cap
        must be a positive multiple of ``LANE_MULTIPLE`` (8); the kernel
        launcher picks the largest power-of-two block <= the cap that
        divides the bucket's (8-aligned) row count. Narrow buckets amortize
        grid-step overhead with tall blocks; wide buckets may need short
        blocks to fit their ``block * width`` tile in VMEM.
    dist_frontier:
        BSP property-exchange policy of the distributed backend.
        ``"dense"`` all-gathers the full property arrays every superstep
        (the paper's scheme, and the conservative baseline the autotuner
        starts from). ``"compact"`` exchanges only the entries that changed
        since the last superstep through fixed-size per-shard buffers,
        falling back to a full gather whenever any shard's change count
        overflows its buffer. ``"auto"`` is ``"compact"`` plus an
        empty-frontier fast path: when no entry changed anywhere, the
        collective is skipped entirely. All three policies exchange the
        same values, so the choice never changes results — only
        communication volume.
    dist_gather_frac:
        Per-shard capacity of the compact exchange buffer, as a fraction of
        the shard's vertex block (in [0, 1]). A compact superstep moves
        ``2 * cap * num_shards`` elements (ids + values) instead of the
        dense ``N_pad``, so fractions >= 0.5 cannot beat the dense gather
        and the exchange statically degrades to ``"dense"`` there.
    priority:
        Ordering policy for monotonic Min-relax fixedPoint loops (SSSP-
        style). ``"none"`` relaxes the whole modified frontier every sweep
        (the paper's scheme). ``"delta"`` lowers the loop to delta-stepping:
        each sweep relaxes only the vertices whose tentative value falls
        below the current bucket boundary ``(k + 1) * delta_bucket``,
        iterating until the bucket settles, then advances ``k`` straight to
        the bucket of the smallest pending value. Min relaxation is
        monotone, so restricting the frontier never changes the fixed
        point — only the work per sweep. Loops without a Min relax
        (PageRank, TC) ignore the knob.
    delta_bucket:
        Bucket width Δ for ``priority="delta"`` (a positive integer, in
        units of edge weight). Small Δ approaches Dijkstra ordering (less
        wasted relaxation work per sweep, more bucket phases); large Δ
        approaches the monotonic relax. ``autotune()`` derives candidates
        from the graph's weight scale.
    refresh_threshold_frac:
        Incremental-recompute cutoff for ``BoundProgram.refresh`` (a
        fraction of N, in [0, 1]). After ``g.update(adds, dels)`` the
        refresh path seeds the iterative loop from the vertices affected
        by the batch; when the affected set exceeds this fraction of the
        graph, warm-starting saves too little over a cold sweep and
        refresh falls back to a dense full recompute. ``0.0`` always
        recomputes from scratch; ``1.0`` always takes the incremental
        path. Programs without an iterative construct have nothing to
        warm-start (SP208).
    """

    num_buckets: int = 4
    min_width: int = 8
    growth: int = 4
    push_threshold_frac: float = 1.0 / 16.0
    batch_sources: int = 32
    direction: str = "auto"
    block_rows: object = 256   # int (uniform) or tuple of per-bucket caps
    dist_frontier: str = "dense"
    dist_gather_frac: float = 0.25
    priority: str = "none"
    delta_bucket: int = 64
    refresh_threshold_frac: float = 0.25

    def __post_init__(self):
        set_ = lambda k, v: object.__setattr__(self, k, v)  # noqa: E731 (frozen)
        for name in ("num_buckets", "min_width", "growth", "batch_sources",
                     "delta_bucket"):
            v = getattr(self, name)
            # accept anything integer-valued (numpy ints from autotuning
            # sweeps, integral floats) but normalize to python int so
            # equality/hashing — the compile-cache key — stay canonical
            if isinstance(v, bool):
                raise ValueError(
                    f"Schedule.{name} must be an integer, got {v!r}")
            if isinstance(v, numbers.Integral):
                set_(name, int(v))
            elif isinstance(v, float) and v.is_integer():
                set_(name, int(v))
            else:
                raise ValueError(
                    f"Schedule.{name} must be an integer, got {v!r}")
        if self.num_buckets < 1:
            raise ValueError(
                f"Schedule.num_buckets must be >= 1, got {self.num_buckets} "
                "(the sliced-ELL view needs at least one degree bucket)")
        if self.min_width <= 0 or self.min_width % LANE_MULTIPLE:
            raise ValueError(
                f"Schedule.min_width must be a positive multiple of "
                f"{LANE_MULTIPLE} (VPU sublane count), got {self.min_width}")
        if self.growth <= 1:
            raise ValueError(
                f"Schedule.growth must be > 1, got {self.growth} "
                "(bucket widths grow geometrically; growth 1 would make "
                "every bucket the same width)")
        frac = self.push_threshold_frac
        if isinstance(frac, numbers.Real) and not isinstance(frac, bool):
            set_("push_threshold_frac", float(frac))
        if not isinstance(self.push_threshold_frac, float) or \
                not 0.0 <= self.push_threshold_frac <= 1.0:
            raise ValueError(
                "Schedule.push_threshold_frac must be a fraction of N in "
                f"[0, 1], got {self.push_threshold_frac!r}")
        if self.batch_sources < 0:
            raise ValueError(
                f"Schedule.batch_sources must be >= 0, got "
                f"{self.batch_sources} (0 or 1 disables source batching)")
        # normalize str subclasses (np.str_ from sweep code) to plain str:
        # these values are baked into generated source via repr()
        if isinstance(self.direction, str):
            set_("direction", str(self.direction))
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                f"Schedule.direction must be one of {_DIRECTIONS}, got "
                f"{self.direction!r}")
        if isinstance(self.dist_frontier, str):
            set_("dist_frontier", str(self.dist_frontier))
        if self.dist_frontier not in _DIST_FRONTIERS:
            raise ValueError(
                f"Schedule.dist_frontier must be one of {_DIST_FRONTIERS}, "
                f"got {self.dist_frontier!r}")
        if isinstance(self.priority, str):
            set_("priority", str(self.priority))
        if self.priority not in _PRIORITIES:
            raise ValueError(
                f"Schedule.priority must be one of {_PRIORITIES}, got "
                f"{self.priority!r}")
        if self.delta_bucket <= 0:
            raise ValueError(
                f"Schedule.delta_bucket must be a positive bucket width "
                f"(in edge-weight units), got {self.delta_bucket}")
        gfrac = self.dist_gather_frac
        if isinstance(gfrac, numbers.Real) and not isinstance(gfrac, bool):
            set_("dist_gather_frac", float(gfrac))
        if not isinstance(self.dist_gather_frac, float) or \
                not 0.0 <= self.dist_gather_frac <= 1.0:
            raise ValueError(
                "Schedule.dist_gather_frac must be a fraction of the shard "
                f"block in [0, 1], got {self.dist_gather_frac!r}")
        rfrac = self.refresh_threshold_frac
        if isinstance(rfrac, numbers.Real) and not isinstance(rfrac, bool):
            set_("refresh_threshold_frac", float(rfrac))
        if not isinstance(self.refresh_threshold_frac, float) or \
                not 0.0 <= self.refresh_threshold_frac <= 1.0:
            raise ValueError(
                "Schedule.refresh_threshold_frac must be a fraction of N in "
                f"[0, 1], got {self.refresh_threshold_frac!r}")
        br = self.block_rows
        if isinstance(br, (list, tuple)):
            br = tuple(br)
            if len(br) != self.num_buckets:
                raise ValueError(
                    f"Schedule.block_rows tuple must have one cap per bucket "
                    f"(num_buckets={self.num_buckets}), got {len(br)} entries "
                    f"— or pass a single int for a uniform cap")
        else:
            br = (br,)
        norm = []
        for v in br:
            if isinstance(v, bool) or not isinstance(v, numbers.Integral):
                if not (isinstance(v, float) and v.is_integer()):
                    raise ValueError(
                        f"Schedule.block_rows entries must be integers, got "
                        f"{v!r}")
            v = int(v)
            if v <= 0 or v % LANE_MULTIPLE:
                raise ValueError(
                    f"Schedule.block_rows caps must be positive multiples of "
                    f"{LANE_MULTIPLE} (VPU sublane count), got {v}")
            norm.append(v)
        set_("block_rows",
             tuple(norm) if isinstance(self.block_rows, (list, tuple))
             else norm[0])

    # ------------------------------------------------------------------
    def layout_key(self) -> tuple:
        """The fields that determine per-graph *data layout* (the sliced-ELL
        bucket structure). Two schedules sharing a layout_key share the same
        derived graph views in a GraphContext."""
        return (self.num_buckets, self.min_width, self.growth)

    def bucket_widths(self) -> tuple:
        return tuple(self.min_width * self.growth ** i
                     for i in range(self.num_buckets))

    def bucket_block_rows(self) -> tuple:
        """Per-bucket kernel row-block caps, always of length ``num_buckets``
        (a uniform int cap is broadcast). This is the form the pallas
        codegen bakes into generated source."""
        if isinstance(self.block_rows, tuple):
            return self.block_rows
        return (self.block_rows,) * self.num_buckets

    def replace(self, **changes) -> "Schedule":
        """Functional update (alias for ``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)


DEFAULT_SCHEDULE = Schedule()
