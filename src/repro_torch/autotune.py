"""Schedule autotuner: search the `Schedule` space per (program, graph).

The port of `repro.autotune`, over the port's three backends:

  1. **Search space** — `search_space(stats)` derives candidate schedules
     from `Schedule`'s own fields, pruned by the graph statistics a
     `GraphContext` computes (`ctx.stats()`), so a power-law and a road
     graph start from different candidate sets. These are pure functions
     of the stats, equal to the reference's.
  2. **Measure loop** — each trial recompiles the program under a
     candidate schedule through the compile cache and times
     `prog.bind(g)` executions with warm-up (synchronizing the device
     the call ran on), taking the min over repetitions. A distributed
     program is tuned by every rank of its mesh alike: each trial's
     seconds are the slowest rank's (a BSP run waits for it), so every
     rank picks the same winner.
  3. **Persistence** — results land in a `TuningRecord` keyed by
     ``(source digest, backend, graph fingerprint)`` that round-trips
     through JSON via `TuningStore`, in the reference's file format. The
     backend is part of the key, so a `cuda` record never answers a
     `local` (or the reference's `pallas`) lookup. Under a mesh, rank
     0's store decides for every rank and rank 0 alone writes the file.

Entry point::

    from repro_torch.autotune import autotune
    result = autotune(prog, g, budget=16)        # result.schedule is best
    tuned  = result.program.bind(g)              # compiled under it

Determinism: given the same graph, seed, and budget, the candidate list,
trial order, and tie-breaking are all deterministic; with a deterministic
``measure=`` hook the chosen schedule is exactly reproducible. The
program's own schedule is always trial #0 and ties break toward the
earliest trial, so the result is never *measured-worse* than it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as tdist

from .core.analysis import ERROR, check_schedule, program_analysis
from .core.api import CompiledProgram
from .core import runtime_dist as rtd
from .core.context import get_context
from .schedule import LANE_MULTIPLE, Schedule

RECORD_VERSION = 1

# stats thresholds the pruning branches on (see GraphContext.stats())
_SKEWED_CV = 0.5          # degree CV above this = power-law-like
_SKEWED_MAX_RATIO = 4.0   # max_degree / avg_degree above this = hubby
_FLAT_FRONTIER = 1.0 / 16.0  # peak frontier frac below this = always-sparse
_DEEP_PROBE = 32          # BFS probe depth at/over this = high-diameter
#                           (road-like) graph: delta-stepping candidates on


def source_digest(source: str) -> str:
    """Stable 16-hex-char digest of a DSL source text (TuningRecord key)."""
    return hashlib.sha256(source.encode()).hexdigest()[:16]


def schedule_to_dict(s: Schedule) -> dict:
    return dataclasses.asdict(s)


def schedule_from_dict(d: dict) -> Schedule:
    """Inverse of `schedule_to_dict`, tolerant of JSON round-trips (list →
    tuple normalization happens in `Schedule.__post_init__`)."""
    fields = {f.name for f in dataclasses.fields(Schedule)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(
            f"unknown Schedule fields in stored record: {sorted(unknown)} "
            "(the record predates or postdates this Schedule version)")
    return Schedule(**d)


# --------------------------------------------------------------------------
# search space
# --------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _with_layout(base: Schedule, num_buckets: int, min_width: int,
                 growth: int) -> Schedule:
    # a per-bucket block_rows tuple is tied to the old bucket count —
    # collapse it to a uniform cap before changing the layout
    br = base.block_rows if isinstance(base.block_rows, int) \
        else max(base.block_rows)
    return base.replace(num_buckets=num_buckets, min_width=min_width,
                        growth=growth, block_rows=br)


def search_space(stats: dict, base: Optional[Schedule] = None, *,
                 tune_batch: bool = False,
                 backend: str = "local") -> List[Schedule]:
    """Candidate schedules for a graph with these statistics.

    Deterministic and pruned: the base schedule is always candidate #0
    (so the tuner can never return something measured-worse than it), and
    the variants explored depend on what `stats` say about the graph —
    one knob dimension is varied at a time around the base rather than a
    full cross product, keeping the list measurable within a small budget.

    `tune_batch=True` adds `batch_sources` variants (only meaningful for
    programs with a source-set loop; the caller knows from the IR).

    `backend="distributed"` explores the distributed knob plane instead of
    the single-device layout/kernel knobs: the frontier-exchange policy
    (`dist_frontier` x `dist_gather_frac`), the relax/BFS `direction`, and
    the source-batch width. The base (by default the dense-gather paper
    schedule) stays candidate #0 there too.
    """
    base = Schedule() if base is None else base
    if backend == "distributed":
        return _dist_search_space(stats, base, tune_batch=tune_batch)
    cands: List[Schedule] = [base]

    skewed = (stats.get("deg_cv", 0.0) >= _SKEWED_CV
              or stats.get("skew", 1.0) >= _SKEWED_MAX_RATIO)
    flat = stats.get("probe_max_frontier_frac", 1.0) <= _FLAT_FRONTIER
    max_deg = max(stats.get("max_in_degree", 1),
                  stats.get("max_out_degree", 1))

    # ---- bucket layout: skewed graphs explore depth, uniform graphs
    # collapse to one bucket sized to the (narrow) degree range ----------
    if skewed:
        layouts = [(4, 8, 4), (5, 8, 4), (3, 8, 8), (4, 16, 4)]
    else:
        w = max(_round_up(max_deg, LANE_MULTIPLE), LANE_MULTIPLE)
        layouts = [(1, min(w, 512), 2), (2, 8, 4)]
    for nb, mw, gr in layouts:
        cands.append(_with_layout(base, nb, mw, gr))

    # ---- direction policy + push threshold -----------------------------
    if flat:
        # the frontier never grows past the default threshold: every auto
        # step would push anyway — pin it and drop the occupancy test
        cands.append(base.replace(direction="push"))
        cands.append(base.replace(direction="auto",
                                  push_threshold_frac=1.0 / 4.0))
    else:
        cands.append(base.replace(direction="pull"))
        for frac in (1.0 / 64.0, 1.0 / 4.0):
            cands.append(base.replace(direction="auto",
                                      push_threshold_frac=frac))

    # ---- priority policy (delta-stepping) ------------------------------
    # only worth measuring on high-diameter weighted graphs (road/grid):
    # there the monotonic relax runs hundreds of near-empty sweeps that a
    # bucketed frontier turns into a handful of compact-relax phases. The
    # candidate bucket widths are multiples of the mean edge weight — a
    # bucket then spans roughly that many relaxed hops.
    avg_w = stats.get("avg_weight", 0.0)
    if stats.get("probe_depth", 0) >= _DEEP_PROBE and avg_w > 0:
        for mult in (16, 64):
            cands.append(base.replace(priority="delta",
                                      delta_bucket=max(int(avg_w * mult), 1)))

    # ---- kernel row-block caps (cuda buckets) --------------------------
    for br in (64, 1024):
        if br != base.block_rows:
            cands.append(base.replace(block_rows=br))

    # ---- source-batch width (programs with a set loop only) ------------
    if tune_batch:
        for bs in (8, 16, 64):
            if bs != base.batch_sources:
                cands.append(base.replace(batch_sources=bs))

    # dedup, order-preserving (Schedule is hashable by design)
    return _dedup(cands)


def _dist_search_space(stats: dict, base: Schedule, *,
                       tune_batch: bool = False) -> List[Schedule]:
    """Distributed candidates: gather policy x direction x batch width.

    The dense full-gather base comes first (nothing can measure worse than
    the paper's scheme); the compact/auto exchange variants pay off when
    frontiers stay small relative to `dist_gather_frac` x block, so the
    always-sparse graphs also try a tighter buffer."""
    cands: List[Schedule] = [base]
    flat = stats.get("probe_max_frontier_frac", 1.0) <= _FLAT_FRONTIER

    # ---- frontier-exchange policy ---------------------------------------
    for pol in ("auto", "compact"):
        cands.append(base.replace(dist_frontier=pol))
    if flat:
        # frontiers never grow: a tighter compact buffer still fits and
        # halves the per-superstep volume again
        cands.append(base.replace(dist_frontier="auto",
                                  dist_gather_frac=1.0 / 16.0))
    else:
        cands.append(base.replace(dist_frontier="auto",
                                  dist_gather_frac=3.0 / 8.0))

    # ---- relax/BFS direction --------------------------------------------
    for d in ("pull", "push"):
        cands.append(base.replace(direction=d))
    # the combination the volume model predicts: compressed exchange plus
    # the combine-free pull superstep
    cands.append(base.replace(dist_frontier="auto", direction="pull"))

    # ---- priority policy (delta-stepping + priority-sliced exchange) ----
    avg_w = stats.get("avg_weight", 0.0)
    if stats.get("probe_depth", 0) >= _DEEP_PROBE and avg_w > 0:
        cands.append(base.replace(priority="delta",
                                  delta_bucket=max(int(avg_w * 16), 1),
                                  dist_frontier="auto"))

    # ---- source-batch width (programs with a set loop only) --------------
    if tune_batch:
        for bs in (0, 8, 64):
            if bs != base.batch_sources:
                cands.append(base.replace(batch_sources=bs))
    return _dedup(cands)


def _dedup(cands: List[Schedule]) -> List[Schedule]:
    seen, out = set(), []
    for c in cands:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def _has_set_param(prog: CompiledProgram) -> bool:
    return any(p.kind == "set_n" for p in prog.ir.params)


# well-known scalar names across the bundled programs (PR's damping etc.);
# anything unknown gets a safe small positive value
_SCALAR_DEFAULTS = {"beta": 1e-4, "delta": 0.85, "maxiter": 20}


def default_params(prog: CompiledProgram, g, *, seed: int = 0,
                   num_sources: int = 16) -> dict:
    """Representative call parameters derived from the program's IR params:
    node params get vertex 0, source sets a seeded random batch, scalars a
    named default (`beta`/`delta`/`maxIter`) or 1. Property params stay
    unset (the generated code initializes them)."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    for p in prog.ir.params[1:]:
        if p.kind == "node_param":
            params[p.name] = 0
        elif p.kind == "set_n":
            # without replacement: a duplicated source would fill two batch
            # lanes with the same query (and break set-semantics programs
            # like BC that accumulate one contribution per distinct source)
            params[p.name] = rng.choice(
                g.num_nodes, size=min(num_sources, g.num_nodes),
                replace=False).astype(np.int32)
        elif p.kind == "scalar":
            v = _SCALAR_DEFAULTS.get(p.name.lower(), 1)
            params[p.name] = int(v) if p.dtype == "int32" else float(v)
    return params


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

def _sync(bound) -> None:
    """Wait for the work a call queued on its device (a distributed
    program's mesh device, else the graph's)."""
    dev = bound.mesh.device if bound.mesh is not None else bound.graph.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_wallclock(bound, params: dict, *, warmup: int = 1,
                      reps: int = 3) -> float:
    """min-of-`reps` wall-clock seconds for one `bound(**params)` call,
    after `warmup` untimed calls, each ending in a synchronize of the
    graph's device."""
    for _ in range(max(warmup, 0)):
        bound(**params)
        _sync(bound)
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        bound(**params)
        _sync(bound)
        best = min(best, time.perf_counter() - t0)
    return best


# --------------------------------------------------------------------------
# records + store
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TuningRecord:
    """One finished tuning run, JSON-serializable.

    Keyed by ``(source_digest, backend, graph_fingerprint)``: the digest
    pins the *algorithm text*, the fingerprint pins the *graph contents*
    — if either changed since the record was written, replaying the
    stored schedule would be tuning for a different problem, so lookups
    reject the record and the caller re-tunes."""

    source_digest: str
    backend: str
    graph_fingerprint: str
    fn_name: str
    schedule: dict             # the chosen schedule, as a plain dict
    best_ms: float
    default_ms: float          # trial #0 = the program's own schedule
    trials: list               # [{"schedule": dict, "ms": float}, ...]
    budget: int
    seed: int
    graph_stats: dict = dataclasses.field(default_factory=dict)
    pruned_candidates: int = 0  # statically illegal schedules skipped unmeasured
    # cost-model provenance: fingerprint of the stats-nearest neighbor graph
    # whose best schedule seeded trial #0 ("" = unseeded run). Each trial
    # dict also carries "source": "seeded" | "search".
    seeded_from: str = ""
    version: int = RECORD_VERSION

    def key(self) -> tuple:
        return (self.source_digest, self.backend, self.graph_fingerprint)

    def best_schedule(self) -> Schedule:
        return schedule_from_dict(self.schedule)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TuningRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TuningRecord":
        return cls.from_dict(json.loads(text))


def _read_records(path: Optional[str]) -> dict:
    """Parse a store file into a {key: TuningRecord} dict. Malformed files
    or records read as empty/skipped (a miss, never a crash)."""
    records: dict = {}
    if not path or not os.path.exists(path):
        return records
    try:
        with open(path) as f:
            data = json.load(f)
        raw = data.get("records", [])
    except (json.JSONDecodeError, AttributeError, OSError):
        return records
    for d in raw:
        try:
            rec = TuningRecord.from_dict(d)
            records[rec.key()] = rec
        except (TypeError, ValueError):
            continue   # skip the damaged record, keep the rest
    return records


class TuningStore:
    """JSON-file-backed map of `TuningRecord`s.

    A server process points this at a path, calls `autotune(..., store=...)`
    once per (program, graph), and every later process start is a lookup
    instead of a measurement sweep. Lookups are strict: a record is
    returned only when its stored digest/fingerprint/version equal the
    requested key — anything else (edited source, regenerated graph,
    tampered or stale file) is a miss, so the caller re-tunes."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: dict = {}
        if path and os.path.exists(path):
            self.load()

    def load(self) -> None:
        """Read the store file; malformed content is a miss, not a crash —
        an unparseable file or record means "never tuned", so the caller
        re-measures and the next `save()` rewrites a clean file."""
        self._records = _read_records(self.path)

    def save(self, *, merge: bool = True) -> None:
        """Persist the store, safely under concurrent writers.

        Two protections (two servers sharing one store file must not
        truncate each other's records):

        * **reload-merge** — the on-disk records are re-read and merged
          under this store's records (memory wins on key conflicts; both
          stores' disjoint records survive an interleaved save-save), so a
          writer that loaded an older file never blindly overwrites what a
          peer tuned since. `merge=False` restores the overwrite semantics
          (explicitly pruning a store).
        * **atomic write** — the merged file is written to a
          writer-unique temp name and `os.replace`d into place, so a
          reader (or a crashed writer) can never observe a torn file.
        """
        if not self.path:
            return
        if merge:
            disk = _read_records(self.path)
            disk.update(self._records)
            self._records = disk
        data = {"version": RECORD_VERSION,
                "records": [r.to_dict() for r in self._records.values()]}
        tmp = f"{self.path}.{os.getpid()}.{id(self):x}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(data, f, indent=2)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def lookup(self, digest: str, backend: str,
               fingerprint: str) -> Optional[TuningRecord]:
        rec = self._records.get((digest, backend, fingerprint))
        if rec is None:
            return None
        # strict validation: a record is only trusted if its own fields
        # restate the key it is filed under and its version is current
        if (rec.source_digest != digest or rec.backend != backend
                or rec.graph_fingerprint != fingerprint
                or rec.version != RECORD_VERSION):
            return None
        return rec

    def put(self, rec: TuningRecord) -> None:
        self._records[rec.key()] = rec

    def records(self) -> List[TuningRecord]:
        """All records, in deterministic (sorted-key) order."""
        return [self._records[k] for k in sorted(self._records)]

    def __len__(self) -> int:
        return len(self._records)


# --------------------------------------------------------------------------
# cost-model seeding (nearest-stats-neighbor warm starts)
# --------------------------------------------------------------------------

# size-like stats compare on a log scale (a 1k- and a 2k-node graph are
# "close"; a 1k- and a 1M-node graph are not, whatever the linear gap says);
# ratio/fraction stats are already scale-free and compare linearly
_SEED_LOG_FEATURES = ("num_nodes", "num_edges", "avg_degree",
                      "max_out_degree", "max_in_degree", "skew",
                      "avg_weight", "probe_depth")
_SEED_LIN_FEATURES = ("deg_cv", "probe_max_frontier_frac",
                      "probe_growth", "probe_reach_frac")


def stats_distance(a: dict, b: dict) -> float:
    """Normalized distance between two `GraphContext.stats()` dicts —
    the cost model's notion of "graphs this schedule should transfer to"."""
    import math
    d = 0.0
    for k in _SEED_LOG_FEATURES:
        fa = math.log1p(abs(float(a.get(k, 0.0))))
        fb = math.log1p(abs(float(b.get(k, 0.0))))
        d += (fa - fb) ** 2
    for k in _SEED_LIN_FEATURES:
        d += (float(a.get(k, 0.0)) - float(b.get(k, 0.0))) ** 2
    return math.sqrt(d)


def nearest_record(store: TuningStore, digest: str, backend: str,
                   stats: dict) -> Optional[TuningRecord]:
    """The store record for the same (program, backend) whose graph stats
    are nearest to `stats`, or None when the store has nothing comparable.
    Deterministic: ties break toward the smaller fingerprint (store order
    is sorted)."""
    best, best_d = None, float("inf")
    for rec in store.records():
        if rec.source_digest != digest or rec.backend != backend \
                or not rec.graph_stats:
            continue
        d = stats_distance(stats, rec.graph_stats)
        if d < best_d:
            best, best_d = rec, d
    return best


# --------------------------------------------------------------------------
# the tuner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TuningResult:
    """What `autotune` returns: the winning schedule, the program compiled
    under it (a compile-cache resident), and the full record (also in the
    store, if one was given). `from_store` is True when no measurement ran
    because a valid persisted record answered the query."""

    schedule: Schedule
    program: CompiledProgram
    record: TuningRecord
    from_store: bool = False

    @property
    def speedup(self) -> float:
        """default-schedule time / best time (>= 1.0 by construction when
        measured; whatever the stored record says on a store hit)."""
        return (self.record.default_ms / self.record.best_ms
                if self.record.best_ms else 1.0)


def autotune(prog: CompiledProgram, g, *, budget: int = 16, seed: int = 0,
             params: Optional[dict] = None,
             warmup: int = 1, reps: int = 3,
             measure: Optional[Callable] = None,
             store: Union[TuningStore, str, None] = None,
             verbose: bool = False, mesh=None) -> TuningResult:
    """Search the `Schedule` space for `prog` on `g`; return the best.

    * `budget` caps the number of measured candidates (trial #0 is always
      the program's own schedule, so the result is never measured-worse
      than the baseline).
    * `params` are the call parameters to time with; omitted, they are
      derived from the program's IR (`default_params`).
    * `measure(bound, params) -> seconds` replaces the wall-clock timer
      (tests inject a deterministic cost model here).
    * a distributed program runs its trials over `mesh` (default:
      `dist.make_mesh_1d()`, on the card), and every rank of the mesh
      must call `autotune` alike: each trial's seconds are the largest of
      any rank's (an all-reduce), the store is rank 0's (broadcast) and
      only rank 0 saves it, so every rank returns the same schedule and
      record. `mesh=` applies to the distributed backend only.
    * `store` (a `TuningStore` or a path) persists the result; a valid
      stored record for (source digest, backend, graph fingerprint) skips
      measurement entirely, and a record whose digest or fingerprint no
      longer matches is ignored and re-tuned. On a miss, records for the
      same (program, backend) on OTHER graphs act as a cost model: the
      stats-nearest neighbor's winning schedule is measured first as a
      seeded trial #0 (`TuningRecord.seeded_from` + per-trial "source"
      record the provenance), with the program's own schedule still
      measured right behind it.

    Deterministic given (graph, seed, budget) and a deterministic
    `measure`: candidate order, truncation, and tie-breaking (earliest
    trial wins) contain no randomness beyond the seeded param draw.
    """
    if prog.backend == "distributed":
        from .core import dist
        mesh = mesh if mesh is not None else dist.make_mesh_1d()
    elif mesh is not None:
        raise ValueError("mesh= applies to the distributed backend only (this "
                         f"program's backend is {prog.backend!r})")
    if not prog.dsl_source:
        raise ValueError(
            "program has no dsl_source to recompile under candidate "
            "schedules (compile it via compile_program/compile_bundled)")
    ctx = get_context(g)
    digest = source_digest(prog.dsl_source)
    fingerprint = ctx.fingerprint()

    if isinstance(store, str):
        store = TuningStore(store)
    if store is not None and mesh is not None:
        _take_rank0_records(store, mesh)
    if store is not None:
        rec = store.lookup(digest, prog.backend, fingerprint)
        if rec is not None:
            try:
                sched = rec.best_schedule()
            except ValueError:
                sched = None   # stored schedule invalid here -> re-tune
            if sched is not None:
                return TuningResult(schedule=sched,
                                    program=prog.recompile(sched),
                                    record=rec, from_store=True)

    stats = ctx.stats()
    fx = program_analysis(prog.dsl_source).functions.get(prog.name)

    # ---- cost-model seeding: on a store *miss*, the record for the
    # stats-nearest graph tuned under the same (program, backend) proposes
    # its winning schedule as trial #0 — a warm start for unseen graphs.
    # The program's own schedule is still always measured (it follows the
    # seed in the candidate list), so seeding can propose but never force:
    # the result is never measured-worse than the unseeded path.
    seeded_from = ""
    seeds: List[Schedule] = []
    if store is not None and budget >= 2:
        neighbor = nearest_record(store, digest, prog.backend, stats)
        if neighbor is not None:
            try:
                ssched = neighbor.best_schedule()
            except ValueError:
                ssched = None      # foreign Schedule version -> no seed
            if ssched is not None and not (fx is not None and any(
                    d.severity == ERROR
                    for d in check_schedule(fx, ssched, prog.backend))):
                seeds = [ssched]
                seeded_from = neighbor.graph_fingerprint
                if verbose:
                    print(f"  seeding trial 0 from neighbor "
                          f"{seeded_from}: {ssched}")

    cands = _dedup(seeds + search_space(
        stats, base=prog.schedule, tune_batch=_has_set_param(prog),
        backend=prog.backend))
    # static legality pruning: candidates the analysis layer can reject
    # (e.g. priority="delta" on a program with no monotone Min relax) are
    # dropped before any trial budget is spent measuring them. Trial #0 —
    # the program's own schedule — already passed the compile gate, so the
    # baseline is never pruned (and the seed, if any, was vetted above).
    pruned = 0
    if fx is not None:
        legal = []
        for cand in cands:
            if any(d.severity == ERROR
                   for d in check_schedule(fx, cand, prog.backend)):
                pruned += 1
            else:
                legal.append(cand)
        cands = legal
    if verbose and pruned:
        print(f"  pruned {pruned} statically illegal candidate(s)")
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    cands = cands[:budget]
    if params is None:
        params = default_params(prog, g, seed=seed)
    if measure is None:
        def measure(bound, p, _w=warmup, _r=reps):
            return measure_wallclock(bound, p, warmup=_w, reps=_r)

    trials = []
    best_i, best_s = 0, float("inf")
    for i, cand in enumerate(cands):
        trial = prog.recompile(cand)       # compile-cache hit when seen
        secs = float(measure(trial.bind(g, mesh=mesh), params))
        if mesh is not None:      # a BSP run lasts as long as its slowest rank
            secs = float(rtd.pmax(torch.tensor(secs, dtype=torch.float64,
                                               device=mesh.device), mesh))
        trials.append({"schedule": schedule_to_dict(cand),
                       "ms": round(1e3 * secs, 4),
                       "source": ("seeded" if seeded_from and i == 0
                                  else "search")})
        if secs < best_s:                  # strict <: earliest trial wins ties
            best_i, best_s = i, secs
        if verbose:
            mark = " <-- best" if best_i == i else ""
            print(f"  trial {i:2d}: {1e3 * secs:9.2f} ms  {cand}{mark}")

    best = cands[best_i]
    # default_ms keys off the program's OWN schedule (trial #0 when
    # unseeded; trial #1 behind the seed otherwise)
    base_i = cands.index(prog.schedule) if prog.schedule in cands else 0
    record = TuningRecord(
        source_digest=digest, backend=prog.backend,
        graph_fingerprint=fingerprint, fn_name=prog.name,
        schedule=schedule_to_dict(best),
        best_ms=trials[best_i]["ms"], default_ms=trials[base_i]["ms"],
        trials=trials, budget=budget, seed=seed, graph_stats=dict(stats),
        pruned_candidates=pruned, seeded_from=seeded_from)
    if store is not None:
        store.put(record)
        if mesh is None or mesh.rank == 0:
            store.save()
        if mesh is not None:
            _barrier(mesh)        # no rank returns before the file is written
    return TuningResult(schedule=best, program=prog.recompile(best),
                        record=record)


def _take_rank0_records(store: TuningStore, mesh) -> None:
    """Every rank's store holds rank 0's records (a broadcast), so the
    store hit and the seeding neighbour are decided alike on every rank."""
    box = [store._records if mesh.rank == 0 else None]
    tdist.broadcast_object_list(box, group=mesh.group, device=mesh.device, group_src=0)
    store._records = box[0]


def _barrier(mesh) -> None:
    """Returns once every rank of `mesh` has reached it (the host reads an
    all-reduce, which completes only when every rank has entered it)."""
    int(rtd.psum(torch.ones((), dtype=torch.int32, device=mesh.device), mesh))
