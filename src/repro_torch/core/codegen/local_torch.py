"""Local (single-device) backend — the paper's OpenMP code generator, on PyTorch.

The port of `repro.core.codegen.local_jax`. `forall` over vertices →
whole-tensor ops with boolean-mask predication; neighbor loops → CSR
edge-tensor ops; reductions → segment/scatter combines; the Min/Max
construct → scatter-min; `forall(src in sourceSet)` → chunks of B sources
whose per-source properties are [B, N] tensors (`Schedule.batch_sources`),
or one source at a time where the body leaves the batched subset;
`iterateInBFS` / `iterateInReverse` → level-synchronous passes over the
BFS DAG; the nested neighbor loops of triangle counting → `rt.wedge_count`.
PyTorch runs eagerly, so `fixedPoint`, the `while` / `do-while` loops and
the set and BFS loops become Python loops: a `while` reads one device
scalar per trip, a BFS reads its depth once, and the push/pull switch is a
Python `if` on the frontier's occupancy. Generated code runs on the device
that holds the graph. Under `Schedule(priority="delta")` a Min-relax
fixedPoint is bucketed (delta-stepping), and programs with a top-level
iterative construct also get a `<name>__refresh` variant that warm-starts
it after `g.update()`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .. import ir as I
from ...graph.csr import resolve_schedule
from ...schedule import Schedule
from ..ir import written_vars
from .base import (BatchInfo, BFSCtx, CodegenError, EdgeCtx, Emitter,
                   ExprEmitter, HostCtx, VertexCtx, ctx_chain,
                   pure_vertex_predicate, relax_candidate)

_TORCH_DTYPE = {"int32": "torch.int32", "bool": "torch.bool",
                "float32": "torch.float32", "float64": "torch.float32"}
# float64 → float32, as in the reference (which runs with x64 disabled)

_RED = {"+": "+", "-": "-", "*": "*", "/": "/", "&&": "&", "||": "|"}


class LocalCodegen:
    backend_name = "local"
    VLEN = "N"
    # takes a `_dell` padded forward-ELL param for the delta-stepping compact
    # relax (rt.relax_minplus_delta); cuda relaxes through its own sliced
    # kernel op instead
    supports_delta_ell = True
    # per-source `while` / `do-while` loops inside a batched source-set
    # region lower to one lane-masked loop (converged lanes frozen); the
    # distributed backend keeps the sequential per-source loop instead (its
    # supersteps would need rank-uniform trip counts per lane)
    supports_batched_scalar_loops = True

    def __init__(self, irfn: I.IRFunction, schedule: Optional[Schedule] = None):
        self.f = irfn
        self.em = Emitter()
        self.ex = ExprEmitter(irfn, graph_var=irfn.graph_param)
        self.declared: List[str] = []      # ordered mutable host-scope vars
        self.dtypes = {}
        self.write_alias = {}              # fixedPoint redirects
        self.batch = None                  # active BatchInfo (batched set loop)
        self.lane_scalars = set()          # per-source scalars of the active
        #                                    set loop (host-scalar semantics
        #                                    per source; [B] when batched)
        self._delta_prop = None            # Min-relax prop of the active
        #                                    delta-stepping fixedPoint
        # every engine knob is baked into the emitted source as a literal:
        # same Schedule -> byte-identical source
        self.schedule = resolve_schedule(schedule)

    def _engine_kwargs(self) -> str:
        """`, threshold_frac=..., direction=...` literals for runtime calls."""
        s = self.schedule
        return (f", threshold_frac={s.push_threshold_frac!r}"
                f", direction={s.direction!r}")

    # ------------------------------------------------------------------ utils
    def dtype_of(self, name: str) -> Optional[str]:
        return self.dtypes.get(name)

    def bg(self, arr: str, idx: str) -> str:
        """Gather `arr[idx]`, batch-aware: arrays registered as [B, N] in the
        active batched region gather along the vertex axis (`arr[:, idx]`)."""
        if self.batch is not None and arr in self.batch.arrays:
            return f"{arr}[:, {idx}]"
        return f"{arr}[{idx}]"

    def _vmask(self, expr: str) -> str:
        """Materialize a vertex mask; inside a batched region every vertex
        mask is broadcast to [B, N] so downstream gathers/reductions see one
        uniform shape regardless of what the predicate read."""
        m = self.em.uid("vm")
        if self.batch is not None:
            self.em.w(f"{m} = torch.broadcast_to(torch.as_tensor({expr}, device=_dev), "
                      f"({self.batch.size}, {self.VLEN}))")
            self.batch.arrays.add(m)
        else:
            self.em.w(f"{m} = {expr}")
        return m

    def _snapshot(self):
        return (len(self.em.lines), self.em._uid, list(self.declared),
                dict(self.dtypes), dict(self.write_alias),
                set(self.lane_scalars))

    def _restore(self, state):
        nlines, uid, decl, dts, wa, ls = state
        del self.em.lines[nlines:]
        self.em._uid = uid
        self.declared[:] = decl
        self.dtypes = dts
        self.write_alias = wa
        self.lane_scalars = ls
        self.batch = None
        self.ex.batch = None

    def tdt(self, dtype: str) -> str:
        return _TORCH_DTYPE[dtype]

    def _scalar(self, expr: str, dtype: Optional[str] = None) -> str:
        """A 0-d tensor on the graph's device (the reference's jnp.asarray)."""
        dt = f", dtype={self.tdt(dtype)}" if dtype else ""
        return f"torch.as_tensor({expr}{dt}, device=_dev)"

    def declare(self, name: str, dtype: str):
        if name not in self.declared:
            self.declared.append(name)
        self.dtypes[name] = dtype

    def wtarget(self, prop: str) -> str:
        return self.write_alias.get(prop, prop)

    def carries(self, body) -> List[str]:
        wr = written_vars(body)
        return [v for v in self.declared if v in wr]

    def loop_body(self, stmts, ctx):
        """The statements of a Python loop's block, already opened by the
        caller (`pass` if they emit nothing)."""
        mark = len(self.em.lines)
        self.body(stmts, ctx)
        if len(self.em.lines) == mark:
            self.em.w("pass")

    # ---- delta-stepping detection (Schedule.priority == "delta") ------------
    def _delta_target(self, body) -> Optional[str]:
        """The value prop a delta-stepping lowering of this fixedPoint body
        would bucket on: the unique int32 Min-relax target (SSSP's dist,
        CC's comp). None when the knob is off or the body has no (or an
        ambiguous) monotonic Min relax."""
        if self.schedule.priority != "delta" or self.batch is not None:
            return None
        props = []

        def scan(stmts):
            for st in stmts:
                if isinstance(st, I.IMinMaxUpdate) and st.kind == "Min" and \
                        self.f.node_props.get(st.prop) == "int32":
                    if st.prop not in props:
                        props.append(st.prop)
                for attr in ("body", "then", "els", "rev_body"):
                    sub = getattr(st, attr, None)
                    if sub:
                        scan(sub)

        scan(body)
        return props[0] if len(props) == 1 else None

    def _wants_dell(self) -> bool:
        """True when the generated function should take the `_dell` padded
        forward-ELL param: some fixedPoint in the program lowers to
        delta-stepping and this backend relaxes through it."""
        if not self.supports_delta_ell:
            return False
        fps = []

        def scan(stmts):
            for st in stmts:
                if isinstance(st, I.IFixedPoint):
                    fps.append(st)
                for attr in ("body", "then", "els", "rev_body"):
                    sub = getattr(st, attr, None)
                    if sub:
                        scan(sub)

        scan(self.f.body)
        return any(self._delta_target(fp.body) is not None for fp in fps)

    # ------------------------------------------------------------------ entry
    # when True, `generate()` emits the `<name>__refresh` incremental
    # variant: same body, extra `_warm/_reset/_seed` params, and a
    # warm-override block right before the first top-level iterative
    # construct (see `_emit_warm_start`). Set on a FRESH codegen instance
    # by the `generate_*` factories — never flipped mid-generation.
    refresh_variant = False

    def _sig_head(self, args):
        # delta-stepping programs take the padded forward ELL view the
        # compact relax gathers frontier out-rows from (None = dense fallback)
        return [args[0]] + (["_dell=None"] if self._wants_dell() else [])

    def generate(self) -> str:
        f, em = self.f, self.em
        g = f.graph_param
        args = [p.name for p in f.params]
        name = f"{f.name}__refresh" if self.refresh_variant else f.name
        tail = ["_warm=None", "_reset=None", "_seed=None"] \
            if self.refresh_variant else []
        sig = ", ".join(self._sig_head(args)
                        + [f"{a}=None" for a in args[1:]] + tail)
        em.w(f"def {name}({sig}):")
        with em.block():
            em.w(f"N = {g}.num_nodes")
            em.w(f"_dev = {g}.device")
            em.w("_vids = torch.arange(N, dtype=torch.int32, device=_dev)")
            for p in f.params:
                if p.kind == "prop_node":
                    self.declare(p.name, p.dtype)
                    em.w(f"if {p.name} is None:")
                    with em.block():
                        em.w(f"{p.name} = rt.init_prop(N, {self.tdt(p.dtype)}, device=_dev)")
                elif p.kind == "scalar":
                    self.dtypes[p.name] = p.dtype
            warm_pending = self.refresh_variant
            for s in f.body:
                if warm_pending and isinstance(
                        s, (I.IFixedPoint, I.IDoWhile, I.IWhile)):
                    self._emit_warm_start(s)
                    warm_pending = False
                self.stmt(s, HostCtx())
            rets = ", ".join(f"'{v}': {v}" for v in self.declared)
            em.w(f"return {{{rets}}}")
        return em.source()

    def _emit_warm_start(self, s: I.IRStmt):
        """Warm-override block of a `__refresh` variant.

        Emitted AFTER the program's own init statements and immediately
        before the first top-level iterative construct, so source-level
        init writes (`src.dist = 0`) still stand for reset vertices:
        every node property falls back to its previous converged value
        except where `_reset` (the deletion cone) marks it stale, and for
        a fixedPoint with a boolean convergence prop the `_seed` frontier
        is OR-ed in so the first warm sweep relaxes exactly from the
        update-incident vertices."""
        em = self.em
        em.w("if _warm is not None:")
        with em.block():
            for p in self.declared:
                if p in self.f.node_props:
                    em.w(f"{p} = rt.warm_start({p}, _warm.get('{p}'), _reset)")
            if isinstance(s, I.IFixedPoint) and \
                    self.f.node_props.get(s.conv_prop) == "bool":
                em.w("if _seed is not None:")
                with em.block():
                    em.w(f"{s.conv_prop} = {s.conv_prop} "
                         f"| torch.as_tensor(_seed, device=_dev)")

    # ------------------------------------------------------------------ stmts
    def stmt(self, s: I.IRStmt, ctx):
        m = getattr(self, f"s_{type(s).__name__}", None)
        if m is None:
            raise CodegenError(f"{self.backend_name}: unhandled {type(s).__name__}")
        m(s, ctx)

    def body(self, stmts, ctx):
        for s in stmts:
            self.stmt(s, ctx)

    # ---- host-level -----------------------------------------------------------
    def s_IAttach(self, s: I.IAttach, ctx):
        if s.kind != "node":
            raise CodegenError("edge properties not yet supported in codegen")
        for prop, dtype, init in s.props:
            self.declare(prop, dtype)
            if self.batch is not None:
                # per-source property inside a batched set loop → [B, N]
                self.batch.arrays.add(prop)
                head = (f"{prop} = rt.init_prop_batch({self.batch.size}, {self.VLEN}, "
                        f"{self.tdt(dtype)}")
                if init is None:
                    self.em.w(f"{head}, device=_dev)")
                elif isinstance(init, I.IConst) and init.kind == "inf":
                    self.em.w(f"{head}, rt.inf_for({self.tdt(dtype)}), device=_dev)")
                else:
                    self.em.w(f"{head}, {self.ex.expr(init, ctx)}, device=_dev)")
                continue
            head = f"{prop} = rt.init_prop({self.VLEN}, {self.tdt(dtype)}"
            if init is None:
                self.em.w(f"{head}, device=_dev)")
            elif isinstance(init, I.IConst) and init.kind == "inf":
                self.em.w(f"{head}, rt.inf_for({self.tdt(dtype)}), device=_dev)")
            else:
                self.em.w(f"{head}, {self.ex.expr(init, ctx)}, device=_dev)")

    def s_IDeclScalar(self, s: I.IDeclScalar, ctx):
        em = self.em
        if s.vertex_local and self._vertex_ctx(ctx) is None \
                and self._edge_ctx(ctx) is None:
            # declared at set-loop body depth (outside any vertex/edge
            # region): a per-source "lane" scalar with host-scalar semantics
            # per source — a 0-d tensor in the sequential lowering, one [B]
            # slot per lane in a batched region
            self.lane_scalars.add(s.name)
            init = self.ex.expr(s.init, ctx) if s.init is not None else "0"
            if self.batch is not None:
                self.batch.lane_scalars.add(s.name)
                em.w(f"{s.name} = torch.broadcast_to({self._scalar(init, s.dtype)}, "
                     f"({self.batch.size},))")
            else:
                em.w(f"{s.name} = {self._scalar(init, s.dtype)}")
            self.declare(s.name, s.dtype)
            return
        if s.vertex_local:
            shape = (f"({self.batch.size}, {self.VLEN})" if self.batch is not None
                     else f"({self.VLEN},)")
            if s.init is None or isinstance(s.init, I.IConst):
                init = "0" if s.init is None else self.ex.expr(s.init, ctx)
                em.w(f"{s.name} = torch.full({shape}, {init}, "
                     f"dtype={self.tdt(s.dtype)}, device=_dev)")
            else:
                em.w(f"{s.name} = ({self.ex.expr(s.init, ctx)}) * torch.ones("
                     f"{shape}, dtype={self.tdt(s.dtype)}, device=_dev)")
            if self.batch is not None:
                self.batch.arrays.add(s.name)
            self.dtypes[s.name] = s.dtype
            return
        if self.batch is not None:
            raise CodegenError("host-scalar declaration inside a batched "
                               "source loop (per-source scalars unsupported)")
        init = self.ex.expr(s.init, ctx) if s.init is not None else "0"
        em.w(f"{s.name} = {self._scalar(init, s.dtype)}")
        self.declare(s.name, s.dtype)

    def s_ICopyProp(self, s: I.ICopyProp, ctx):
        if self.batch is not None:
            ba = self.batch.arrays
            if (s.dst in ba) != (s.src in ba):
                raise CodegenError("copy between batched and shared property")
        self.em.w(f"{self.wtarget(s.dst)} = {s.src}")

    def s_IWriteProp(self, s: I.IWriteProp, ctx):
        node = self.ex.expr(s.node, ctx)
        val = self.ex.expr(s.expr, ctx)
        p = self.wtarget(s.prop)
        if self.batch is not None:
            b = self.batch
            if s.prop not in b.arrays:
                raise CodegenError("single-node write to a shared property "
                                   "inside a batched source loop")
            if node != b.srcs2d:
                raise CodegenError("batched single-node write must target the "
                                   "set iterator")
            # lane-diagonal write: row b updates its own source vertex
            self.em.w(f"{p} = rt.set_at({p}, ({b.lane}, {b.srcs}), {val})")
            return
        self.em.w(f"{p} = rt.set_at({p}, {node}, {val})")

    def s_IAssign(self, s: I.IAssign, ctx):
        em = self.em
        e = self.ex.expr(s.expr, ctx)
        dt = self.dtype_of(s.name)
        cast = (lambda x: self._scalar(x, dt)) if dt else (lambda x: x)
        vctx = self._vertex_ctx(ctx)
        ectx = self._edge_ctx(ctx)
        if s.name in self.lane_scalars:
            return self._lane_scalar_assign(s, e, vctx, ectx)
        if s.reduce_op is None:
            if s.vertex_local:
                if vctx is not None and vctx.mask:
                    em.w(f"{s.name} = torch.where({vctx.mask}, {e}, {s.name})")
                else:
                    em.w(f"{s.name} = {e}")
            else:
                if self.batch is not None:
                    raise CodegenError("host-scalar assignment inside a "
                                       "batched source loop")
                em.w(f"{s.name} = {cast(e)}")
            return
        op = _RED[s.reduce_op]
        if s.vertex_local:
            if ectx is not None:
                # per-vertex accumulation over the neighborhood → segment op
                masked = f"torch.where({ectx.mask}, {e}, 0)" if ectx.mask else e
                if self.batch is not None:
                    em.w(f"{s.name} = {s.name} {op} rt.segment_sum_batch("
                         f"{self._bcast_edges(masked, ectx.seg)}, "
                         f"{ectx.seg}, {self.VLEN}, sorted_ids={ectx.seg_sorted})")
                else:
                    em.w(f"{s.name} = {s.name} {op} rt.segment_sum({masked}, {ectx.seg}, "
                         f"{self.VLEN}, sorted_ids={ectx.seg_sorted})")
            elif vctx is not None and vctx.mask:
                em.w(f"{s.name} = torch.where({vctx.mask}, {s.name} {op} ({e}), {s.name})")
            else:
                em.w(f"{s.name} = {s.name} {op} ({e})")
            return
        # host scalar reduction (paper Table 1) from a parallel region
        if self.batch is not None:
            if s.reduce_op != "+":
                raise CodegenError(f"host-scalar {s.reduce_op} reduction "
                                   "inside a batched source loop")
            valid = f"{self.batch.valid}[:, None]"
            if ectx is not None or vctx is not None:
                mask = (ectx or vctx).mask
                m = f"({mask}) & {valid}" if mask else valid
                em.w(f"{s.name} = {cast(f'{s.name} + torch.sum(torch.where({m}, {e}, 0))')}")
            else:
                raise CodegenError("host-scalar update outside any loop in a "
                                   "batched source loop")
            return
        if ectx is not None or vctx is not None:
            mask = (ectx or vctx).mask
            masked = f"torch.where({mask}, {e}, 0)" if mask else e
            em.w(f"{s.name} = {cast(f'{s.name} {op} torch.sum({masked})')}")
        else:
            em.w(f"{s.name} = {cast(f'{s.name} {op} ({e})')}")

    def _bcast_edges(self, expr: str, seg: str) -> str:
        """A per-edge expression of the batched region as [B, E] (a view)."""
        return (f"torch.broadcast_to(torch.as_tensor({expr}, device=_dev), "
                f"({self.batch.size},) + tuple({seg}.shape))")

    def _lane_scalar_assign(self, s: I.IAssign, e: str, vctx, ectx):
        """Assignment to a per-source lane scalar (declared at set-loop body
        depth): host-scalar reduction semantics per source. The sequential
        lowering is exactly the host-scalar paths; a batched region keeps a
        [B] lane axis — reductions from vertex/edge regions collapse the
        vertex/edge axis only, so each lane accumulates its own total."""
        em = self.em
        dt = self.dtype_of(s.name)
        cast = (lambda x: self._scalar(x, dt)) if dt else (lambda x: x)
        b = self.batch
        if s.reduce_op is None:
            if vctx is not None or ectx is not None:
                raise CodegenError(f"unsynchronized write to per-source "
                                   f"scalar {s.name} from a parallel region")
            if b is not None:
                em.w(f"{s.name} = torch.broadcast_to({cast(e)}, ({b.size},))")
            else:
                em.w(f"{s.name} = {cast(e)}")
            return
        op = _RED[s.reduce_op]
        if b is None:
            if ectx is not None or vctx is not None:
                mask = (ectx or vctx).mask
                masked = f"torch.where({mask}, {e}, 0)" if mask else e
                em.w(f"{s.name} = {cast(f'{s.name} {op} torch.sum({masked})')}")
            else:
                em.w(f"{s.name} = {cast(f'{s.name} {op} ({e})')}")
            return
        if ectx is None and vctx is None:
            # set-body level: every lane applies the same scalar update
            em.w(f"{s.name} = {cast(f'{s.name} {op} ({e})')}")
            return
        if s.reduce_op != "+":
            raise CodegenError(
                f"per-source scalar {s.reduce_op} reduction from a parallel "
                "region inside a batched source loop")
        if ectx is not None:
            masked = f"torch.where({ectx.mask}, {e}, 0)" if ectx.mask else e
            body = self._bcast_edges(masked, ectx.seg)
        else:
            masked = f"torch.where({vctx.mask}, {e}, 0)" if vctx.mask else e
            body = (f"torch.broadcast_to(torch.as_tensor({masked}, device=_dev), "
                    f"({b.size}, {self.VLEN}))")
        em.w(f"{s.name} = {cast(f'{s.name} + torch.sum({body}, dim=1)')}")

    # ---- loops ------------------------------------------------------------------
    def _vertex_ctx(self, ctx):
        for c in ctx_chain(ctx):
            if isinstance(c, (VertexCtx, BFSCtx)):
                return c
        return None

    def _edge_ctx(self, ctx):
        for c in ctx_chain(ctx):
            if isinstance(c, EdgeCtx):
                return c
        return None

    def s_IVertexLoop(self, s: I.IVertexLoop, ctx):
        mask = None
        if s.filter is not None:
            mask = self._vmask(
                self.ex.expr(s.filter, VertexCtx(it=s.it, mask=None, parent=ctx)))
        vctx = VertexCtx(it=s.it, mask=mask, parent=ctx)
        self.body(s.body, vctx)

    def s_INbrLoop(self, s: I.INbrLoop, ctx):
        em = self.em
        g = self.f.graph_param
        vctx = self._vertex_ctx(ctx)
        if vctx is None:
            raise CodegenError("neighbor loop outside a vertex context")
        # wedge pattern (TC): nested neighbor loop over the same source
        if self._try_wedge(s, ctx):
            return
        if isinstance(vctx, BFSCtx):
            return self._bfs_nbr_loop(s, ctx, vctx)
        if s.direction == "out":
            ectx = EdgeCtx(it=s.it, source=s.source, direction="out",
                           vid=f"{g}.edge_src", nid=f"{g}.indices",
                           w=f"{g}.weights", seg=f"{g}.edge_src",
                           seg_sorted=True, mask=None, parent=ctx)
        else:
            ectx = EdgeCtx(it=s.it, source=s.source, direction="in",
                           vid=f"{g}.rev_edge_dst", nid=f"{g}.rev_indices",
                           w=f"{g}.rev_weights", seg=f"{g}.rev_edge_dst",
                           seg_sorted=True, mask=None, parent=ctx)
        terms = []
        pure = True
        if vctx.mask:
            terms.append(self.bg(vctx.mask, ectx.vid))
            ectx.src_vmask = vctx.mask
        if s.filter is not None:
            if pure_vertex_predicate(s.filter, s.it):
                # neighbor-side filter that only reads nbr-props: hoist it to
                # one [N] vertex mask (the frontier the engine switches on)
                nm = self._vmask(
                    self.ex.expr(s.filter, VertexCtx(it=s.it, mask=None, parent=ctx)))
                terms.append(self.bg(nm, ectx.nid))
                ectx.it_vmask = nm
            else:
                terms.append(self.ex.expr(s.filter, ectx))
                pure = False
        ectx.pure_frontier = pure
        if terms:
            # mirrors the reference's generated source, where this edge
            # mask is built even when the relax below never reads it
            mask = em.uid("em")
            em.w(f"{mask} = {' & '.join(terms)}")
            ectx.mask = mask
        self.body(s.body, ectx)

    def _bfs_nbr_loop(self, s: I.INbrLoop, ctx, bctx: BFSCtx):
        """neighbors() inside iterateInBFS = BFS-DAG successors (paper §2.3.2)."""
        em = self.em
        g = self.f.graph_param
        if s.direction != "out":
            raise CodegenError("only neighbors() supported inside iterateInBFS")
        ectx = EdgeCtx(it=s.it, source=s.source, direction="out",
                       vid=f"{g}.edge_src", nid=f"{g}.indices",
                       w=f"{g}.weights", seg=f"{g}.edge_src",
                       seg_sorted=True, mask=None, parent=ctx)
        terms = [f"({self.bg(bctx.level, ectx.vid)} == {bctx.cur})",
                 f"({self.bg(bctx.level, ectx.nid)} == ({bctx.cur} + 1))"]
        if bctx.mask:
            terms.append(self.bg(bctx.mask, ectx.vid))
        if s.filter is not None:
            terms.append(self.ex.expr(s.filter, ectx))
        mask = em.uid("em")
        em.w(f"{mask} = {' & '.join(terms)}")
        ectx.mask = mask
        self.body(s.body, ectx)

    # ---- in-loop writes -------------------------------------------------------
    def s_IAssignProp(self, s: I.IAssignProp, ctx):
        em = self.em
        ectx = self._edge_ctx(ctx)
        vctx = self._vertex_ctx(ctx)
        p = self.wtarget(s.prop)
        e = self.ex.expr(s.expr, ctx)
        if self.batch is not None:
            return self._batched_assign_prop(s, ectx, vctx, p, e)
        if ectx is not None:
            if s.reduce_op is None:
                raise CodegenError(
                    f"unsynchronized per-edge write to {s.prop}; use a "
                    "reduction or the Min/Max construct")
            if s.reduce_op not in ("+", "||", "&&"):
                raise CodegenError(f"unsupported edge reduction {s.reduce_op}")
            masked = f"torch.where({ectx.mask}, {e}, 0)" if ectx.mask else e
            if s.target == ectx.source:
                # pull: reduce over the neighborhood into the source vertex
                em.w(f"{p} = {p} + rt.segment_sum({masked}, {ectx.seg}, {self.VLEN}, "
                     f"sorted_ids={ectx.seg_sorted})")
            else:
                # push: combine into the neighbor (paper: atomics; here scatter)
                em.w(f"{p} = {p} + rt.segment_sum({masked}, {ectx.nid}, N, sorted_ids=False)")
            return
        if vctx is None:
            raise CodegenError("property assignment outside any loop")
        if s.reduce_op is None:
            if vctx.mask:
                em.w(f"{p} = torch.where({vctx.mask}, {e}, {p})")
            else:
                # broadcast keeps scalar rhs (v.modified = True) tensor-shaped
                em.w(f"{p} = torch.broadcast_to(torch.as_tensor({e}, dtype={p}.dtype, "
                     f"device=_dev), {p}.shape)")
        else:
            op = _RED[s.reduce_op]
            if vctx.mask:
                em.w(f"{p} = torch.where({vctx.mask}, {p} {op} ({e}), {p})")
            else:
                em.w(f"{p} = {p} {op} ({e})")

    def _batched_assign_prop(self, s: I.IAssignProp, ectx, vctx, p: str, e: str):
        """Property write inside a batched source-set region.

        Batched ([B, N]) targets take the sequential lowering with the batch
        axis along for the ride (masks are [B, *], segment ops use the
        `_batch` variants). SHARED ([N]) targets collapse the lane axis with
        a `+` reduction masked to the chunk's valid lanes — the per-source
        contributions of the parallel `forall(src in sourceSet)`."""
        em = self.em
        b = self.batch
        batched_target = s.prop in b.arrays
        if ectx is not None:
            if s.reduce_op is None:
                raise CodegenError(
                    f"unsynchronized per-edge write to {s.prop}; use a "
                    "reduction or the Min/Max construct")
            if s.reduce_op != "+":
                raise CodegenError(f"unsupported batched edge reduction {s.reduce_op}")
            seg = ectx.seg if s.target == ectx.source else ectx.nid
            sorted_ = ectx.seg_sorted if s.target == ectx.source else False
            if batched_target:
                masked = f"torch.where({ectx.mask}, {e}, 0)" if ectx.mask else e
                em.w(f"{p} = {p} + rt.segment_sum_batch({self._bcast_edges(masked, seg)}, "
                     f"{seg}, {self.VLEN}, sorted_ids={sorted_})")
            else:
                m = (f"({ectx.mask}) & {b.valid}[:, None]" if ectx.mask
                     else f"{b.valid}[:, None]")
                em.w(f"{p} = {p} + rt.segment_sum(torch.sum("
                     f"{self._bcast_edges(f'torch.where({m}, {e}, 0)', seg)}, dim=0), "
                     f"{seg}, {self.VLEN}, sorted_ids={sorted_})")
            return
        if vctx is None:
            raise CodegenError("property assignment outside any loop")
        if batched_target:
            if s.reduce_op is None:
                if vctx.mask:
                    em.w(f"{p} = torch.where({vctx.mask}, {e}, {p})")
                else:
                    em.w(f"{p} = torch.broadcast_to(torch.as_tensor({e}, dtype={p}.dtype, "
                         f"device=_dev), {p}.shape)")
            else:
                op = _RED[s.reduce_op]
                if vctx.mask:
                    em.w(f"{p} = torch.where({vctx.mask}, {p} {op} ({e}), {p})")
                else:
                    em.w(f"{p} = {p} {op} ({e})")
            return
        # shared [N] target: collapse the lane axis (valid lanes only)
        if s.reduce_op != "+":
            raise CodegenError(
                f"write to shared property {s.prop} inside a batched source "
                f"loop needs a '+' reduction (got {s.reduce_op!r})")
        m = (f"({vctx.mask}) & {b.valid}[:, None]" if vctx.mask
             else f"{b.valid}[:, None]")
        em.w(f"{p} = {p} + torch.sum(torch.where({m}, {e}, 0), dim=0)")

    def _hybrid_frontier(self, s: I.IMinMaxUpdate, ectx):
        """Detect the frontier-relax pattern `Min(t.p, other.p [+ e.weight])`
        where the contributing side is masked by nothing but a per-vertex
        frontier. Returns (applicable, frontier_var_or_None, weighted)."""
        if s.kind != "Min" or not ectx.pure_frontier:
            return False, None, True
        if self.f.node_props.get(s.prop) != "int32":
            return False, None, True
        if s.target == ectx.it and ectx.direction == "out":
            # push form: the outer vertex contributes along its out-edges
            other, frontier = ectx.source, ectx.src_vmask
            if ectx.it_vmask is not None:
                return False, None, True    # extra mask on the landing side
        elif s.target == ectx.source and ectx.direction == "in":
            # pull form: in-neighbors contribute into the outer vertex
            other, frontier = ectx.it, ectx.it_vmask
            if ectx.src_vmask is not None:
                return False, None, True
        else:
            return False, None, True
        cand = relax_candidate(s.cand, other)
        if cand is None or cand[0] != s.prop:
            return False, None, True
        return True, frontier, cand[1]

    def emit_relax_hybrid(self, s: I.IMinMaxUpdate, frontier,
                          weighted: bool = True):
        """Direction-optimized relax step: push (scatter-min from frontier
        sources) vs pull (segment-min over in-edges), chosen on the host by
        frontier occupancy — or pinned by `Schedule.direction`; both
        branches compute the identical relaxation. Emitted inline (the same
        computation as rt.relax_minplus_hybrid — keep in sync) so the
        generated source shows the full lowering.

        Inside a delta-stepping fixedPoint (`frontier` is the bucketed
        window) the relax goes through `rt.relax_minplus_delta` instead:
        same relaxation, but a frontier that fits the compact cap relaxes
        only its gathered ELL out-rows."""
        em = self.em
        g = self.f.graph_param
        sched = self.schedule
        new = em.uid("new")
        if frontier is None:
            em.w(f"{new} = rt.relax_minplus_hybrid({g}, {s.prop}, None"
                 f"{'' if weighted else ', weighted=False'})")
            return new
        if self._delta_prop == s.prop and self.supports_delta_ell:
            em.w(f"{new} = rt.relax_minplus_delta({g}, {s.prop}, {frontier}, "
                 f"_dell, max(min(N // 8, 4096), 32){self._engine_kwargs()}"
                 f"{'' if weighted else ', weighted=False'})")
            return new
        wexp = lambda w: f" + {w}" if weighted else ""  # noqa: E731
        push, pull = em.uid("push"), em.uid("pull")
        if sched.direction != "pull":
            em.w(f"{push} = lambda _d: rt.scatter_min(_d, {g}.indices, "
                 f"torch.where({frontier}[{g}.edge_src], "
                 f"_d[{g}.edge_src]{wexp(f'{g}.weights')}, rt.INF))")
        if sched.direction != "push":
            em.w(f"{pull} = lambda _d: torch.minimum(_d, rt.segment_min("
                 f"torch.where({frontier}[{g}.rev_indices], "
                 f"_d[{g}.rev_indices]{wexp(f'{g}.rev_weights')}, rt.INF), "
                 f"{g}.rev_edge_dst, {self.VLEN}))")
        if sched.direction == "push":
            em.w(f"{new} = {push}({s.prop})")
        elif sched.direction == "pull":
            em.w(f"{new} = {pull}({s.prop})")
        else:
            em.w(f"{new} = ({push} if rt.frontier_should_push({frontier}, "
                 f"{self.VLEN}, {sched.push_threshold_frac!r}) else {pull})"
                 f"({s.prop})")
        return new

    def s_IMinMaxUpdate(self, s: I.IMinMaxUpdate, ctx):
        em = self.em
        if self.batch is not None:
            raise CodegenError("Min/Max construct inside a batched source "
                               "loop (falls back to the sequential lowering)")
        ectx = self._edge_ctx(ctx)
        if ectx is None:
            raise CodegenError("Min/Max update outside a neighbor loop")
        p = self.wtarget(s.prop)
        dtype = self.f.node_props.get(s.prop, "int32")
        ok, frontier, weighted = self._hybrid_frontier(s, ectx)
        if ok:
            new = self.emit_relax_hybrid(s, frontier, weighted)
            upd = em.uid("upd")
            em.w(f"{upd} = {new} < {s.prop}")
            em.w(f"{p} = {new}" if p == s.prop else
                 f"{p} = torch.where({upd}, {new}, {p})")
            for eprop, _etgt, eval_ in s.extras:
                ep = self.wtarget(eprop)
                ev = self.ex.expr(eval_, HostCtx())
                em.w(f"{ep} = torch.where({upd}, {ev}, {ep})")
            return
        cand = self.ex.expr(s.cand, ctx)
        cv = em.uid("cand")
        inf = f"rt.inf_for({self.tdt(dtype)})"
        ident = inf if s.kind == "Min" else f"-{inf}"
        if ectx.mask:
            em.w(f"{cv} = torch.where({ectx.mask}, {cand}, {ident})")
        else:
            em.w(f"{cv} = {cand}")
        new = em.uid("new")
        if s.target == ectx.it:        # push: update lands on the neighbor
            fn = "rt.scatter_min" if s.kind == "Min" else "rt.scatter_max"
            em.w(f"{new} = {fn}({s.prop}, {ectx.nid}, {cv})")
        elif s.target == ectx.source:  # pull: reduce into the source vertex
            fn = "rt.segment_min" if s.kind == "Min" else "rt.segment_max"
            mm = "torch.minimum" if s.kind == "Min" else "torch.maximum"
            em.w(f"{new} = {mm}({s.prop}, {fn}({cv}, {ectx.seg}, {self.VLEN}, "
                 f"sorted_ids={ectx.seg_sorted}))")
        else:
            raise CodegenError(f"Min/Max target {s.target} not an endpoint of the loop")
        upd = em.uid("upd")
        cmp = "<" if s.kind == "Min" else ">"
        em.w(f"{upd} = {new} {cmp} {s.prop}")
        em.w(f"{p} = {new}" if p == s.prop else
             f"{p} = torch.where({upd}, {new}, {p})")
        for eprop, _etgt, eval_ in s.extras:
            ep = self.wtarget(eprop)
            ev = self.ex.expr(eval_, HostCtx())  # vertex-uniform (True/False/const)
            em.w(f"{ep} = torch.where({upd}, {ev}, {ep})")

    # ---- control flow ------------------------------------------------------------
    def s_IIf(self, s: I.IIf, ctx):
        ectx = self._edge_ctx(ctx)
        vctx = self._vertex_ctx(ctx)
        em = self.em
        if ectx is not None:
            mask = em.uid("em")
            cond = self.ex.expr(s.cond, ctx)
            em.w(f"{mask} = {f'{ectx.mask} & ' if ectx.mask else ''}{cond}")
            sub = dataclasses.replace(ectx, mask=mask, pure_frontier=False)
            self.body(s.then, sub)
            if s.els:
                raise CodegenError("else in edge context unsupported")
            return
        if vctx is not None:
            cond = self.ex.expr(s.cond, ctx)
            mask = self._vmask(f"{f'{vctx.mask} & ' if vctx.mask else ''}{cond}")
            sub = dataclasses.replace(vctx, mask=mask)
            self.body(s.then, sub)
            if s.els:
                raise CodegenError("else in vertex context unsupported")
            return
        raise CodegenError("host-level if unsupported (use fixedPoint/do-while)")

    def s_IFixedPoint(self, s: I.IFixedPoint, ctx):
        """`fixedPoint until (var : !conv)` → a host `while` that reads the
        on-device `finished` flag once per trip (a bool tensor: in Python
        `~False == -1`). Under delta-stepping the bucket index is a 0-d
        device tensor, so the bucket advance adds no host read."""
        em = self.em
        if self.batch is not None:
            raise CodegenError("fixedPoint inside a batched source loop")
        conv = s.conv_prop
        delta = self._delta_target(s.body)
        if delta is not None and (delta == conv or
                                  self.f.node_props.get(conv) != "bool"):
            delta = None    # bucketing needs a bool pending-mask conv prop
        self.declare(s.var, "bool")
        em.w(f"{s.var} = torch.as_tensor(False, device=_dev)")
        n = em.uid("fp")
        if delta is not None:
            em.w(f"{n}_bk = torch.zeros((), dtype=torch.int32, device=_dev)")
        em.w(f"while not bool({s.var}):")
        with em.block():
            if delta is None:
                em.w(f"{conv}_nxt = torch.zeros_like({conv})")
            else:
                # delta-stepping: the sweep's frontier is the pending set
                # restricted to the current bucket window; out-of-window
                # pending vertices seed the next sweep's pending set
                self._emit_delta_preamble(n, delta, conv)
                em.w(f"{conv}_nxt = {n}_keep")
            saved = dict(self.write_alias)
            self.write_alias[conv] = f"{conv}_nxt"
            prev_dprop = self._delta_prop
            self._delta_prop = delta
            try:
                self.body(s.body, ctx)
            finally:
                self._delta_prop = prev_dprop
                self.write_alias = saved
            em.w(f"{conv} = {conv}_nxt")
            self.emit_finished(s.var, conv)

    def _emit_delta_preamble(self, n: str, vprop: str, conv: str):
        """Bucketed-frontier preamble of a delta-stepping fixedPoint body.

        The window is upper-bound-only — `value < (bk + 1) * Δ` — so values
        that move backwards into earlier buckets (CC's component min) stay
        in the window; the fused advance jumps `bk` straight to the bucket
        of the smallest pending value, so no sweep relaxes an empty
        frontier. Rebinding `conv` to the windowed frontier makes every
        downstream filter/relax emission see the bucketed frontier."""
        em = self.em
        d = self.schedule.delta_bucket
        em.w(f"{n}_bk = torch.where("
             f"{self._delta_any(f'{conv} & ({vprop} < ({n}_bk + 1) * {d})')}, "
             f"{n}_bk, "
             f"{self._delta_min(f'torch.where({conv}, {vprop}, rt.INF)')} // {d})")
        em.w(f"{n}_fr = {conv} & ({vprop} < ({n}_bk + 1) * {d})")
        em.w(f"{n}_keep = {conv} & ~{n}_fr")
        em.w(f"{conv} = {n}_fr")

    def _delta_any(self, expr: str) -> str:
        return f"torch.any({expr})"

    def _delta_min(self, expr: str) -> str:
        return f"torch.amin({expr})"

    def emit_finished(self, var: str, conv: str):
        self.em.w(f"{var} = ~torch.any({conv})")

    def s_IDoWhile(self, s: I.IDoWhile, ctx):
        """`do { body } while (cond)` → the body, then one host read of the
        condition per trip."""
        em = self.em
        if self.batch is not None:
            if not self.supports_batched_scalar_loops:
                raise CodegenError("do-while inside a batched source loop")
            return self._batched_scalar_loop(s, ctx, do_while=True)
        em.w("while True:")
        with em.block():
            self.body(s.body, ctx)
            em.w(f"if not bool({self.ex.expr(s.cond, ctx)}):")
            with em.block():
                em.w("break")

    def s_IWhile(self, s: I.IWhile, ctx):
        em = self.em
        if self.batch is not None:
            if not self.supports_batched_scalar_loops:
                raise CodegenError("while inside a batched source loop")
            return self._batched_scalar_loop(s, ctx, do_while=False)
        em.w(f"while bool({self.ex.expr(s.cond, ctx)}):")
        with em.block():
            self.loop_body(s.body, ctx)

    def _batched_scalar_loop(self, s, ctx, do_while: bool):
        """Per-source `while` / `do-while` inside a BATCHED source-set
        region: all B lanes run one loop. The condition evaluates per lane
        (lane scalars read as [B] at host level); the loop runs while ANY
        lane is still active (one host read per trip), and lanes that
        already converged are FROZEN — every carried per-source value
        ([B, N] property or [B] lane scalar) rolls back to its previous
        value on inactive lanes after each sweep, so an early-converging
        lane keeps exactly the state it converged to."""
        em = self.em
        b = self.batch
        carry = self.carries(s.body)
        if not carry:
            raise CodegenError("batched per-source loop carries no state")
        for v in carry:
            if v not in b.arrays and v not in b.lane_scalars:
                raise CodegenError(
                    f"batched per-source loop writes shared state {v} "
                    "(falls back to the sequential lowering)")
        cond = self.ex.expr(s.cond, ctx)
        n = em.uid("bdw" if do_while else "bwl")
        first = f"{n}_first"
        if do_while:
            em.w(f"{first} = True")
            em.w(f"while {first} or bool(torch.any({cond})):")
        else:
            em.w(f"while bool(torch.any({cond})):")
        with em.block():
            act = f"{first} | ({cond})" if do_while else cond
            em.w(f"{n}_act = torch.broadcast_to(torch.as_tensor({act}, device=_dev), "
                 f"({b.size},))")
            for v in carry:
                em.w(f"{n}_p_{v} = {v}")
            self.body(s.body, ctx)
            for v in carry:
                sel = f"{n}_act" if v in b.lane_scalars else f"{n}_act[:, None]"
                em.w(f"{v} = torch.where({sel}, {v}, {n}_p_{v})")
            if do_while:
                em.w(f"{first} = False")

    def s_ISetLoop(self, s: I.ISetLoop, ctx):
        bs = self.schedule.batch_sources
        if self.batch is None and bs > 1:
            state = self._snapshot()
            try:
                return self._batched_set_loop(s, ctx, int(bs))
            except CodegenError:
                # pattern outside the batched subset (fixedPoint, Min/Max,
                # per-source scalars, ...): fall back to the sequential loop
                self._restore(state)
        self._sequential_set_loop(s, ctx)

    def _sequential_set_loop(self, s: I.ISetLoop, ctx):
        em = self.em
        mark = len(self.declared)
        saved_ls = set(self.lane_scalars)
        # the empty-set guard of the reference (whose fori_loop traces its
        # body even for a zero trip count)
        em.w(f"if {s.set_name}.shape[0]:")
        with em.block():
            em.w(f"for _i in range({s.set_name}.shape[0]):")
            with em.block():
                em.w(f"{s.it} = {s.set_name}[_i]")
                hctx = HostCtx()
                hctx.node_bindings[s.it] = s.it
                try:
                    self.body(s.body, hctx)
                finally:
                    self.lane_scalars = saved_ls
        del self.declared[mark:]   # loop-local props don't escape

    def _batched_set_loop(self, s: I.ISetLoop, ctx, bs: int):
        """`forall(src in sourceSet)` as ceil(S/B) chunked BATCHED passes:
        each chunk traverses B sources at once (per-source [N] properties
        become [B, N] tensors) and reduces its contribution into the shared
        properties. The final partial chunk is padded with repeats of the
        last source and masked out of every shared-property reduction, so
        S need not divide B."""
        em = self.em
        ss = s.set_name
        n = em.uid("bset")
        B, lane, srcs, ok = f"{n}_B", f"{n}_lane", f"{n}_src", f"{n}_ok"
        mark = len(self.declared)
        em.w(f"{B} = max(min({bs}, {ss}.shape[0]), 1)")
        em.w(f"if {ss}.shape[0]:")
        with em.block():
            em.w(f"for _c in range(-(-{ss}.shape[0] // {B})):")
            with em.block():
                em.w(f"{n}_idx = _c * {B} + torch.arange({B}, dtype=torch.int32, device=_dev)")
                em.w(f"{ok} = {n}_idx < {ss}.shape[0]")
                em.w(f"{srcs} = {ss}[torch.clamp({n}_idx, 0, {ss}.shape[0] - 1)]")
                em.w(f"{lane} = torch.arange({B}, dtype=torch.int32, device=_dev)")
                info = BatchInfo(size=B, lane=lane, srcs=srcs,
                                 srcs2d=f"{srcs}[:, None]", valid=ok, it=s.it)
                self.batch = info
                self.ex.batch = info
                saved_ls = set(self.lane_scalars)
                hctx = HostCtx()
                hctx.node_bindings[s.it] = info.srcs2d
                try:
                    self.body(s.body, hctx)
                finally:
                    self.batch = None
                    self.ex.batch = None
                    self.lane_scalars = saved_ls
        del self.declared[mark:]   # loop-local props don't escape

    def s_IBFS(self, s: I.IBFS, ctx):
        """iterateInBFS: one (batched) BFS, then a forward pass over its
        levels and, with iterateInReverse, a reverse pass; the depth is a
        host int, read once per BFS."""
        em = self.em
        g = self.f.graph_param
        root = self.ex.expr(s.root, ctx)
        lvl = em.uid("level")
        dep = em.uid("depth")
        if self.batch is not None:
            if root != self.batch.srcs2d:
                raise CodegenError("batched iterateInBFS root must be the "
                                   "set iterator")
            # one batched BFS: level[b] == bfs_levels(g, srcs[b]); depth is
            # the deepest lane's count — shallower lanes see empty frontiers
            em.w(f"{lvl}, {dep} = rt.bfs_levels_batch({g}, {self.batch.srcs}"
                 f"{self._engine_kwargs()})")
            self.batch.arrays.add(lvl)
        else:
            em.w(f"{lvl}, {dep} = rt.bfs_levels({g}, {root}"
                 f"{self._engine_kwargs()})")
        # forward pass: level-synchronous over the BFS DAG
        em.w(f"for _l in range({dep} - 1):")
        with em.block():
            bctx = BFSCtx(it=s.it, level=lvl, cur="_l", mask=None, parent=ctx)
            self.loop_body(s.body, bctx)
        if s.rev_body is None:
            return
        # reverse pass: levels from deepest-1 down to 0
        em.w(f"for _k in range({dep} - 1):")
        with em.block():
            em.w(f"_l = {dep} - 2 - _k")
            vm = self._vmask(f"({lvl} == _l)")
            bctx = BFSCtx(it=s.it, level=lvl, cur="_l", mask=vm, parent=ctx)
            if s.rev_filter is not None:
                em.w(f"{vm} = {vm} & ({self.ex.expr(s.rev_filter, bctx)})")
            self.body(s.rev_body, bctx)

    def s_IReturn(self, s: I.IReturn, ctx):
        pass  # outputs are returned as the property/scalar dict

    # ---- wedge (TC) pattern ------------------------------------------------------
    def _try_wedge(self, s: I.INbrLoop, ctx) -> bool:
        inner = s.body[0] if len(s.body) == 1 and isinstance(s.body[0], I.INbrLoop) else None
        if inner is None or inner.source != s.source or s.direction != "out" \
                or inner.direction != "out":
            return False
        iff = inner.body[0] if len(inner.body) == 1 and isinstance(inner.body[0], I.IIf) else None
        if iff is None or not isinstance(iff.cond, I.ICall) or iff.cond.fn != "is_an_edge":
            raise CodegenError("nested same-source neighbor loops support only "
                               "the is_an_edge counting pattern (paper Fig. 20)")
        red = iff.then[0] if len(iff.then) == 1 and isinstance(iff.then[0], I.IAssign) else None
        if red is None or red.reduce_op != "+":
            raise CodegenError("wedge body must be a count reduction")
        if self.batch is not None:
            raise CodegenError("wedge pattern inside a batched source loop")
        g = self.f.graph_param
        dt = self.dtype_of(red.name)
        acc = f"{red.name} + rt.wedge_count({g}) * ({self.ex.expr(red.expr, HostCtx())})"
        self.em.w(f"{red.name} = {self._scalar(acc, dt)}" if dt else
                  f"{red.name} = {acc}")
        return True


def has_refresh_variant(irfn: I.IRFunction) -> bool:
    """True when a `<name>__refresh` incremental variant is emitted next to
    the program: the body has a TOP-LEVEL iterative construct to
    warm-start. Programs whose loops live inside a set loop (BC's
    per-source BFS) or that have no loop at all (TC) get no variant."""
    return any(isinstance(s, (I.IFixedPoint, I.IDoWhile, I.IWhile))
               for s in irfn.body)


def generate_local(irfn: I.IRFunction, schedule: Optional[Schedule] = None) -> str:
    """Emit the local-backend source under `schedule` (default: the ENGINE
    shim's snapshot). Every knob is baked in as a literal — the same
    schedule yields byte-identical source. Programs with a top-level
    iterative construct additionally carry a `<name>__refresh` variant
    (a fresh codegen instance: emitter/declared state is per-function)."""
    src = LocalCodegen(irfn, schedule=schedule).generate()
    if has_refresh_variant(irfn):
        cg = LocalCodegen(irfn, schedule=schedule)
        cg.refresh_variant = True
        src = src + "\n\n" + cg.generate()
    return src
