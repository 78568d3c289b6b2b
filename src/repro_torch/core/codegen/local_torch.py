"""Local (single-device) backend — the paper's OpenMP code generator, on PyTorch.

The port of `repro.core.codegen.local_jax`, limited to the constructs the
bundled `sssp`, `sssp_pull` and `pr` programs use. `forall` over vertices →
whole-tensor ops with boolean-mask predication; neighbor loops → CSR
edge-tensor ops; reductions → segment/scatter combines; the Min/Max
construct → scatter-min. PyTorch runs eagerly, so `fixedPoint` and the
`while` / `do-while` loops become Python loops that read one device scalar
per trip, and the push/pull switch is a Python `if` on the frontier's
occupancy. Generated code runs on the device that holds the graph.

Constructs that later slices port raise `NotImplementedError` naming the
construct and its ROADMAP item — never `CodegenError`, so a missing port
is never mistaken for a pattern that falls back to another lowering.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .. import ir as I
from ...graph.csr import resolve_schedule
from ...schedule import Schedule
from .base import (CodegenError, EdgeCtx, Emitter, ExprEmitter, HostCtx,
                   VertexCtx, ctx_chain, pure_vertex_predicate,
                   relax_candidate)

_TORCH_DTYPE = {"int32": "torch.int32", "bool": "torch.bool",
                "float32": "torch.float32", "float64": "torch.float32"}
# float64 → float32, as in the reference (which runs with x64 disabled)

_RED = {"+": "+", "-": "-", "*": "*", "/": "/", "&&": "&", "||": "|"}


def not_ported(construct: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{construct} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


class LocalCodegen:
    backend_name = "local"
    VLEN = "N"

    def __init__(self, irfn: I.IRFunction, schedule: Optional[Schedule] = None):
        self.f = irfn
        self.em = Emitter()
        self.ex = ExprEmitter(irfn, graph_var=irfn.graph_param)
        self.declared: List[str] = []      # ordered mutable host-scope vars
        self.dtypes = {}
        self.write_alias = {}              # fixedPoint redirects
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

    def _vmask(self, expr: str) -> str:
        m = self.em.uid("vm")
        self.em.w(f"{m} = {expr}")
        return m

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

    # ------------------------------------------------------------------ entry
    def _sig_head(self, args):
        return [args[0]]

    def generate(self) -> str:
        if self.schedule.priority == "delta":
            raise not_ported('Schedule(priority="delta") (delta-stepping)', "7")
        f, em = self.f, self.em
        g = f.graph_param
        args = [p.name for p in f.params]
        sig = ", ".join(self._sig_head(args) + [f"{a}=None" for a in args[1:]])
        em.w(f"def {f.name}({sig}):")
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
            for s in f.body:
                self.stmt(s, HostCtx())
            rets = ", ".join(f"'{v}': {v}" for v in self.declared)
            em.w(f"return {{{rets}}}")
        return em.source()

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
            if init is None:
                self.em.w(f"{prop} = rt.init_prop(N, {self.tdt(dtype)}, device=_dev)")
            elif isinstance(init, I.IConst) and init.kind == "inf":
                self.em.w(f"{prop} = rt.init_prop(N, {self.tdt(dtype)}, "
                          f"rt.inf_for({self.tdt(dtype)}), device=_dev)")
            else:
                self.em.w(f"{prop} = rt.init_prop(N, {self.tdt(dtype)}, "
                          f"{self.ex.expr(init, ctx)}, device=_dev)")

    def s_IDeclScalar(self, s: I.IDeclScalar, ctx):
        em = self.em
        if s.vertex_local and self._vertex_ctx(ctx) is None \
                and self._edge_ctx(ctx) is None:
            raise not_ported("a per-source scalar of a source-set loop", "5")
        if s.vertex_local:
            if s.init is None or isinstance(s.init, I.IConst):
                init = "0" if s.init is None else self.ex.expr(s.init, ctx)
                em.w(f"{s.name} = torch.full(({self.VLEN},), {init}, "
                     f"dtype={self.tdt(s.dtype)}, device=_dev)")
            else:
                em.w(f"{s.name} = ({self.ex.expr(s.init, ctx)}) * torch.ones("
                     f"({self.VLEN},), dtype={self.tdt(s.dtype)}, device=_dev)")
            self.dtypes[s.name] = s.dtype
            return
        init = self.ex.expr(s.init, ctx) if s.init is not None else "0"
        em.w(f"{s.name} = {self._scalar(init, s.dtype)}")
        self.declare(s.name, s.dtype)

    def s_ICopyProp(self, s: I.ICopyProp, ctx):
        self.em.w(f"{self.wtarget(s.dst)} = {s.src}")

    def s_IWriteProp(self, s: I.IWriteProp, ctx):
        node = self.ex.expr(s.node, ctx)
        val = self.ex.expr(s.expr, ctx)
        p = self.wtarget(s.prop)
        self.em.w(f"{p} = rt.set_at({p}, {node}, {val})")

    def s_IAssign(self, s: I.IAssign, ctx):
        em = self.em
        e = self.ex.expr(s.expr, ctx)
        dt = self.dtype_of(s.name)
        cast = (lambda x: self._scalar(x, dt)) if dt else (lambda x: x)
        vctx = self._vertex_ctx(ctx)
        ectx = self._edge_ctx(ctx)
        if s.reduce_op is None:
            if s.vertex_local:
                if vctx is not None and vctx.mask:
                    em.w(f"{s.name} = torch.where({vctx.mask}, {e}, {s.name})")
                else:
                    em.w(f"{s.name} = {e}")
            else:
                em.w(f"{s.name} = {cast(e)}")
            return
        op = _RED[s.reduce_op]
        if s.vertex_local:
            if ectx is not None:
                # per-vertex accumulation over the neighborhood → segment op
                masked = f"torch.where({ectx.mask}, {e}, 0)" if ectx.mask else e
                em.w(f"{s.name} = {s.name} {op} rt.segment_sum({masked}, {ectx.seg}, "
                     f"{self.VLEN}, sorted_ids={ectx.seg_sorted})")
            elif vctx is not None and vctx.mask:
                em.w(f"{s.name} = torch.where({vctx.mask}, {s.name} {op} ({e}), {s.name})")
            else:
                em.w(f"{s.name} = {s.name} {op} ({e})")
            return
        # host scalar reduction (paper Table 1) from a parallel region
        if ectx is not None or vctx is not None:
            mask = (ectx or vctx).mask
            masked = f"torch.where({mask}, {e}, 0)" if mask else e
            em.w(f"{s.name} = {cast(f'{s.name} {op} torch.sum({masked})')}")
        else:
            em.w(f"{s.name} = {cast(f'{s.name} {op} ({e})')}")

    # ---- loops ------------------------------------------------------------------
    def _vertex_ctx(self, ctx):
        for c in ctx_chain(ctx):
            if isinstance(c, VertexCtx):
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
        if len(s.body) == 1 and isinstance(s.body[0], I.INbrLoop) \
                and s.body[0].source == s.source:
            raise not_ported("the wedge pattern (nested neighbor loops, "
                             "triangle counting)", "6")
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
            terms.append(f"{vctx.mask}[{ectx.vid}]")
            ectx.src_vmask = vctx.mask
        if s.filter is not None:
            if pure_vertex_predicate(s.filter, s.it):
                # neighbor-side filter that only reads nbr-props: hoist it to
                # one [N] vertex mask (the frontier the engine switches on)
                nm = self._vmask(
                    self.ex.expr(s.filter, VertexCtx(it=s.it, mask=None, parent=ctx)))
                terms.append(f"{nm}[{ectx.nid}]")
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

    # ---- in-loop writes -------------------------------------------------------
    def s_IAssignProp(self, s: I.IAssignProp, ctx):
        em = self.em
        ectx = self._edge_ctx(ctx)
        vctx = self._vertex_ctx(ctx)
        p = self.wtarget(s.prop)
        e = self.ex.expr(s.expr, ctx)
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
        generated source shows the full lowering."""
        em = self.em
        g = self.f.graph_param
        sched = self.schedule
        new = em.uid("new")
        if frontier is None:
            em.w(f"{new} = rt.relax_minplus_hybrid({g}, {s.prop}, None"
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
        `~False == -1`)."""
        em = self.em
        conv = s.conv_prop
        self.declare(s.var, "bool")
        em.w(f"{s.var} = torch.as_tensor(False, device=_dev)")
        em.w(f"while not bool({s.var}):")
        with em.block():
            em.w(f"{conv}_nxt = torch.zeros_like({conv})")
            saved = dict(self.write_alias)
            self.write_alias[conv] = f"{conv}_nxt"
            try:
                self.body(s.body, ctx)
            finally:
                self.write_alias = saved
            em.w(f"{conv} = {conv}_nxt")
            self.emit_finished(s.var, conv)

    def emit_finished(self, var: str, conv: str):
        self.em.w(f"{var} = ~torch.any({conv})")

    def s_IDoWhile(self, s: I.IDoWhile, ctx):
        """`do { body } while (cond)` → the body, then one host read of the
        condition per trip."""
        em = self.em
        em.w("while True:")
        with em.block():
            self.body(s.body, ctx)
            em.w(f"if not bool({self.ex.expr(s.cond, ctx)}):")
            with em.block():
                em.w("break")

    def s_IWhile(self, s: I.IWhile, ctx):
        em = self.em
        em.w(f"while bool({self.ex.expr(s.cond, ctx)}):")
        with em.block():
            self.body(s.body, ctx)

    def s_ISetLoop(self, s: I.ISetLoop, ctx):
        raise not_ported("forall over a source set (batched and sequential "
                         "source loops)", "5")

    def s_IBFS(self, s: I.IBFS, ctx):
        raise not_ported("iterateInBFS / iterateInReverse", "5")

    def s_IReturn(self, s: I.IReturn, ctx):
        pass  # outputs are returned as the property/scalar dict


def generate_local(irfn: I.IRFunction, schedule: Optional[Schedule] = None) -> str:
    """Emit the local-backend source under `schedule` (default: the default
    `Schedule`). Every knob is baked in as a literal — the same schedule
    yields byte-identical source."""
    return LocalCodegen(irfn, schedule=schedule).generate()
