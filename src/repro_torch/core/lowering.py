"""AST → IR lowering.

Normalizations performed here (so every backend sees the same canonical IR):
  * identifier roles resolved via the semantic symbol table;
  * `x = x + t` folded into a reduce-assign (`x += t`) — the paper lets the
    user write either form (Fig. 5 line 5 vs line 7);
  * the Min/Max multiple assignment becomes one `IMinMaxUpdate` node;
  * filter sugar (`filter(modified == True)`) resolved to iterator props;
  * `fixedPoint until (v : !prop)` validated to the paper's canonical shape.
"""
from __future__ import annotations

from typing import List, Optional

from . import ast_nodes as A
from . import ir as I
from .semantic import FunctionInfo, analyze


class LowerError(Exception):
    pass


class Lowerer:
    def __init__(self, fn: A.Function, info: FunctionInfo):
        self.fn = fn
        self.info = info
        self.edge_bindings = {}   # edge var -> (src_iter, nbr_iter)
        self.loop_depth = 0

    def run(self) -> I.IRFunction:
        params = []
        for p in self.info.params:
            params.append(I.IRParam(name=p.name, kind=p.kind, dtype=p.dtype))
        body = self.stmts(self.fn.body.stmts)
        scalars = {s.name: s.dtype for s in self.info.symbols.values()
                   if s.kind == "scalar" and not s.param and s.decl_depth == 0}
        return I.IRFunction(
            name=self.fn.name, params=params, body=body,
            node_props=dict(self.info.node_props),
            edge_props=dict(self.info.edge_props),
            scalars=scalars, graph_param=self.info.graph)

    # ------------------------------------------------------------------ stmts
    def stmts(self, lst: List[A.Statement]) -> List[I.IRStmt]:
        out = []
        for s in lst:
            r = self.stmt(s)
            if r is not None:
                out.extend(r if isinstance(r, list) else [r])
        return out

    def stmt(self, s: A.Statement):
        if isinstance(s, A.DeclarationStmt):
            return self.decl(s)
        if isinstance(s, A.AssignmentStmt):
            return self.assign(s)
        if isinstance(s, A.MultiAssignmentStmt):
            return self.multi_assign(s)
        if isinstance(s, A.ForallStmt):
            return self.forall(s)
        if isinstance(s, A.FixedPointStmt):
            return self.fixed_point(s)
        if isinstance(s, A.DoWhileStmt):
            return I.IDoWhile(cond=self.expr(s.cond), body=self.in_loop(s.body))
        if isinstance(s, A.WhileStmt):
            return I.IWhile(cond=self.expr(s.cond), body=self.in_loop(s.body))
        if isinstance(s, A.IfStmt):
            return I.IIf(cond=self.expr(s.cond),
                         then=self.stmts(s.then_body.stmts),
                         els=self.stmts(s.else_body.stmts) if s.else_body else [])
        if isinstance(s, A.IterateInBFSStmt):
            return self.bfs(s)
        if isinstance(s, A.ProcCallStmt):
            return self.proc_call_stmt(s.call)
        if isinstance(s, A.ReturnStmt):
            return I.IReturn(expr=self.expr(s.value) if s.value else None)
        if isinstance(s, A.BlockStmt):
            return self.stmts(s.stmts)
        raise LowerError(f"unhandled statement {type(s).__name__}")

    def in_loop(self, body: A.BlockStmt) -> List[I.IRStmt]:
        self.loop_depth += 1
        try:
            return self.stmts(body.stmts)
        finally:
            self.loop_depth -= 1

    def decl(self, s: A.DeclarationStmt):
        sym = self.info.symbols[s.name]
        if sym.kind in ("prop_node", "prop_edge"):
            # allocation happens at attachNodeProperty; a bare declaration
            # attaches a zero-initialized array so reads are always defined.
            return I.IAttach(props=[(s.name, sym.dtype, None)],
                             kind="node" if sym.kind == "prop_node" else "edge")
        if sym.kind == "edge_var":
            if sym.edge_between is None:
                raise LowerError(f"edge {s.name} must bind via g.getEdge(u, v)")
            self.edge_bindings[s.name] = sym.edge_between
            return None
        if sym.kind == "scalar":
            return I.IDeclScalar(
                name=s.name, dtype=sym.dtype,
                init=self.expr(s.init) if s.init else None,
                vertex_local=sym.decl_depth > 0)
        raise LowerError(f"cannot lower declaration of {s.name}")

    def assign(self, s: A.AssignmentStmt):
        rhs = s.rhs
        reduce_op = s.reduce_op
        # fold `x = x + t` (paper Fig. 5 line 5) into a reduce-assign
        if reduce_op is None and isinstance(rhs, A.BinaryOp) and rhs.op in ("+", "*"):
            lhs_key = self._lhs_key(s.lhs)
            if lhs_key is not None and self._lhs_key(rhs.left) == lhs_key:
                reduce_op, rhs = rhs.op, rhs.right
        if isinstance(s.lhs, A.Identifier):
            sym = s.lhs.sym
            if sym.kind in ("prop_node", "prop_edge"):
                if reduce_op is None and isinstance(rhs, A.Identifier) and \
                        rhs.sym.kind in ("prop_node", "prop_edge"):
                    return I.ICopyProp(dst=sym.name, src=rhs.sym.name)
                raise LowerError(f"unsupported whole-property assignment to {sym.name}")
            if sym.kind == "scalar":
                return I.IAssign(name=sym.name, expr=self.expr(rhs),
                                 reduce_op=reduce_op,
                                 vertex_local=sym.decl_depth > 0)
            raise LowerError(f"cannot assign to {sym.kind} {sym.name}")
        if isinstance(s.lhs, A.MemberAccess):
            tgt = s.lhs.target
            if not isinstance(tgt, A.Identifier):
                raise LowerError("chained member assignment unsupported")
            tsym = tgt.sym
            prop = s.lhs.member
            if tsym.kind in ("node_param", "iter_set"):
                return I.IWriteProp(prop=prop, node=self.expr(tgt),
                                    expr=self.expr(rhs))
            if tsym.kind in ("iter_vertex", "iter_nbr", "iter_bfs"):
                return I.IAssignProp(prop=prop, target=tsym.name,
                                     expr=self.expr(rhs), reduce_op=reduce_op)
            raise LowerError(f"cannot assign property via {tsym.kind}")
        raise LowerError("bad assignment lhs")

    def _lhs_key(self, e) -> Optional[str]:
        if isinstance(e, A.Identifier):
            return f"id:{e.name}"
        if isinstance(e, A.MemberAccess) and isinstance(e.target, A.Identifier):
            return f"mem:{e.target.name}.{e.member}"
        return None

    def multi_assign(self, s: A.MultiAssignmentStmt):
        if not s.values or not isinstance(s.values[0], A.MinMaxExpr):
            raise LowerError("multiple assignment must lead with Min/Max")
        mm = s.values[0]
        main = s.targets[0]
        if not (isinstance(main, A.MemberAccess) and isinstance(main.target, A.Identifier)):
            raise LowerError("Min/Max main target must be iter.prop")
        target_iter = main.target.name
        prop = main.member
        # Min(t.prop, cand) — first arg must be the target itself
        cand = mm.args[1]
        extras = []
        for t, v in zip(s.targets[1:], s.values[1:]):
            if not (isinstance(t, A.MemberAccess) and isinstance(t.target, A.Identifier)):
                raise LowerError("Min/Max extra target must be iter.prop")
            extras.append((t.member, t.target.name, self.expr(v)))
        return I.IMinMaxUpdate(prop=prop, target=target_iter,
                               cand=self.expr(cand), kind=mm.kind, extras=extras)

    def forall(self, s: A.ForallStmt):
        sym = s.iter_sym
        filt = self.expr(s.filter_expr, filter_iter=sym.name) if s.filter_expr is not None else None
        if sym.kind == "iter_vertex":
            return I.IVertexLoop(it=sym.name, filter=filt,
                                 body=self.in_loop(s.body), parallel=s.parallel)
        if sym.kind == "iter_nbr":
            return I.INbrLoop(it=sym.name, source=sym.source_iter,
                              direction=sym.direction, filter=filt,
                              body=self.in_loop(s.body), parallel=s.parallel)
        if sym.kind == "iter_set":
            return I.ISetLoop(it=sym.name, set_name=sym.source_iter,
                              body=self.in_loop(s.body))
        raise LowerError(f"bad forall iterator kind {sym.kind}")

    def fixed_point(self, s: A.FixedPointStmt):
        conv = s.conv_expr
        prop = None
        if isinstance(conv, A.UnaryOp) and conv.op == "!" and isinstance(conv.operand, A.Identifier):
            prop = conv.operand.name
        elif isinstance(conv, A.BinaryOp) and conv.op == "==" and \
                isinstance(conv.left, A.Identifier) and \
                isinstance(conv.right, A.Literal) and conv.right.value is False:
            prop = conv.left.name
        if prop is None or prop not in self.info.node_props:
            raise LowerError(
                "fixedPoint convergence must be !<bool node property>")
        return I.IFixedPoint(var=s.var, conv_prop=prop, body=self.in_loop(s.body))

    def bfs(self, s: A.IterateInBFSStmt):
        rev_f = rev_b = None
        if s.reverse is not None:
            rev_f = (self.expr(s.reverse.filter_expr, filter_iter=s.iterator.name)
                     if s.reverse.filter_expr is not None else None)
            rev_b = self.in_loop(s.reverse.body)
        return I.IBFS(it=s.iterator.name, root=self.expr(s.root),
                      body=self.in_loop(s.body), rev_filter=rev_f, rev_body=rev_b)

    def proc_call_stmt(self, call: A.ProcCall):
        if call.name in ("attachNodeProperty", "attachEdgeProperty"):
            kind = "node" if call.name == "attachNodeProperty" else "edge"
            props = []
            table = self.info.node_props if kind == "node" else self.info.edge_props
            for key, val in call.kwargs:
                if key not in table:
                    raise LowerError(f"attach of undeclared property {key}")
                props.append((key, table[key], self.expr(val)))
            return I.IAttach(props=props, kind=kind)
        raise LowerError(f"unsupported procedure call {call.name}")

    # ------------------------------------------------------------------ exprs
    def expr(self, e: A.Expression, filter_iter: Optional[str] = None) -> I.IRExpr:
        if isinstance(e, A.Literal):
            return I.IConst(value=e.value, kind=e.kind)
        if isinstance(e, A.Identifier):
            sym = e.sym
            if sym.kind in ("prop_node", "prop_edge"):
                target = getattr(e, "filter_sugar_iter", None) or filter_iter
                return I.IProp(prop=sym.name, target=target, dtype=sym.dtype)
            if sym.kind == "scalar":
                if sym.decl_depth > 0:
                    return I.IVertexLocal(name=sym.name, dtype=sym.dtype)
                return I.IScalar(name=sym.name, dtype=sym.dtype)
            if sym.kind == "node_param":
                return I.INodeParam(name=sym.name)
            if sym.kind in ("iter_vertex", "iter_nbr", "iter_bfs", "iter_set"):
                return I.IIterId(name=sym.name)
            raise LowerError(f"cannot reference {sym.kind} {sym.name}")
        if isinstance(e, A.MemberAccess):
            tgt = e.target
            if isinstance(tgt, A.Identifier):
                tsym = tgt.sym
                if tsym.kind == "edge_var":
                    if e.member != "weight":
                        raise LowerError(f"edge member {e.member} unsupported")
                    return I.IEdgeWeight(edge_var=tsym.name)
                dtype = self.info.node_props.get(e.member) or \
                    self.info.edge_props.get(e.member)
                if dtype is None:
                    raise LowerError(f"unknown property {e.member}")
                return I.IProp(prop=e.member, target=tsym.name, dtype=dtype)
            raise LowerError("chained member access unsupported")
        if isinstance(e, A.BinaryOp):
            return I.IBin(op=e.op, left=self.expr(e.left, filter_iter),
                          right=self.expr(e.right, filter_iter))
        if isinstance(e, A.UnaryOp):
            return I.IUn(op=e.op, operand=self.expr(e.operand, filter_iter))
        if isinstance(e, A.ProcCall):
            return self.call(e, filter_iter)
        if isinstance(e, A.MinMaxExpr):
            raise LowerError("Min/Max only valid in multiple assignment")
        raise LowerError(f"unhandled expression {type(e).__name__}")

    _CALLS = {"num_nodes": "num_nodes", "num_edges": "num_edges",
              "count_outNbrs": "count_out_nbrs", "count_outNbrs_": "count_out_nbrs",
              "count_inNbrs": "count_in_nbrs", "is_an_edge": "is_an_edge",
              "minWt": "min_wt", "maxWt": "max_wt", "abs": "abs"}

    def call(self, e: A.ProcCall, filter_iter=None) -> I.IRExpr:
        if e.name in self._CALLS:
            return I.ICall(fn=self._CALLS[e.name],
                           args=[self.expr(a, filter_iter) for a in e.args])
        raise LowerError(f"unsupported call {e.name}()")


def lower(prog: A.Program) -> List[I.IRFunction]:
    infos = analyze(prog)
    return [Lowerer(fn, infos[fn.name]).run() for fn in prog.functions]
