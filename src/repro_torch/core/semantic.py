"""Semantic analysis: symbol table + type/role resolution (paper frontend pass).

The paper populates AST metadata "during an additional pass through the
already built AST" and performs "a rudimentary analysis of the AST" for the
CUDA backend (local vs transferred variables). This module is that pass:
it classifies every identifier (graph / node param / property / scalar /
set / iterator / edge var), resolves bare property names inside filters
(`filter(modified == True)` → iterator.modified), and records which
properties each loop reads and writes — the information the backends need
to place all-gathers (MPI analogue) and kernel I/O (CUDA analogue).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import ast_nodes as A

PRIMS = {"int", "bool", "long", "float", "double"}

_DTYPE = {"int": "int32", "long": "int32", "bool": "bool",
          "float": "float32", "double": "float64"}


class SemanticError(Exception):
    pass


def _quote(src: Optional[str], line: int) -> str:
    """The 1-based source line, for inclusion in error messages."""
    if not src or line <= 0:
        return ""
    lines = src.splitlines()
    return lines[line - 1].strip() if line <= len(lines) else ""


@dataclass
class Symbol:
    name: str
    kind: str            # graph|node_param|prop_node|prop_edge|scalar|set_n|set_e|iter_vertex|iter_nbr|iter_set|edge_var|iter_bfs
    dtype: Optional[str] = None      # jnp dtype string for props/scalars
    decl_depth: int = 0              # 0 = function scope
    param: bool = False
    # iterators
    source_iter: Optional[str] = None   # for iter_nbr: the vertex it iterates around
    direction: Optional[str] = None     # 'out' (neighbors) | 'in' (nodes_to)
    # edge vars: the (src_iter, dst_iter) it connects
    edge_between: Optional[tuple] = None


@dataclass
class FunctionInfo:
    name: str
    symbols: Dict[str, Symbol] = field(default_factory=dict)
    graph: Optional[str] = None
    node_props: Dict[str, str] = field(default_factory=dict)   # name -> dtype
    edge_props: Dict[str, str] = field(default_factory=dict)
    params: List[Symbol] = field(default_factory=list)
    returns: Optional[str] = None


def dtype_of(ty: A.TypeNode) -> str:
    base = ty.elem if ty.is_property else ty.name
    if base not in _DTYPE:
        raise SemanticError(f"unsupported element type {base!r}")
    return _DTYPE[base]


class Analyzer:
    """Single-function analyzer. Walks the AST, building the symbol table and
    annotating nodes in place (adds `.sym`, `.resolved` attributes)."""

    def __init__(self, fn: A.Function, src: Optional[str] = None):
        self.fn = fn
        self.src = src
        self.info = FunctionInfo(name=fn.name)
        self.loop_depth = 0

    def err(self, line: int, msg: str):
        """Raise a SemanticError quoting the offending source line."""
        where = f"line {line}: " if line else ""
        quoted = _quote(self.src, line)
        suffix = f"\n    | {quoted}" if quoted else ""
        raise SemanticError(f"{where}{msg}{suffix}")

    def run(self) -> FunctionInfo:
        info = self.info
        for p in self.fn.params:
            sym = self._declare_param(p)
            info.params.append(sym)
        if info.graph is None:
            raise SemanticError(f"{self.fn.name}: no Graph parameter")
        self._block(self.fn.body)
        return info

    # ---- declarations ------------------------------------------------------
    def _declare_param(self, p: A.FormalParam) -> Symbol:
        ty = p.ty
        if ty.name == "Graph":
            sym = Symbol(p.name, "graph", param=True)
            self.info.graph = p.name
        elif ty.name == "node":
            sym = Symbol(p.name, "node_param", param=True)
        elif ty.name == "edge":
            sym = Symbol(p.name, "edge_var", param=True)
        elif ty.name == "propNode":
            sym = Symbol(p.name, "prop_node", dtype=dtype_of(ty), param=True)
            self.info.node_props[p.name] = sym.dtype
        elif ty.name == "propEdge":
            sym = Symbol(p.name, "prop_edge", dtype=dtype_of(ty), param=True)
            self.info.edge_props[p.name] = sym.dtype
        elif ty.name == "SetN":
            sym = Symbol(p.name, "set_n", param=True)
        elif ty.name == "SetE":
            sym = Symbol(p.name, "set_e", param=True)
        elif ty.name in PRIMS:
            sym = Symbol(p.name, "scalar", dtype=_DTYPE[ty.name], param=True)
        else:
            raise SemanticError(f"bad param type {ty.name}")
        self.info.symbols[p.name] = sym
        return sym

    def _declare_local(self, d: A.DeclarationStmt) -> Symbol:
        ty = d.ty
        if ty.name == "propNode":
            sym = Symbol(d.name, "prop_node", dtype=dtype_of(ty),
                         decl_depth=self.loop_depth)
            self.info.node_props[d.name] = sym.dtype
        elif ty.name == "propEdge":
            sym = Symbol(d.name, "prop_edge", dtype=dtype_of(ty),
                         decl_depth=self.loop_depth)
            self.info.edge_props[d.name] = sym.dtype
        elif ty.name == "edge":
            sym = Symbol(d.name, "edge_var", decl_depth=self.loop_depth)
        elif ty.name in PRIMS:
            sym = Symbol(d.name, "scalar", dtype=_DTYPE[ty.name],
                         decl_depth=self.loop_depth)
        else:
            self.err(d.line, f"cannot declare {ty.name} locally")
        self.info.symbols[d.name] = sym
        return sym

    # ---- traversal -----------------------------------------------------------
    def _block(self, b: A.BlockStmt):
        for s in b.stmts:
            self._stmt(s)

    def _stmt(self, s: A.Statement):
        if isinstance(s, A.DeclarationStmt):
            sym = self._declare_local(s)
            if isinstance(s.init, A.ProcCall) and s.init.name == "getEdge":
                args = s.init.args
                sym.edge_between = (self._ident_name(args[0]),
                                    self._ident_name(args[1]))
            elif s.init is not None:
                self._expr(s.init)
            s.sym = sym
        elif isinstance(s, A.AssignmentStmt):
            self._expr(s.lhs)
            self._expr(s.rhs)
        elif isinstance(s, A.MultiAssignmentStmt):
            for t in s.targets:
                self._expr(t)
            for v in s.values:
                self._expr(v)
        elif isinstance(s, A.ForallStmt):
            self._forall(s)
        elif isinstance(s, A.FixedPointStmt):
            # fixedPoint until (finished: !modified): conv prop must be bool
            self.info.symbols[s.var] = self.info.symbols.get(
                s.var, Symbol(s.var, "scalar", dtype="bool"))
            self._expr(s.conv_expr)
            self._block(s.body)
        elif isinstance(s, A.DoWhileStmt):
            self._block(s.body)
            self._expr(s.cond)
        elif isinstance(s, A.WhileStmt):
            self._expr(s.cond)
            self._block(s.body)
        elif isinstance(s, A.IfStmt):
            self._expr(s.cond)
            self._block(s.then_body)
            if s.else_body:
                self._block(s.else_body)
        elif isinstance(s, A.IterateInBFSStmt):
            self._bfs(s)
        elif isinstance(s, A.ProcCallStmt):
            self._expr(s.call)
        elif isinstance(s, A.ReturnStmt):
            if s.value:
                self._expr(s.value)
        elif isinstance(s, A.BlockStmt):
            self._block(s)
        else:
            raise SemanticError(f"unhandled statement {type(s).__name__}")

    def _ident_name(self, e: A.Expression) -> str:
        if isinstance(e, A.Identifier):
            return e.name
        self.err(e.line, "expected identifier")

    def _forall(self, s: A.ForallStmt):
        rng = s.range_call
        it_name = s.iterator.name
        if isinstance(rng, A.ProcCall):
            if rng.name == "nodes":
                sym = Symbol(it_name, "iter_vertex", decl_depth=self.loop_depth + 1)
            elif rng.name in ("neighbors", "nodesTo", "nodes_to", "nodesFrom", "nodes_from"):
                src = self._ident_name(rng.args[0])
                direction = "out" if rng.name in ("neighbors", "nodesFrom", "nodes_from") else "in"
                sym = Symbol(it_name, "iter_nbr", decl_depth=self.loop_depth + 1,
                             source_iter=src, direction=direction)
            else:
                self.err(s.line, f"unknown range {rng.name}()")
        elif isinstance(rng, A.Identifier):
            base = self.info.symbols.get(rng.name)
            if base is None or base.kind not in ("set_n", "set_e"):
                self.err(s.line, f"cannot iterate over {rng.name}")
            sym = Symbol(it_name, "iter_set", decl_depth=self.loop_depth + 1,
                         source_iter=rng.name)
        else:
            self.err(s.line, "bad forall range")
        saved = self.info.symbols.get(it_name)
        self.info.symbols[it_name] = sym
        s.iter_sym = sym
        self.loop_depth += 1
        if s.filter_expr is not None:
            self._expr(s.filter_expr, filter_iter=it_name)
        self._block(s.body)
        self.loop_depth -= 1
        if saved is not None:
            self.info.symbols[it_name] = saved

    def _bfs(self, s: A.IterateInBFSStmt):
        it_name = s.iterator.name
        sym = Symbol(it_name, "iter_bfs", decl_depth=self.loop_depth + 1)
        self.info.symbols[it_name] = sym
        s.iter_sym = sym
        self._expr(s.root)
        self.loop_depth += 1
        self._block(s.body)
        if s.reverse is not None:
            if s.reverse.filter_expr is not None:
                self._expr(s.reverse.filter_expr, filter_iter=it_name)
            self._block(s.reverse.body)
        self.loop_depth -= 1

    # ---- expressions -----------------------------------------------------------
    def _expr(self, e: A.Expression, filter_iter: Optional[str] = None):
        """Annotates identifiers with `.sym`. Inside a filter, a bare property
        name is sugar for `<iterator>.<prop>` (paper Fig. 3/4 usage)."""
        if isinstance(e, A.Identifier):
            sym = self.info.symbols.get(e.name)
            if sym is None:
                self.err(e.line, f"undefined {e.name!r}")
            e.sym = sym
            if filter_iter and sym.kind in ("prop_node", "prop_edge"):
                e.filter_sugar_iter = filter_iter   # means filter_iter.<prop>
        elif isinstance(e, A.MemberAccess):
            self._expr(e.target, filter_iter)
        elif isinstance(e, A.BinaryOp):
            self._expr(e.left, filter_iter)
            self._expr(e.right, filter_iter)
        elif isinstance(e, A.UnaryOp):
            self._expr(e.operand, filter_iter)
        elif isinstance(e, A.ProcCall):
            if e.target is not None:
                self._expr(e.target, filter_iter)
            for a in e.args:
                self._expr(a, filter_iter)
            for _, v in e.kwargs:
                self._expr(v, filter_iter)
        elif isinstance(e, A.MinMaxExpr):
            for a in e.args:
                self._expr(a, filter_iter)
        elif isinstance(e, A.Literal):
            pass
        else:
            raise SemanticError(f"unhandled expression {type(e).__name__}")


def analyze(prog: A.Program) -> Dict[str, FunctionInfo]:
    src = getattr(prog, "src_text", None)
    return {fn.name: Analyzer(fn, src=src).run() for fn in prog.functions}
