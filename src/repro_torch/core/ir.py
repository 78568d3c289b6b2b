"""Backend-independent intermediate representation.

"Central to our compiler is an intermediate representation which allows a
common representation of the high-level program, from which individual
backend code generations begin" (paper abstract). This IR normalizes the
AST: identifier roles are resolved, reductions are explicit (`x = x + t`
becomes a reduce-assign), the Min/Max multiple-assignment is a single
synchronized-update node, and every loop carries its iteration space
(vertices / out-neighbors / in-neighbors / source set / BFS levels).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------

@dataclass
class IRExpr:
    pass


@dataclass
class IConst(IRExpr):
    value: object
    kind: str = "int"        # int|float|bool|inf


@dataclass
class IScalar(IRExpr):
    """Function-scope scalar variable (loop-carried in generated code)."""
    name: str
    dtype: str = "float32"


@dataclass
class IVertexLocal(IRExpr):
    """Scalar declared inside a vertex loop — one value per vertex."""
    name: str
    dtype: str = "float32"


@dataclass
class IProp(IRExpr):
    """Property read. `target` is an iterator / node-param name, or None for
    the whole array (e.g. the fixedPoint convergence expression)."""
    prop: str
    target: Optional[str]
    dtype: str = "float32"


@dataclass
class IIterId(IRExpr):
    """The integer id of an iterator (for filters like `u < v`)."""
    name: str


@dataclass
class INodeParam(IRExpr):
    name: str


@dataclass
class IEdgeWeight(IRExpr):
    """e.weight where `edge e = g.getEdge(v, nbr)` binds e to the current edge."""
    edge_var: str


@dataclass
class IBin(IRExpr):
    op: str
    left: IRExpr = None
    right: IRExpr = None


@dataclass
class IUn(IRExpr):
    op: str
    operand: IRExpr = None


@dataclass
class ICall(IRExpr):
    fn: str                      # num_nodes | count_out_nbrs | count_in_nbrs | is_an_edge | min_wt | max_wt
    args: List[IRExpr] = field(default_factory=list)


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------

@dataclass
class IRStmt:
    pass


@dataclass
class IAttach(IRStmt):
    """attachNodeProperty / attachEdgeProperty: [(prop, dtype, init|None)]."""
    props: List[Tuple[str, str, Optional[IRExpr]]]
    kind: str = "node"


@dataclass
class IDeclScalar(IRStmt):
    name: str
    dtype: str
    init: Optional[IRExpr] = None
    vertex_local: bool = False


@dataclass
class IAssign(IRStmt):
    """Scalar assignment; reduce_op != None is a paper Table-1 reduction."""
    name: str
    expr: IRExpr
    reduce_op: Optional[str] = None
    vertex_local: bool = False


@dataclass
class IWriteProp(IRStmt):
    """Single-node property write at host level: src.dist = 0."""
    prop: str
    node: IRExpr            # INodeParam or IIterId (set iterator)
    expr: IRExpr = None


@dataclass
class IAssignProp(IRStmt):
    """In-loop property write: v.pageRank_nxt = val / w.sigma += v.sigma."""
    prop: str
    target: str             # iterator name
    expr: IRExpr = None
    reduce_op: Optional[str] = None


@dataclass
class IMinMaxUpdate(IRStmt):
    """<t.p, extras...> = <Min(t.p, cand), vals...> — synchronized update."""
    prop: str
    target: str             # iterator the update lands on
    cand: IRExpr = None
    kind: str = "Min"
    extras: List[Tuple[str, str, IRExpr]] = field(default_factory=list)


@dataclass
class IVertexLoop(IRStmt):
    it: str
    filter: Optional[IRExpr] = None
    body: List[IRStmt] = field(default_factory=list)
    parallel: bool = True


@dataclass
class INbrLoop(IRStmt):
    it: str
    source: str             # the vertex iterator this neighborhood belongs to
    direction: str = "out"  # out (neighbors/nodesFrom) | in (nodesTo)
    filter: Optional[IRExpr] = None
    body: List[IRStmt] = field(default_factory=list)
    parallel: bool = True


@dataclass
class IFixedPoint(IRStmt):
    var: str
    conv_prop: str          # fixedPoint until (var : !conv_prop)
    body: List[IRStmt] = field(default_factory=list)


@dataclass
class IDoWhile(IRStmt):
    cond: IRExpr = None
    body: List[IRStmt] = field(default_factory=list)


@dataclass
class IWhile(IRStmt):
    cond: IRExpr = None
    body: List[IRStmt] = field(default_factory=list)


@dataclass
class IIf(IRStmt):
    cond: IRExpr = None
    then: List[IRStmt] = field(default_factory=list)
    els: List[IRStmt] = field(default_factory=list)


@dataclass
class IBFS(IRStmt):
    it: str
    root: IRExpr = None
    body: List[IRStmt] = field(default_factory=list)
    rev_filter: Optional[IRExpr] = None
    rev_body: Optional[List[IRStmt]] = None


@dataclass
class ISetLoop(IRStmt):
    it: str
    set_name: str
    body: List[IRStmt] = field(default_factory=list)


@dataclass
class ICopyProp(IRStmt):
    dst: str
    src: str


@dataclass
class IReturn(IRStmt):
    expr: Optional[IRExpr] = None


# --------------------------------------------------------------------------
# Function container
# --------------------------------------------------------------------------

@dataclass
class IRParam:
    name: str
    kind: str               # graph|node|scalar|prop_node|prop_edge|set_n|set_e
    dtype: Optional[str] = None


@dataclass
class IRFunction:
    name: str
    params: List[IRParam]
    body: List[IRStmt]
    node_props: dict        # name -> dtype (all propNode declared/param)
    edge_props: dict
    scalars: dict           # function-scope scalar name -> dtype
    graph_param: str = "g"


def walk_stmts(stmts, fn):
    for s in stmts:
        fn(s)
        for attr in ("body", "then", "els", "rev_body"):
            sub = getattr(s, attr, None)
            if sub:
                walk_stmts(sub, fn)


def written_vars(stmts) -> set:
    """Names of scalars/properties mutated anywhere in `stmts` — used by the
    backends to build loop carries (and, in the distributed backend, to decide
    what must be communicated; in the Pallas backend, kernel outputs)."""
    out = set()

    def visit(s):
        if isinstance(s, IAssign):
            out.add(s.name)
        elif isinstance(s, (IAssignProp, IMinMaxUpdate)):
            out.add(s.prop)
            if isinstance(s, IMinMaxUpdate):
                out.update(p for p, _, _ in s.extras)
        elif isinstance(s, IWriteProp):
            out.add(s.prop)
        elif isinstance(s, ICopyProp):
            out.add(s.dst)
        elif isinstance(s, IFixedPoint):
            out.add(s.var)
        elif isinstance(s, IAttach):
            out.update(p for p, _, _ in s.props)

    walk_stmts(stmts, visit)
    return out


def read_props(stmts) -> set:
    """Property names read anywhere (the distributed backend all-gathers these;
    the paper's CUDA backend H2D-transfers them)."""
    out = set()

    def expr_visit(e):
        if isinstance(e, IProp):
            out.add(e.prop)
        for attr in ("left", "right", "operand", "cand", "expr", "cond", "root", "node", "filter", "rev_filter", "init"):
            sub = getattr(e, attr, None)
            if isinstance(sub, IRExpr):
                expr_visit(sub)
        for a in getattr(e, "args", []) or []:
            expr_visit(a)

    def visit(s):
        for attr in ("expr", "cand", "cond", "filter", "root", "node", "init", "rev_filter"):
            sub = getattr(s, attr, None)
            if isinstance(sub, IRExpr):
                expr_visit(sub)
        if isinstance(s, IMinMaxUpdate):
            for _, _, v in s.extras:
                expr_visit(v)
        if isinstance(s, IAttach):
            for _, _, init in s.props:
                if init is not None:
                    expr_visit(init)

    walk_stmts(stmts, visit)
    return out
