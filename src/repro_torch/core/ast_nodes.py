"""Abstract syntax tree for the StarPlat language (paper §2.4).

Mirrors the paper's node hierarchy: every meaningful non-terminal is an
`ASTNode`; statements and expressions specialize it; `forallStmt` is composed
of an iterator Identifier, a range proc-call, an optional filter Expression,
and a body statement — exactly as described in the paper.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class ASTNode:
    line: int = field(default=0, compare=False)


# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------

@dataclass
class TypeNode(ASTNode):
    name: str = ""                      # int|bool|long|float|double|Graph|node|edge|propNode|propEdge|SetN|SetE
    elem: Optional[str] = None          # propNode<int> -> elem='int'; SetN<g> -> elem='g'

    @property
    def is_property(self) -> bool:
        return self.name in ("propNode", "propEdge")

    @property
    def is_set(self) -> bool:
        return self.name in ("SetN", "SetE")


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------

@dataclass
class Expression(ASTNode):
    pass


@dataclass
class Identifier(Expression):
    name: str = ""


@dataclass
class Literal(Expression):
    value: object = None                # int | float | bool
    kind: str = "int"                  # int|float|bool|inf


@dataclass
class MemberAccess(Expression):
    target: Expression = None           # v.dist -> target=Identifier('v')
    member: str = ""


@dataclass
class ProcCall(Expression):
    """g.nodes(), g.neighbors(v), g.attachNodeProperty(...), nodes().filter(...)"""
    target: Optional[Expression] = None  # receiver (Identifier or another ProcCall)
    name: str = ""
    args: List[Expression] = field(default_factory=list)
    kwargs: List[Tuple[str, Expression]] = field(default_factory=list)  # attachNodeProperty(dist=INF)


@dataclass
class BinaryOp(Expression):
    op: str = ""                        # + - * / % < > <= >= == != && ||
    left: Expression = None
    right: Expression = None


@dataclass
class UnaryOp(Expression):
    op: str = ""                        # ! -
    operand: Expression = None


@dataclass
class MinMaxExpr(Expression):
    """Min(a, b) / Max(a, b) inside a multiple-assignment (paper §2.3.4)."""
    kind: str = "Min"
    args: List[Expression] = field(default_factory=list)


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------

@dataclass
class Statement(ASTNode):
    pass


@dataclass
class BlockStmt(Statement):
    stmts: List[Statement] = field(default_factory=list)


@dataclass
class DeclarationStmt(Statement):
    ty: TypeNode = None
    name: str = ""
    init: Optional[Expression] = None


@dataclass
class AssignmentStmt(Statement):
    lhs: Expression = None               # Identifier or MemberAccess
    rhs: Expression = None
    reduce_op: Optional[str] = None      # '+' for +=, '*' for *=, '&&', '||' (paper Table 1)


@dataclass
class MultiAssignmentStmt(Statement):
    """<nbr.dist, nbr.modified> = <Min(nbr.dist, v.dist + e.weight), True>;
    Translates to a synchronized conditional update (paper §2.3.4)."""
    targets: List[Expression] = field(default_factory=list)
    values: List[Expression] = field(default_factory=list)


@dataclass
class ForallStmt(Statement):
    iterator: Identifier = None
    range_call: ProcCall = None          # g.nodes() / g.neighbors(v) / g.nodes_to(v)
    filter_expr: Optional[Expression] = None
    body: BlockStmt = None
    parallel: bool = True                # forall vs for


@dataclass
class FixedPointStmt(Statement):
    var: str = ""                        # finished
    conv_expr: Expression = None         # !modified
    body: BlockStmt = None


@dataclass
class DoWhileStmt(Statement):
    body: BlockStmt = None
    cond: Expression = None


@dataclass
class WhileStmt(Statement):
    cond: Expression = None
    body: BlockStmt = None


@dataclass
class IfStmt(Statement):
    cond: Expression = None
    then_body: BlockStmt = None
    else_body: Optional[BlockStmt] = None


@dataclass
class IterateInBFSStmt(Statement):
    iterator: Identifier = None
    root: Expression = None
    filter_expr: Optional[Expression] = None
    body: BlockStmt = None
    reverse: Optional["IterateInReverseStmt"] = None


@dataclass
class IterateInReverseStmt(Statement):
    filter_expr: Optional[Expression] = None   # (v != src)
    body: BlockStmt = None


@dataclass
class ProcCallStmt(Statement):
    call: ProcCall = None


@dataclass
class ReturnStmt(Statement):
    value: Optional[Expression] = None


# --------------------------------------------------------------------------
# Top level
# --------------------------------------------------------------------------

@dataclass
class FormalParam(ASTNode):
    ty: TypeNode = None
    name: str = ""


@dataclass
class Function(ASTNode):
    name: str = ""
    params: List[FormalParam] = field(default_factory=list)
    body: BlockStmt = None


@dataclass
class Program(ASTNode):
    functions: List[Function] = field(default_factory=list)


def walk(node, fn):
    """Pre-order traversal applying fn to every ASTNode."""
    if node is None:
        return
    if isinstance(node, ASTNode):
        fn(node)
        for f in dataclasses.fields(node):
            walk(getattr(node, f.name), fn)
    elif isinstance(node, (list, tuple)):
        for x in node:
            walk(x, fn)
