"""Recursive-descent parser for StarPlat → AST (paper §2 frontend).

The grammar follows the paper's concrete syntax: the five published programs
(Figs. 3, 18, 19, 20, 21) parse verbatim (modulo whitespace/line wrapping in
the PDF listing).
"""
from __future__ import annotations

from typing import List, Optional

from .ast_nodes import (
    AssignmentStmt, BinaryOp, BlockStmt, DeclarationStmt, DoWhileStmt,
    Expression, FixedPointStmt, ForallStmt, FormalParam, Function, Identifier,
    IfStmt, IterateInBFSStmt, IterateInReverseStmt, Literal, MemberAccess,
    MinMaxExpr, MultiAssignmentStmt, ProcCall, ProcCallStmt, Program,
    ReturnStmt, Statement, TypeNode, UnaryOp, WhileStmt,
)
from .lexer import Token, tokenize

TYPE_KEYWORDS = {"int", "bool", "long", "float", "double", "Graph", "node",
                 "edge", "propNode", "propEdge", "SetN", "SetE"}

REDUCE_ASSIGN = {"+=": "+", "-=": "-", "*=": "*", "/=": "/", "&&=": "&&", "||=": "||"}

_PRECEDENCE = [
    ("||",),
    ("&&",),
    ("==", "!="),
    ("<", ">", "<=", ">="),
    ("+", "-"),
    ("*", "/", "%"),
]


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, src: str):
        self.toks: List[Token] = tokenize(src)
        self.pos = 0

    # --- token helpers -----------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        return self.toks[min(self.pos + off, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def at(self, kind: str, value: Optional[str] = None, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == kind and (value is None or t.value == value)

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise ParseError(
                f"line {t.line}: expected {value or kind}, got {t.value!r}")
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        if self.at(kind, value):
            return self.next()
        return None

    # --- top level ----------------------------------------------------------
    def parse_program(self) -> Program:
        first = self.peek().line
        functions = []
        while not self.at("eof"):
            functions.append(self.parse_function())
        return Program(functions=functions, line=first)

    def parse_function(self) -> Function:
        t = self.expect("kw", "function")
        name = self.expect("id").value
        self.expect("sym", "(")
        params = []
        while not self.at("sym", ")"):
            ty = self.parse_type()
            pname = self.expect("id").value
            params.append(FormalParam(ty=ty, name=pname, line=t.line))
            if not self.accept("sym", ","):
                break
        self.expect("sym", ")")
        body = self.parse_block()
        return Function(name=name, params=params, body=body, line=t.line)

    def parse_type(self) -> TypeNode:
        t = self.next()
        if t.kind != "kw" or t.value not in TYPE_KEYWORDS:
            raise ParseError(f"line {t.line}: expected type, got {t.value!r}")
        elem = None
        if t.value in ("propNode", "propEdge", "SetN", "SetE") and self.accept("sym", "<"):
            inner = self.next()
            elem = inner.value
            self.expect("sym", ">")
        return TypeNode(name=t.value, elem=elem, line=t.line)

    # --- statements ----------------------------------------------------------
    def parse_block(self) -> BlockStmt:
        t = self.expect("sym", "{")
        stmts: List[Statement] = []
        while not self.at("sym", "}"):
            stmts.append(self.parse_statement())
        self.expect("sym", "}")
        # attach trailing iterateInReverse to preceding iterateInBFS
        merged: List[Statement] = []
        for s in stmts:
            if (isinstance(s, IterateInReverseStmt) and merged
                    and isinstance(merged[-1], IterateInBFSStmt)
                    and merged[-1].reverse is None):
                merged[-1].reverse = s
            else:
                merged.append(s)
        return BlockStmt(stmts=merged, line=t.line)

    def parse_statement(self) -> Statement:
        t = self.peek()
        if t.kind == "kw":
            if t.value in TYPE_KEYWORDS:
                return self.parse_declaration()
            if t.value in ("forall", "for"):
                return self.parse_forall(parallel=t.value == "forall")
            if t.value == "fixedPoint":
                return self.parse_fixed_point()
            if t.value == "iterateInBFS":
                return self.parse_iterate_bfs()
            if t.value == "iterateInReverse":
                return self.parse_iterate_reverse()
            if t.value == "do":
                return self.parse_do_while()
            if t.value == "while":
                return self.parse_while()
            if t.value == "if":
                return self.parse_if()
            if t.value == "return":
                self.next()
                val = None if self.at("sym", ";") else self.parse_expression()
                self.expect("sym", ";")
                return ReturnStmt(value=val, line=t.line)
        if t.kind == "sym" and t.value == "<":
            return self.parse_multi_assignment()
        if t.kind == "sym" and t.value == "{":
            return self.parse_block()
        return self.parse_expr_statement()

    def parse_declaration(self) -> DeclarationStmt:
        ty = self.parse_type()
        name = self.expect("id").value
        init = None
        if self.accept("sym", "="):
            init = self.parse_expression()
        self.expect("sym", ";")
        return DeclarationStmt(ty=ty, name=name, init=init, line=ty.line)

    def parse_forall(self, parallel: bool) -> ForallStmt:
        t = self.next()  # forall | for
        self.expect("sym", "(")
        it = Identifier(name=self.expect("id").value, line=t.line)
        self.expect("kw", "in")
        rng = self.parse_expression()
        self.expect("sym", ")")
        rng, filt = self._strip_filter(rng)
        body = self.parse_block() if self.at("sym", "{") else BlockStmt(
            stmts=[self.parse_statement()], line=t.line)
        return ForallStmt(iterator=it, range_call=rng, filter_expr=filt,
                          body=body, parallel=parallel, line=t.line)

    def _strip_filter(self, rng: Expression):
        """g.nodes().filter(cond) → (g.nodes(), cond)"""
        if isinstance(rng, ProcCall) and rng.name == "filter":
            return rng.target, (rng.args[0] if rng.args else None)
        return rng, None

    def parse_fixed_point(self) -> FixedPointStmt:
        t = self.expect("kw", "fixedPoint")
        self.expect("kw", "until")
        self.expect("sym", "(")
        var = self.expect("id").value
        self.expect("sym", ":")
        conv = self.parse_expression()
        self.expect("sym", ")")
        body = self.parse_block()
        return FixedPointStmt(var=var, conv_expr=conv, body=body, line=t.line)

    def parse_iterate_bfs(self) -> IterateInBFSStmt:
        t = self.expect("kw", "iterateInBFS")
        self.expect("sym", "(")
        it = Identifier(name=self.expect("id").value, line=t.line)
        self.expect("kw", "in")
        rng = self.parse_expression()
        self.expect("kw", "from")
        root = self.parse_expression()
        self.expect("sym", ")")
        rng, filt = self._strip_filter(rng)
        body = self.parse_block()
        return IterateInBFSStmt(iterator=it, root=root, filter_expr=filt,
                                body=body, line=t.line)

    def parse_iterate_reverse(self) -> IterateInReverseStmt:
        t = self.expect("kw", "iterateInReverse")
        filt = None
        if self.accept("sym", "("):
            if not self.at("sym", ")"):
                filt = self.parse_expression()
            self.expect("sym", ")")
        body = self.parse_block()
        return IterateInReverseStmt(filter_expr=filt, body=body, line=t.line)

    def parse_do_while(self) -> DoWhileStmt:
        t = self.expect("kw", "do")
        body = self.parse_block()
        self.expect("kw", "while")
        self.expect("sym", "(")
        cond = self.parse_expression()
        self.expect("sym", ")")
        self.expect("sym", ";")
        return DoWhileStmt(body=body, cond=cond, line=t.line)

    def parse_while(self) -> WhileStmt:
        t = self.expect("kw", "while")
        self.expect("sym", "(")
        cond = self.parse_expression()
        self.expect("sym", ")")
        body = self.parse_block()
        return WhileStmt(cond=cond, body=body, line=t.line)

    def parse_if(self) -> IfStmt:
        t = self.expect("kw", "if")
        self.expect("sym", "(")
        cond = self.parse_expression()
        self.expect("sym", ")")
        then = self.parse_block() if self.at("sym", "{") else BlockStmt(
            stmts=[self.parse_statement()], line=t.line)
        els = None
        if self.accept("kw", "else"):
            els = self.parse_block() if self.at("sym", "{") else BlockStmt(
                stmts=[self.parse_statement()], line=t.line)
        return IfStmt(cond=cond, then_body=then, else_body=els, line=t.line)

    def parse_multi_assignment(self) -> MultiAssignmentStmt:
        # Elements are parsed above the relational level so the closing '>'
        # of the angle-bracket list is not mistaken for a comparison.
        additive = len(_PRECEDENCE) - 2  # ('+', '-') level
        t = self.expect("sym", "<")
        targets = [self._parse_binary(additive)]
        while self.accept("sym", ","):
            targets.append(self._parse_binary(additive))
        self.expect("sym", ">")
        self.expect("sym", "=")
        self.expect("sym", "<")
        values = [self._parse_binary(additive)]
        while self.accept("sym", ","):
            values.append(self._parse_binary(additive))
        self.expect("sym", ">")
        self.expect("sym", ";")
        return MultiAssignmentStmt(targets=targets, values=values, line=t.line)

    def parse_expr_statement(self) -> Statement:
        t = self.peek()
        lhs = self.parse_expression()
        if self.at("sym") and self.peek().value in REDUCE_ASSIGN:
            op = self.next().value
            rhs = self.parse_expression()
            self.expect("sym", ";")
            return AssignmentStmt(lhs=lhs, rhs=rhs,
                                  reduce_op=REDUCE_ASSIGN[op], line=t.line)
        if self.accept("sym", "++"):
            self.expect("sym", ";")
            return AssignmentStmt(lhs=lhs,
                                  rhs=Literal(value=1, kind="int", line=t.line),
                                  reduce_op="+", line=t.line)
        if self.accept("sym", "="):
            rhs = self.parse_expression()
            self.expect("sym", ";")
            return AssignmentStmt(lhs=lhs, rhs=rhs, line=t.line)
        self.expect("sym", ";")
        if isinstance(lhs, ProcCall):
            return ProcCallStmt(call=lhs, line=t.line)
        raise ParseError(f"line {t.line}: expression is not a statement")

    # --- expressions ----------------------------------------------------------
    def parse_expression(self) -> Expression:
        return self._parse_binary(0)

    def _parse_binary(self, level: int) -> Expression:
        if level >= len(_PRECEDENCE):
            return self._parse_unary()
        left = self._parse_binary(level + 1)
        ops = _PRECEDENCE[level]
        while self.at("sym") and self.peek().value in ops:
            # do not treat '>' of a multi-assign target list as an operator:
            # handled by caller context (parse_multi_assignment consumes '>').
            op = self.next().value
            right = self._parse_binary(level + 1)
            left = BinaryOp(op=op, left=left, right=right, line=left.line)
        return left

    def _parse_unary(self) -> Expression:
        t = self.peek()
        if self.accept("sym", "!"):
            return UnaryOp(op="!", operand=self._parse_unary(), line=t.line)
        if self.accept("sym", "-"):
            return UnaryOp(op="-", operand=self._parse_unary(), line=t.line)
        return self._parse_postfix()

    def _parse_postfix(self) -> Expression:
        expr = self._parse_primary()
        while True:
            if self.accept("sym", "."):
                name = self.next().value
                if self.at("sym", "("):
                    args, kwargs = self._parse_args()
                    expr = ProcCall(target=expr, name=name, args=args,
                                    kwargs=kwargs, line=expr.line)
                else:
                    expr = MemberAccess(target=expr, member=name, line=expr.line)
            elif self.at("sym", "(") and isinstance(expr, Identifier):
                args, kwargs = self._parse_args()
                expr = ProcCall(target=None, name=expr.name, args=args,
                                kwargs=kwargs, line=expr.line)
            else:
                return expr

    def _parse_args(self):
        self.expect("sym", "(")
        args, kwargs = [], []
        while not self.at("sym", ")"):
            # keyword arg: id '=' expr  (attachNodeProperty(dist = INF))
            if self.at("id") and self.at("sym", "=", off=1):
                key = self.next().value
                self.next()  # '='
                kwargs.append((key, self.parse_expression()))
            else:
                args.append(self.parse_expression())
            if not self.accept("sym", ","):
                break
        self.expect("sym", ")")
        return args, kwargs

    def _parse_primary(self) -> Expression:
        t = self.next()
        if t.kind == "int":
            return Literal(value=int(t.value), kind="int", line=t.line)
        if t.kind == "float":
            return Literal(value=float(t.value), kind="float", line=t.line)
        if t.kind == "kw":
            if t.value in ("True", "False"):
                return Literal(value=t.value == "True", kind="bool", line=t.line)
            if t.value == "INF":
                return Literal(value=None, kind="inf", line=t.line)
            if t.value in ("Min", "Max"):
                args, _ = self._parse_args()
                return MinMaxExpr(kind=t.value, args=args, line=t.line)
        if t.kind == "id":
            return Identifier(name=t.value, line=t.line)
        if t.kind == "sym" and t.value == "(":
            e = self.parse_expression()
            self.expect("sym", ")")
            return e
        raise ParseError(f"line {t.line}: unexpected token {t.value!r}")


def parse(src: str) -> Program:
    prog = Parser(src).parse_program()
    # plain attribute (not a dataclass field): `walk` never visits it, and
    # downstream passes can quote offending source lines in diagnostics
    prog.src_text = src
    return prog

