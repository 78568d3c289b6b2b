"""Effect analysis: per-region read/write/reduce sets over the typed AST.

Runs after ``semantic.analyze`` (it relies on the ``.sym`` /
``.filter_sugar_iter`` annotations that pass leaves on identifier nodes) and
builds a region tree — one :class:`Region` per ``forall`` / ``fixedPoint`` /
``while`` / BFS construct — whose nodes carry a :class:`PropAccess` record
per property: reads, self-writes, cross-vertex writes, reduction operators,
and Min/Max update kinds.

The race check is the same property StarPlat's atomics insertion relies on
(paper §4): a *plain* property assignment whose destination slot is shared
across iterations of an enclosing parallel loop is a write-write race →
SP101.  A slot is shared when some parallel loop other than the one binding
the destination iterator encloses the write; ``forall(src in sourceSet)``
loops are exempt because the batched engine gives every source its own
``[N, B]`` lane (properties declared per-source never alias across sources).
Min/Max multi-assignments and reduction assignments (``+=`` or the
``x = x + t`` fold, mirroring ``lowering.assign``) are synchronized updates,
never races.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .. import ast_nodes as A
from ..semantic import FunctionInfo
from .diagnostics import Diagnostic, diag

#: ops `lowering.assign` folds from `x = x <op> t` into a reduce-assign
_FOLD_OPS = ("+", "*")

_ELEM_ITERS = ("iter_vertex", "iter_nbr", "iter_set", "iter_bfs")


# --------------------------------------------------------------------------
# Data model
# --------------------------------------------------------------------------

@dataclass
class PropAccess:
    """Access record for one property within one region."""
    reads: int = 0
    self_writes: int = 0          # destination slot private to the iteration
    cross_writes: int = 0         # scatter / shared-slot writes
    plain_writes: int = 0         # unsynchronized assignments (race candidates)
    extra_writes: int = 0         # Min/Max-synchronized extra targets
    reductions: Set[str] = field(default_factory=set)
    minmax: Set[str] = field(default_factory=set)
    minmax_weighted: bool = False  # some Min/Max candidate reads an edge weight
    read_lines: Set[int] = field(default_factory=set)
    write_lines: Set[int] = field(default_factory=set)

    @property
    def written(self) -> bool:
        return bool(self.plain_writes or self.extra_writes
                    or self.reductions or self.minmax)

    def summary(self) -> dict:
        return {
            "reads": self.reads,
            "self_writes": self.self_writes,
            "cross_writes": self.cross_writes,
            "plain_writes": self.plain_writes,
            "extra_writes": self.extra_writes,
            "reductions": sorted(self.reductions),
            "minmax": sorted(self.minmax),
            "minmax_weighted": self.minmax_weighted,
        }


@dataclass
class Region:
    """One lexical parallel/iterative construct and its property effects."""
    kind: str                     # function|forall|for|fixedpoint|while|do_while|bfs|bfs_reverse
    line: int = 0
    iterator: str = ""
    parallel: bool = False
    props: Dict[str, PropAccess] = field(default_factory=dict)
    children: List["Region"] = field(default_factory=list)

    def access(self, prop: str) -> PropAccess:
        return self.props.setdefault(prop, PropAccess())

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "line": self.line,
            "iterator": self.iterator,
            "parallel": self.parallel,
            "props": {p: self.props[p].summary() for p in sorted(self.props)},
            "children": [c.summary() for c in self.children],
        }


@dataclass
class FixedPointTarget:
    """One Min/Max-updated property inside a fixedPoint loop."""
    prop: str
    kind: str                     # Min | Max | mixed
    dtype: str
    weighted: bool
    monotone: bool
    line: int = 0

    def summary(self) -> dict:
        return {"prop": self.prop, "kind": self.kind, "dtype": self.dtype,
                "weighted": self.weighted, "monotone": self.monotone}


@dataclass
class FixedPointInfo:
    line: int
    conv_prop: Optional[str]
    conv_written: bool
    targets: List[FixedPointTarget] = field(default_factory=list)

    def summary(self) -> dict:
        return {"line": self.line, "conv_prop": self.conv_prop,
                "conv_written": self.conv_written,
                "targets": [t.summary() for t in self.targets]}


@dataclass
class FunctionEffects:
    """The full analysis result for one DSL function."""
    name: str
    region: Region
    fixedpoints: List[FixedPointInfo] = field(default_factory=list)
    diagnostics: List[Diagnostic] = field(default_factory=list)
    node_props: Dict[str, str] = field(default_factory=dict)
    edge_props: Dict[str, str] = field(default_factory=dict)
    has_set_loop: bool = False
    has_bfs: bool = False
    has_iter_loop: bool = False   # fixedPoint / while / do-while / BFS
    has_relax: bool = False       # any Min/Max update (direction-switchable)
    # Self-gated peeling: a while/do-while whose body plain-writes a property
    # that gates which vertices the enclosing forall / if visits (k-core's
    # `filter(core == 1) { ... v.core = 0 }`).  The converged state is the
    # fixpoint of an erosion, not a monotone relax — warm-starting it from a
    # pre-update run is unsound, so `bound.refresh` refuses (SP209).
    refresh_unsafe: bool = False
    refresh_unsafe_reason: str = ""
    refresh_unsafe_line: int = 0

    def delta_target(self) -> Optional[FixedPointTarget]:
        """The unique monotone int32 Min-relax property eligible for
        delta-stepping, or None — mirrors ``local_jax._delta_target``."""
        cands = []
        for fp in self.fixedpoints:
            if fp.conv_prop is None:
                continue
            for t in fp.targets:
                if (t.monotone and t.kind == "Min" and t.dtype == "int32"
                        and t.prop != fp.conv_prop):
                    cands.append(t)
        return cands[0] if len(cands) == 1 else None

    def summary(self) -> dict:
        return {
            "name": self.name,
            "region": self.region.summary(),
            "fixedpoints": [fp.summary() for fp in self.fixedpoints],
            "flags": {
                "has_set_loop": self.has_set_loop,
                "has_bfs": self.has_bfs,
                "has_iter_loop": self.has_iter_loop,
                "has_relax": self.has_relax,
                "refresh_unsafe": self.refresh_unsafe,
                "delta_target": (self.delta_target().prop
                                 if self.delta_target() else None),
            },
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }


@dataclass
class _LoopEntry:
    iterator: str
    parallel: bool
    kind: str          # semantic iterator kind (iter_vertex|iter_nbr|iter_set|iter_bfs) or ""
    # sharing: concurrent iterations of this loop can alias property slots
    # bound elsewhere.  Source-set foralls are excluded: the batched engine
    # gives each source its own [N, B] lane.
    sharing: bool = False


# --------------------------------------------------------------------------
# Walker
# --------------------------------------------------------------------------

class _EffectWalker:
    def __init__(self, fn: A.Function, info: FunctionInfo,
                 src: Optional[str]):
        self.fn = fn
        self.info = info
        self.src = src
        self.root = Region(kind="function", line=fn.line, iterator="",
                           parallel=False)
        self.regions: List[Region] = [self.root]
        self.loops: List[_LoopEntry] = []
        # SP209 detection state: depth of enclosing while/do-while regions,
        # and a stack of gate-prop sets (props read by enclosing forall
        # filters / if conditions — they decide which slots get visited)
        self.while_depth = 0
        self.gate_props: List[Set[str]] = []
        self.scalar_depths: Dict[str, int] = {
            p.name: 0 for p in info.params}
        self.diagnostics: List[Diagnostic] = []
        self.fixedpoints: List[FixedPointInfo] = []
        self.fx = FunctionEffects(name=fn.name, region=self.root,
                                  node_props=dict(info.node_props),
                                  edge_props=dict(info.edge_props))

    def run(self) -> FunctionEffects:
        self._block(self.fn.body)
        self.fx.fixedpoints = self.fixedpoints
        self.fx.diagnostics = self.diagnostics
        return self.fx

    # ---- helpers ---------------------------------------------------------

    def _emit(self, code: str, msg: str, line: int):
        self.diagnostics.append(
            diag(code, msg, line=line, fn=self.fn.name, src=self.src))

    def _push_region(self, kind: str, line: int, iterator: str = "",
                     parallel: bool = False) -> Region:
        r = Region(kind=kind, line=line, iterator=iterator, parallel=parallel)
        self.regions[-1].children.append(r)
        self.regions.append(r)
        return r

    def _pop_region(self):
        self.regions.pop()

    def _is_prop(self, name: str) -> bool:
        return name in self.info.node_props or name in self.info.edge_props

    def _record_read(self, prop: str, line: int):
        for r in self.regions:
            pa = r.access(prop)
            pa.reads += 1
            pa.read_lines.add(line)

    def _binding_index(self, name: str) -> Optional[int]:
        for i in range(len(self.loops) - 1, -1, -1):
            if self.loops[i].iterator == name:
                return i
        return None

    def _shared_slot(self, binding_idx: Optional[int]) -> bool:
        """True when a parallel loop other than the destination's binding
        loop encloses the write — concurrent iterations hit the same slot."""
        return any(e.sharing for i, e in enumerate(self.loops)
                   if i != binding_idx)

    # ---- reads -----------------------------------------------------------

    def _read(self, e):
        if e is None:
            return
        if isinstance(e, A.Identifier):
            sym = getattr(e, "sym", None)
            if getattr(e, "filter_sugar_iter", None) is not None:
                self._record_read(e.name, e.line)
            elif sym is not None and sym.kind in ("prop_node", "prop_edge"):
                self._record_read(e.name, e.line)
        elif isinstance(e, A.MemberAccess):
            if self._is_prop(e.member) or e.member == "weight":
                self._record_read(e.member, e.line)
            self._read(e.target)
        elif isinstance(e, A.BinaryOp):
            self._read(e.left)
            self._read(e.right)
        elif isinstance(e, A.UnaryOp):
            self._read(e.operand)
        elif isinstance(e, A.ProcCall):
            self._read(e.target)
            for a in e.args:
                self._read(a)
            for _, v in e.kwargs:
                self._read(v)
        elif isinstance(e, A.MinMaxExpr):
            for a in e.args:
                self._read(a)

    def _prop_reads(self, e) -> Set[str]:
        """Property names read anywhere in ``e`` (filter sugar included)."""
        props: Set[str] = set()
        if e is None:
            return props

        def visit(n):
            if isinstance(n, A.Identifier):
                sym = getattr(n, "sym", None)
                if getattr(n, "filter_sugar_iter", None) is not None or (
                        sym is not None
                        and sym.kind in ("prop_node", "prop_edge")):
                    props.add(n.name)
            elif isinstance(n, A.MemberAccess):
                if self._is_prop(n.member):
                    props.add(n.member)
        A.walk(e, visit)
        return props

    def _weighted(self, e) -> bool:
        """Does the expression read an edge weight / edge property?"""
        found = [False]

        def visit(n):
            if isinstance(n, A.MemberAccess) and (
                    n.member == "weight" or n.member in self.info.edge_props):
                found[0] = True
        A.walk(e, visit)
        return found[0]

    # ---- writes ----------------------------------------------------------

    def _record_write(self, prop: str, line: int, *, cross: bool,
                      reduce_op: Optional[str] = None,
                      minmax: Optional[str] = None,
                      weighted: bool = False, extra: bool = False):
        for r in self.regions:
            pa = r.access(prop)
            pa.write_lines.add(line)
            if cross:
                pa.cross_writes += 1
            else:
                pa.self_writes += 1
            if minmax is not None:
                pa.minmax.add(minmax)
                pa.minmax_weighted |= weighted
            elif extra:
                pa.extra_writes += 1
            elif reduce_op is not None:
                pa.reductions.add(reduce_op)
            else:
                pa.plain_writes += 1

    def _write_member(self, ma: A.MemberAccess, line: int, *,
                      reduce_op: Optional[str] = None,
                      minmax: Optional[str] = None,
                      weighted: bool = False, extra: bool = False):
        prop = ma.member
        tgt = ma.target
        if not isinstance(tgt, A.Identifier):
            return
        tsym = getattr(tgt, "sym", None)
        if tsym is None:
            return
        if tsym.kind == "edge_var":
            # an edge var is unique per (src, nbr) iteration pair — private
            self._record_write(prop, line, cross=False, reduce_op=reduce_op,
                               minmax=minmax, weighted=weighted, extra=extra)
            return
        binding = (self._binding_index(tgt.name)
                   if tsym.kind in _ELEM_ITERS else None)
        shared = self._shared_slot(binding)
        cross = tsym.kind == "iter_nbr" or shared
        self._record_write(prop, line, cross=cross, reduce_op=reduce_op,
                           minmax=minmax, weighted=weighted, extra=extra)
        if (reduce_op is None and minmax is None and not extra
                and self.while_depth > 0 and not self.fx.refresh_unsafe
                and any(prop in g for g in self.gate_props)):
            # plain write to a prop that gates visitation, inside a while
            # region: the self-gated peeling pattern (see FunctionEffects)
            self.fx.refresh_unsafe = True
            self.fx.refresh_unsafe_line = line
            self.fx.refresh_unsafe_reason = (
                f"property {prop!r} is plain-assigned inside a while loop "
                f"and also gates which vertices are visited (a filter/if "
                f"condition reads it); this peeling-style fixpoint is not "
                f"monotone over graph updates, so a warm start from the "
                f"pre-update state is unsound")
        if shared and reduce_op is None and minmax is None and not extra:
            self._emit(
                "SP101",
                f"property {prop!r} is plain-assigned through {tgt.name!r} "
                f"inside a parallel loop; concurrent iterations write the "
                f"same slot — use a reduction (`+=`) or a "
                f"`<Min(...)>`/`<Max(...)>` update",
                line)

    def _fold_reduce(self, s: A.AssignmentStmt) -> Optional[str]:
        """Mirror ``lowering.assign``'s `x = x <op> t` fold."""
        if s.reduce_op is not None:
            return s.reduce_op
        rhs = s.rhs
        if not (isinstance(rhs, A.BinaryOp) and rhs.op in _FOLD_OPS):
            return None
        if self._lhs_key(s.lhs) is not None and \
                self._lhs_key(rhs.left) == self._lhs_key(s.lhs):
            return rhs.op
        return None

    @staticmethod
    def _lhs_key(e) -> Optional[str]:
        if isinstance(e, A.Identifier):
            return f"id:{e.name}"
        if isinstance(e, A.MemberAccess) and isinstance(e.target, A.Identifier):
            return f"prop:{e.target.name}.{e.member}"
        return None

    # ---- statements ------------------------------------------------------

    def _block(self, b: A.BlockStmt):
        for s in b.stmts:
            self._stmt(s)

    def _stmt(self, s):
        if isinstance(s, A.DeclarationStmt):
            self.scalar_depths[s.name] = len(self.loops)
            self._read(s.init)
        elif isinstance(s, A.AssignmentStmt):
            self._assign(s)
        elif isinstance(s, A.MultiAssignmentStmt):
            self._multi(s)
        elif isinstance(s, A.ForallStmt):
            self._forall(s)
        elif isinstance(s, A.FixedPointStmt):
            self._fixedpoint(s)
        elif isinstance(s, A.WhileStmt):
            self.fx.has_iter_loop = True
            self._push_region("while", s.line)
            self._read(s.cond)
            self.while_depth += 1
            self._block(s.body)
            self.while_depth -= 1
            self._pop_region()
        elif isinstance(s, A.DoWhileStmt):
            self.fx.has_iter_loop = True
            self._push_region("do_while", s.line)
            self.while_depth += 1
            self._block(s.body)
            self.while_depth -= 1
            self._read(s.cond)
            self._pop_region()
        elif isinstance(s, A.IfStmt):
            self._read(s.cond)
            self.gate_props.append(self._prop_reads(s.cond))
            self._block(s.then_body)
            if s.else_body is not None:
                self._block(s.else_body)
            self.gate_props.pop()
        elif isinstance(s, A.IterateInBFSStmt):
            self._bfs(s)
        elif isinstance(s, A.ProcCallStmt):
            self._proc_call(s.call, s.line)
        elif isinstance(s, A.ReturnStmt):
            self._read(s.value)
        elif isinstance(s, A.BlockStmt):
            self._block(s)

    def _assign(self, s: A.AssignmentStmt):
        reduce_op = self._fold_reduce(s)
        self._read(s.rhs)
        lhs = s.lhs
        if isinstance(lhs, A.MemberAccess):
            self._write_member(lhs, s.line, reduce_op=reduce_op)
            return
        if not isinstance(lhs, A.Identifier):
            return
        sym = getattr(lhs, "sym", None)
        if sym is None:
            return
        if sym.kind in ("prop_node", "prop_edge"):
            # whole-property copy (`pageRank = pageRank_nxt`)
            shared = self._shared_slot(None)
            self._record_write(lhs.name, s.line, cross=shared,
                               reduce_op=reduce_op)
            if shared and reduce_op is None:
                self._emit(
                    "SP101",
                    f"whole-property assignment to {lhs.name!r} inside a "
                    f"parallel loop races across iterations",
                    s.line)
        elif sym.kind == "scalar":
            decl = self.scalar_depths.get(lhs.name, 0)
            shared = any(e.sharing for e in self.loops[decl:])
            if shared and reduce_op is None:
                self._emit(
                    "SP102",
                    f"scalar {lhs.name!r} is plain-assigned inside a "
                    f"parallel loop (last-writer-wins); use a reduction "
                    f"form such as `{lhs.name} = {lhs.name} + ...`",
                    s.line)

    def _multi(self, s: A.MultiAssignmentStmt):
        if (s.values and isinstance(s.values[0], A.MinMaxExpr)
                and s.targets and isinstance(s.targets[0], A.MemberAccess)):
            mm = s.values[0]
            self.fx.has_relax = True
            for a in mm.args:
                self._read(a)
            self._write_member(s.targets[0], s.line, minmax=mm.kind,
                               weighted=self._weighted(mm))
            for t, v in zip(s.targets[1:], s.values[1:]):
                self._read(v)
                if isinstance(t, A.MemberAccess):
                    self._write_member(t, s.line, extra=True)
        else:
            for t, v in zip(s.targets, s.values):
                self._read(v)
                if isinstance(t, A.MemberAccess):
                    self._write_member(t, s.line)

    def _forall(self, s: A.ForallStmt):
        it_sym = getattr(s, "iter_sym", None)
        it_kind = it_sym.kind if it_sym is not None else ""
        if it_kind == "iter_set":
            self.fx.has_set_loop = True
        kind = "forall" if s.parallel else "for"
        self._push_region(kind, s.line, iterator=s.iterator.name,
                          parallel=s.parallel)
        self.loops.append(_LoopEntry(
            iterator=s.iterator.name, parallel=s.parallel, kind=it_kind,
            sharing=s.parallel and it_kind != "iter_set"))
        if isinstance(s.range_call, A.ProcCall):
            self._read(s.range_call)
        if s.filter_expr is not None:
            self._read(s.filter_expr)
        self.gate_props.append(self._prop_reads(s.filter_expr))
        self._block(s.body)
        self.gate_props.pop()
        self.loops.pop()
        self._pop_region()

    def _fixedpoint(self, s: A.FixedPointStmt):
        from .monotone import analyze_fixedpoint  # local: avoid import cycle
        self.fx.has_iter_loop = True
        region = self._push_region("fixedpoint", s.line)
        self._read(s.conv_expr)
        self._block(s.body)
        self._pop_region()
        info, diags = analyze_fixedpoint(s, region, self.info,
                                         self.src, self.fn.name)
        self.fixedpoints.append(info)
        self.diagnostics.extend(diags)

    def _bfs(self, s: A.IterateInBFSStmt):
        self.fx.has_bfs = True
        self.fx.has_iter_loop = True
        self.fx.has_relax = True   # BFS levels are direction-switchable
        self._read(s.root)
        self._push_region("bfs", s.line, iterator=s.iterator.name,
                          parallel=True)
        self.loops.append(_LoopEntry(iterator=s.iterator.name, parallel=True,
                                     kind="iter_bfs", sharing=True))
        if s.filter_expr is not None:
            self._read(s.filter_expr)
        self._block(s.body)
        self.loops.pop()
        self._pop_region()
        if s.reverse is not None:
            rev = s.reverse
            self._push_region("bfs_reverse", rev.line or s.line,
                              iterator=s.iterator.name, parallel=True)
            self.loops.append(_LoopEntry(iterator=s.iterator.name,
                                         parallel=True, kind="iter_bfs",
                                         sharing=True))
            if rev.filter_expr is not None:
                self._read(rev.filter_expr)
            self._block(rev.body)
            self.loops.pop()
            self._pop_region()

    def _proc_call(self, call: A.ProcCall, line: int):
        if call.name in ("attachNodeProperty", "attachEdgeProperty"):
            shared = self._shared_slot(None)
            for prop, vexpr in call.kwargs:
                self._read(vexpr)
                self._record_write(prop, line, cross=shared)
                if shared:
                    self._emit(
                        "SP101",
                        f"{call.name}({prop}=...) inside a parallel loop "
                        f"rewrites the whole property concurrently",
                        line)
        else:
            self._read(call)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def analyze_function(fn: A.Function, info: FunctionInfo,
                     src: Optional[str] = None) -> FunctionEffects:
    """Effect-analyze one semantically-annotated function."""
    return _EffectWalker(fn, info, src).run()
