"""Shared code-generation machinery.

Backends emit real Python/PyTorch *source text* (the paper's compiler is
source-to-source; so is this one — the generated module is inspectable via
`CompiledProgram.source`). Every engine knob a backend consults comes from
the compiled `Schedule` and is emitted as a literal into that text — the
generated program never reads mutable global state, so one schedule means
one byte-identical source. The vectorization model:

  host ctx    : scalars are 0-d tensors, properties are [N] tensors
  vertex ctx  : `forall(v in g.nodes())` — statements become whole-array ops;
                a filter is a boolean mask (predication, the TPU analogue of
                the paper's `if (!modified[v]) continue;`)
  edge ctx    : `forall(nbr in g.neighbors(v)/g.nodes_to(v))` — statements
                become per-edge ops on the CSR edge arrays; reads of v.prop /
                nbr.prop gather through the edge endpoint ids; reductions
                lower to segment ops (pull) or scatter combines (push)
  BFS ctx     : `iterateInBFS` — per-level masks over the BFS DAG
                (level[src]==l && level[dst]==l+1), per the paper's semantics
                that `neighbors()` means DAG neighbors inside the construct
  wedge ctx   : doubly-nested neighbor loops over the same vertex (TC)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .. import ir as I


class CodegenError(Exception):
    pass


_BINOP = {"+": "+", "-": "-", "*": "*", "/": "/", "%": "%",
          "<": "<", ">": ">", "<=": "<=", ">=": ">=", "==": "==", "!=": "!=",
          "&&": "&", "||": "|"}
_UNOP = {"!": "~", "-": "-"}


class Emitter:
    def __init__(self):
        self.lines: List[str] = []
        self.indent = 0
        self._uid = 0

    def uid(self, prefix: str) -> str:
        self._uid += 1
        return f"_{prefix}{self._uid}"

    def w(self, line: str = ""):
        self.lines.append("    " * self.indent + line if line else "")

    def block(self):
        return _IndentCtx(self)

    def source(self) -> str:
        return "\n".join(self.lines) + "\n"


class _IndentCtx:
    def __init__(self, em):
        self.em = em

    def __enter__(self):
        self.em.indent += 1

    def __exit__(self, *a):
        self.em.indent -= 1


# --------------------------------------------------------------------------
# Emission contexts
# --------------------------------------------------------------------------

@dataclass
class HostCtx:
    kind: str = "host"
    node_bindings: dict = field(default_factory=dict)  # node-param/set-iter name -> py expr


@dataclass
class VertexCtx:
    it: str
    mask: Optional[str]          # name of [N] bool mask var, or None
    parent: object = None
    kind: str = "vertex"


@dataclass
class EdgeCtx:
    it: str                      # neighbor iterator name
    source: str                  # outer vertex iterator
    direction: str               # 'out' | 'in'
    vid: str                     # py expr: edge-array ids of the source side
    nid: str                     # py expr: edge-array ids of the neighbor side
    w: str                       # py expr: per-edge weights
    seg: str = ""                # py expr: segment ids for reductions to the source
    seg_sorted: bool = True      # seg array sorted (CSR row order)?
    mask: Optional[str] = None   # [E] bool mask var, or None
    # frontier-engine bookkeeping: the [N] vertex masks the edge mask was
    # derived from, when it was derived from nothing else (`pure_frontier`).
    src_vmask: Optional[str] = None  # [N] mask of the source side (vertex filter)
    it_vmask: Optional[str] = None   # [N] mask of the neighbor side (nbr filter)
    pure_frontier: bool = False      # mask == exactly those vmask gathers
    parent: object = None
    kind: str = "edge"


@dataclass
class BFSCtx:
    it: str                      # BFS vertex iterator
    level: str                   # py expr for the level array var
    cur: str                     # py expr for current level scalar
    mask: Optional[str]          # [N] vertex mask (level==cur [& rev filter])
    parent: object = None
    kind: str = "bfs"


@dataclass
class BatchInfo:
    """Active batched source-set region (`forall(src in sourceSet)` with
    `Schedule.batch_sources > 1`): per-source vertex state is [B, N] — row b
    is source b's view — and the fields below are the generated-code names
    the emitters use to index into the batch."""

    size: str                    # py expr: static chunk width (python int)
    lane: str                    # py expr: int32[B] = arange(B)
    srcs: str                    # py expr: int32[B] source ids of this chunk
    srcs2d: str                  # py expr: [B, 1] view (broadcasts over [.., N])
    valid: str                   # py expr: bool[B] padding mask (last chunk)
    it: str                      # the set-iterator name bound to srcs2d
    arrays: set = field(default_factory=set)  # names shaped [B, N] (vs shared [N])
    # per-source scalars declared at set-loop body depth: one value per
    # lane, shaped [B] (vs the [B, N] property arrays above)
    lane_scalars: set = field(default_factory=set)


def ctx_chain(ctx):
    while ctx is not None:
        yield ctx
        ctx = getattr(ctx, "parent", None)


# --------------------------------------------------------------------------
# Pattern helpers (frontier-engine hot-path detection)
# --------------------------------------------------------------------------

def prop_plus_weight(cand, other_side: str):
    """Match `<other>.prop + e.weight` (either order) → prop name, or None."""
    if not isinstance(cand, I.IBin) or cand.op != "+":
        return None
    a, b = cand.left, cand.right
    for x, y in ((a, b), (b, a)):
        if isinstance(x, I.IProp) and x.target == other_side and \
                isinstance(y, I.IEdgeWeight):
            return x.prop
    return None


def relax_candidate(cand, other_side: str):
    """Match a Min-relax candidate contributed by `other_side`: either
    `<other>.prop + e.weight` (the weighted SSSP relax) or a bare
    `<other>.prop` (the unweighted relax — CC's component min). Returns
    (prop, weighted) or None; both shapes route through the same push/pull
    frontier machinery, the unweighted one simply drops the `+ w` term."""
    p = prop_plus_weight(cand, other_side)
    if p is not None:
        return p, True
    if isinstance(cand, I.IProp) and cand.target == other_side:
        return cand.prop, False
    return None


def pure_vertex_predicate(expr, side: str) -> bool:
    """True if `expr` reads only <side>.prop, constants, and host scalars —
    i.e. it can be evaluated once as an [N] vertex mask instead of per edge.
    Rejects edge weights, foreign iterators, and vertex-local scalars (which
    are aligned to the *outer* vertex, not `side`)."""
    ok = True

    def visit(e):
        nonlocal ok
        if isinstance(e, I.IProp):
            if e.target != side:
                ok = False
        elif isinstance(e, (I.IEdgeWeight, I.IVertexLocal)):
            ok = False
        elif isinstance(e, I.IIterId) and e.name != side:
            ok = False
        elif isinstance(e, I.IBin):
            visit(e.left); visit(e.right)
        elif isinstance(e, I.IUn):
            visit(e.operand)
        elif isinstance(e, I.ICall):
            for a in e.args:
                visit(a)

    visit(expr)
    return ok


class ExprEmitter:
    """IR expression → python source, given a context."""

    def __init__(self, irfn: I.IRFunction, graph_var: str = "g"):
        self.irfn = irfn
        self.g = graph_var
        # fixedPoint write-redirect: prop -> replacement var (read side stays)
        self.prop_read_alias: dict = {}
        # active batched source-set region (set by the codegen), or None
        self.batch: Optional[BatchInfo] = None

    # -- helpers --------------------------------------------------------------
    def index_of(self, name: str, ctx) -> str:
        """Array (or scalar) of ids for iterator/param `name` in `ctx`."""
        for c in ctx_chain(ctx):
            if isinstance(c, EdgeCtx):
                if name == c.source:
                    return c.vid
                if name == c.it:
                    return c.nid
            elif isinstance(c, VertexCtx) and name == c.it:
                return "_vids"
            elif isinstance(c, BFSCtx) and name == c.it:
                return "_vids"
            elif isinstance(c, HostCtx) and name in c.node_bindings:
                return c.node_bindings[name]
        return name  # node param / set iterator bound as a local python var

    def prop_read(self, prop: str) -> str:
        return self.prop_read_alias.get(prop, prop)

    def expr(self, e: I.IRExpr, ctx) -> str:
        if isinstance(e, I.IConst):
            if e.kind == "inf":
                return "rt.INF"
            if e.kind == "bool":
                return "True" if e.value else "False"
            return repr(e.value)
        if isinstance(e, I.IScalar):
            return e.name
        if isinstance(e, I.IVertexLocal):
            b = self.batch
            if b is not None and e.name in b.lane_scalars:
                # per-source [B] scalar read inside a vertex/edge/BFS region:
                # add a trailing axis so it broadcasts against the [B, N] /
                # [B, E] arrays of the batched region; at host level the
                # bare [B] value is the per-lane scalar itself
                for c in ctx_chain(ctx):
                    if isinstance(c, (VertexCtx, EdgeCtx, BFSCtx)):
                        return f"{e.name}[:, None]"
            return e.name
        if isinstance(e, I.INodeParam):
            return self.index_of(e.name, ctx)
        if isinstance(e, I.IIterId):
            return self.index_of(e.name, ctx)
        if isinstance(e, I.IProp):
            arr = self.prop_read(e.prop)
            if e.target is None:
                return arr
            idx = self.index_of(e.target, ctx)
            if idx == "_vids":
                return arr            # vertex ctx: aligned whole array
            b = self.batch
            if b is not None and e.prop in b.arrays:
                if idx == b.srcs2d:   # src.prop on a batched prop: lane-diagonal
                    return f"{arr}[{b.lane}, {b.srcs}][:, None]"
                return f"{arr}[:, {idx}]"   # batched gather: [B, E] / [B, ...]
            return f"{arr}[{idx}]"
        if isinstance(e, I.IEdgeWeight):
            for c in ctx_chain(ctx):
                if isinstance(c, EdgeCtx):
                    return c.w
            raise CodegenError("e.weight outside a neighbor loop")
        if isinstance(e, I.IBin):
            return f"({self.expr(e.left, ctx)} {_BINOP[e.op]} {self.expr(e.right, ctx)})"
        if isinstance(e, I.IUn):
            return f"({_UNOP[e.op]}{self.expr(e.operand, ctx)})"
        if isinstance(e, I.ICall):
            return self.call(e, ctx)
        raise CodegenError(f"unhandled expr {type(e).__name__}")

    def call(self, e: I.ICall, ctx) -> str:
        g = self.g
        if e.fn == "num_nodes":
            return f"{g}.num_nodes"
        if e.fn == "num_edges":
            return f"{g}.num_edges"
        if e.fn == "count_out_nbrs":
            idx = self.expr(e.args[0], ctx)
            return f"{g}.out_degree" if idx == "_vids" else f"{g}.out_degree[{idx}]"
        if e.fn == "count_in_nbrs":
            idx = self.expr(e.args[0], ctx)
            return f"{g}.in_degree" if idx == "_vids" else f"{g}.in_degree[{idx}]"
        if e.fn == "is_an_edge":
            u = self.expr(e.args[0], ctx)
            w = self.expr(e.args[1], ctx)
            return f"rt.is_an_edge({g}, {u}, {w})"
        if e.fn == "abs":
            return f"torch.abs({self.expr(e.args[0], ctx)})"
        if e.fn == "min_wt":
            return f"torch.min({g}.weights)"
        if e.fn == "max_wt":
            return f"torch.max({g}.weights)"
        raise CodegenError(f"unknown builtin {e.fn}")
