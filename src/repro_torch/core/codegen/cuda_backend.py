"""CUDA backend — the paper's CUDA code generator, the port of
`repro.core.codegen.pallas_backend`.

It restructures the two hot patterns onto the hand-written `ell_spmv`
kernel over the degree-bucketed sliced-ELL view, with frontier-aware
direction optimization, exactly where the reference's pallas backend puts
its Pallas kernel:

  * Min edge relaxation → `kops.relax_minplus`: per-bucket min-plus SpMV
    over the REVERSE (in-edge) sliced-ELL view, masked to the current
    frontier, or scatter-push over the CSR out-edges when the frontier is
    sparse. Pull from non-frontier sources cannot change the result, so
    push and pull agree exactly.
  * neighborhood sum reductions (PR) → `kops.gather_plustimes`: per-bucket
    (+,×) SpMV of a per-node contribution vector (plus the COO hub tail).

Everything else inherits the local backend's plain-torch lowering.
"""
from __future__ import annotations

from .. import ir as I
from .base import HostCtx, VertexCtx
from .local_torch import LocalCodegen, has_refresh_variant


def _only_reads_side(expr, side: str) -> bool:
    """True if expr reads only <side>.prop / degree(<side>) / constants."""
    ok = True

    def visit(e):
        nonlocal ok
        if isinstance(e, I.IProp):
            if e.target != side:
                ok = False
        elif isinstance(e, I.IEdgeWeight):
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


class CudaCodegen(LocalCodegen):
    backend_name = "cuda"
    # the kernel op already takes an arbitrary frontier mask, so a delta-
    # stepping fixedPoint relaxes its bucketed window through the same
    # sliced-ELL sweep — no separate `_dell` padded view needed
    supports_delta_ell = False

    def _block_rows_literal(self) -> str:
        """`Schedule.block_rows` as a source literal for the kernel ops: an
        int stays an int, per-bucket caps become a {bucket_width: cap}
        mapping (width-keyed, because empty buckets are dropped from a
        graph's sliced view)."""
        s = self.schedule
        if isinstance(s.block_rows, int):
            return repr(s.block_rows)
        return repr(dict(zip(s.bucket_widths(), s.bucket_block_rows())))

    def _kernel_kwargs(self) -> str:
        """Literal kwargs for kops calls: engine knobs + kernel block caps."""
        return f"{self._engine_kwargs()}, block_rows={self._block_rows_literal()}"

    def _sig_head(self, args):
        # the bound sliced-ELL view is a required positional (the api layer
        # resolves it from the GraphContext per call)
        return [args[0], "_ell"]

    # ---- hot pattern 1: frontier relax → sliced-ELL hybrid kernel ------------
    def emit_relax_hybrid(self, s: I.IMinMaxUpdate, frontier,
                          weighted: bool = True):
        """The pattern the local backend detects, lowered to the kernel op.
        Under delta-stepping the frontier arriving here is already the
        bucketed window, so the same call applies unchanged (and a pull
        trip of it is the one-launch `ell_sweep`). The unweighted relax
        keeps the inherited plain-torch lowering — the min-plus kernel is
        weighted."""
        if not weighted:
            return super().emit_relax_hybrid(s, frontier, weighted)
        em = self.em
        g = self.f.graph_param
        new = em.uid("new")
        fr = frontier or "None"
        em.w(f"{new} = kops.relax_minplus(_ell, {s.prop}, frontier={fr}, "
             f"csr={g}{self._kernel_kwargs()})")
        return new

    # ---- hot pattern 2: neighborhood sum → sliced-ELL (+,×) kernel -----------
    def s_IAssign(self, s: I.IAssign, ctx):
        ectx = self._edge_ctx(ctx)
        # the sweep produces one [N] vector: batched ([B, N]) regions and
        # per-source lane scalars keep the inherited segment lowering
        if (s.reduce_op == "+" and s.vertex_local and ectx is not None
                and ectx.direction == "in" and ectx.mask is None
                and self.batch is None and s.name not in self.lane_scalars
                and _only_reads_side(s.expr, ectx.it)):
            em = self.em
            contrib = em.uid("contrib")
            # evaluate the per-edge term as a per-NODE vector (nbr ↦ node)
            vctx = VertexCtx(it=ectx.it, mask=None, parent=HostCtx())
            em.w(f"{contrib} = {self.ex.expr(s.expr, vctx)}")
            em.w(f"{contrib} = torch.as_tensor({contrib}, dtype=torch.float32, "
                 f"device=_dev) * torch.ones((N,), dtype=torch.float32, device=_dev)")
            em.w(f"{s.name} = {s.name} + kops.gather_plustimes(_ell, "
                 f"{contrib}, block_rows={self._block_rows_literal()})")
            return
        super().s_IAssign(s, ctx)


def generate_cuda(irfn: I.IRFunction, schedule=None):
    """Emit the cuda-backend source (with its `__refresh` variant when the
    program has one); returns (source, extra exec globals)."""
    body = CudaCodegen(irfn, schedule=schedule).generate()
    if has_refresh_variant(irfn):
        rcg = CudaCodegen(irfn, schedule=schedule)
        rcg.refresh_variant = True
        body = body + "\n\n" + rcg.generate()
    from ...kernels.ell_spmv import ops as kops
    return body, {"kops": kops}
