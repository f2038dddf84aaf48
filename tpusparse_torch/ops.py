"""Public op surface of the port, with autograd.

Counterpart of `tpusparse/ops.py` l.59-100 (dense `mm` family), l.108-163
(`_block_exec`, `_tiled_spmm` with its backward), l.228-269
(`resident_spmm`), l.332-455 (`tiled_spmm`, `spmm_blocks` with its
backward), l.605 (`_check_spmm_b`), l.831-867 (`sddmm`) and l.1173-1311
(`spmm`), for 2-D operands.

Every op is a `torch.autograd.Function` whose backward runs on the port's
kernels, with the JAX package's gradient algebra:

  dense mm family   dA and dB as `dense.matmul` products (the GEMM kernel
                    when the config's `use_gemm_kernel` is set)
  block SpMM        dA = SDDMM(dC, B) on A's block pattern (kernels/sddmm.py)
                    dB = Aᵀ·dC on the block executor through the transpose
                    plan (`build_plan_pair` or `block_transpose_plan`)
  sddmm             dX and dY through `spmm_reference`

A backward skips the products whose input needs no gradient
(`ctx.needs_input_grad`): a layer whose input is the data launches no dB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpusparse_torch import dense
from tpusparse_torch.kernels.sddmm import sddmm_kernel
from tpusparse_torch.kernels.tiled_spmm import (
    resident_spmm_kernel,
    tiled_spmm_kernel,
)
from tpusparse_torch.plan import Plan, block_transpose_plan, build_plan_pair
from tpusparse_torch.types import (
    COO,
    CSR,
    coo_to_csr,
    sddmm_reference,
    spmm_reference,
)

# spmm methods of the JAX package that the port does not have yet, with the
# ROADMAP item that brings each.
_UNPORTED_METHODS = {
    "auto": "the cost-model router _route_spmm (ROADMAP queue 1, item 5)",
    "footprint": "the footprint executor (ROADMAP queue 1, item 5; queue 2, row 8)",
    "gather": "gather_spmm (ROADMAP queue 1, item 5)",
    "dense": "the densify path (ROADMAP queue 1, item 5)",
    "naive": "naive_spmm (ROADMAP queue 1, item 5; queue 2, row 10)",
    "dia": "the DIA path (ROADMAP queue 1, item 11)",
}


# ----------------------------------------------------------------------------
# Dense ops: mm / transa_mm / transb_mm / transab_mm
# ----------------------------------------------------------------------------


def _make_dense_op(transa: bool, transb: bool):
    class _DenseOp(torch.autograd.Function):
        """C = op_a(A) @ op_b(B); the gradient algebra of tpusparse/ops.py:67-82."""

        @staticmethod
        def forward(ctx, a, b, use_kernel):
            ctx.use_kernel = use_kernel
            ctx.save_for_backward(a, b)
            return dense.matmul(a, b, transa=transa, transb=transb, use_kernel=use_kernel)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors

            def mm(x, y, **kw):
                return dense.matmul(x, y, use_kernel=ctx.use_kernel, **kw)

            da = db = None
            if ctx.needs_input_grad[0]:
                if not transa:
                    da = mm(g, b, transb=not transb)
                elif not transb:
                    da = mm(b, g, transb=True)
                else:
                    da = mm(b, g, transa=True, transb=True)
            if ctx.needs_input_grad[1]:
                if not transb:
                    db = mm(a, g, transa=not transa)
                elif not transa:
                    db = mm(g, a, transa=True)
                else:
                    db = mm(g, a, transa=True, transb=True)
            return da, db, None

    def checked(a: torch.Tensor, b: torch.Tensor, use_kernel: Optional[bool] = None):
        """`use_kernel` is passed to every `dense.matmul` of the forward and
        the backward (None: the config's `use_gemm_kernel`)."""
        if a.ndim != b.ndim or a.ndim < 2:
            raise ValueError(
                f"dense ops need same-rank ≥2-D operands, got {tuple(a.shape)} x "
                f"{tuple(b.shape)}; use tpusparse_torch.dense.matmul for mixed ranks"
            )
        return _DenseOp.apply(a, b, use_kernel)

    return checked


mm = _make_dense_op(False, False)
transa_mm = _make_dense_op(True, False)
transb_mm = _make_dense_op(False, True)
transab_mm = _make_dense_op(True, True)


# ----------------------------------------------------------------------------
# Block SpMM with autograd
# ----------------------------------------------------------------------------


def _block_exec(plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, **kw):
    """Executor dispatch for plan-driven block SpMM, as in the JAX package:
    the resident entry point when the pattern re-uses the B panel (at least
    one occupied block per block-column), else the ELL entry point. Both
    launch the same CUDA kernel; the TPU's VMEM fit check has no
    counterpart here."""
    if plan.nblocks >= plan.num_col_blocks:
        return resident_spmm_kernel(plan, block_vals, b, **kw)
    return tiled_spmm_kernel(plan, block_vals, b, **kw)


class _PackedSpmm(torch.autograd.Function):
    """C = A @ B from CSR values: pack into blocks, then run `executor`.
    Backward as `_tiled_spmm_bwd`, tpusparse/ops.py:146-160."""

    @staticmethod
    def forward(ctx, executor, plan, plan_t, t_perm, data, b):
        ctx.plan, ctx.plan_t, ctx.t_perm = plan, plan_t, t_perm
        ctx.save_for_backward(data, b)
        return executor(plan, plan.pack_values(data), b)

    @staticmethod
    def backward(ctx, g):
        data, b = ctx.saved_tensors
        plan, plan_t = ctx.plan, ctx.plan_t
        g = g.contiguous()
        d_data = db = None
        if ctx.needs_input_grad[4]:  # dA on A's pattern
            d_data = plan.unpack_values(sddmm_kernel(plan, g, b)).to(data.dtype)
        if ctx.needs_input_grad[5]:  # dB = Aᵀ·dC through the transpose plan
            perm = plan_t.perm_tensor("t_perm", ctx.t_perm, data.device)
            db = _block_exec(plan_t, plan_t.pack_values(data[perm]), g).to(b.dtype)
        return None, None, None, None, d_data, db


class _BlocksSpmm(torch.autograd.Function):
    """C = A @ B from packed ELL blocks. Backward as `_spmm_blocks_bwd`,
    tpusparse/ops.py:426-452, with a concrete pattern; its traced branch
    (`_db_blocks_traced`) serves `shard_map` and comes with `parallel/`
    (ROADMAP queue 1, item 14)."""

    @staticmethod
    def forward(ctx, plan, blocks, b):
        ctx.plan = plan
        ctx.save_for_backward(blocks, b)
        return _block_exec(plan, blocks, b)

    @staticmethod
    def backward(ctx, g):
        blocks, b = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dblocks = db = None
        if ctx.needs_input_grad[1]:
            dblocks = sddmm_kernel(plan, g, b).to(blocks.dtype)
        if ctx.needs_input_grad[2]:
            plan_t, t_slot_perm = block_transpose_plan(plan)
            bm, bk = plan.blocksize
            # pad slots of the transpose plan point at the appended zero block
            ext = torch.cat([blocks.transpose(1, 2), blocks.new_zeros((1, bk, bm))])
            perm = plan_t.perm_tensor("t_slot_perm", t_slot_perm, blocks.device)
            db = _block_exec(plan_t, ext[perm].contiguous(), g).to(b.dtype)
        return None, dblocks, db


def _check_spmm_b(a, b) -> None:
    """Reject a k-mismatched dense operand eagerly."""
    if b.ndim < 2 or b.shape[-2] != a.shape[1]:
        raise ValueError(
            f"b shape {tuple(b.shape)} incompatible with sparse operand "
            f"{a.shape} (need b.shape[-2] == {a.shape[1]})"
        )


def _only_2d(name: str, b: torch.Tensor) -> None:
    if b.ndim != 2:
        raise NotImplementedError(
            f"{name}: {b.ndim}-D b is not ported; the batched 3-D fold comes "
            "with ROADMAP queue 1, item 5 (and queue 2, row 3)"
        )


def tiled_spmm(
    a: CSR,
    b: torch.Tensor,
    blocksize: Optional[Tuple[int, int]] = None,
    plans=None,
) -> torch.Tensor:
    """Inspector-executor SpMM: C = A @ B (A sparse CSR, B dense 2-D).

    Plans are built once per pattern on the host and cached by fingerprint;
    pass `plans=build_plan_pair(...)` to reuse them explicitly.
    Differentiable in `a.data` and `b`.
    """
    _check_spmm_b(a, b)
    _only_2d("tiled_spmm", b)
    plan, plan_t, t_perm = plans or build_plan_pair(a, blocksize)
    return _PackedSpmm.apply(_block_exec, plan, plan_t, t_perm, a.data, b)


def resident_spmm(
    a: CSR, b: torch.Tensor, blocksize: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Block SpMM through the resident entry point (forced); the same
    gradient algebra as `tiled_spmm`."""
    _check_spmm_b(a, b)
    _only_2d("resident_spmm", b)
    plan, plan_t, t_perm = build_plan_pair(a, blocksize)
    return _PackedSpmm.apply(resident_spmm_kernel, plan, plan_t, t_perm, a.data, b)


def spmm_blocks(plan: Plan, blocks: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B where A is given as the plan's packed ELL blocks.
    Differentiable in `blocks` (the full block gradient, pad slots 0) and
    `b`."""
    _only_2d("spmm_blocks", b)
    return _BlocksSpmm.apply(plan, blocks, b)


def spmm(
    a,
    b: torch.Tensor,
    method: str = "tiled",
    reduce: str = "sum",
    blocksize: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Sparse x dense matmul with method dispatch.

    Ported methods: 'tiled' (block-ELL executor), 'resident' (forced
    resident entry point), 'reference' (gather/segment-sum oracle). A 1-D
    `b` is lifted to one column. The other methods of the JAX package,
    reduce != 'sum' and 3-D `b` raise NotImplementedError naming the ROADMAP
    item that brings them; the JAX default method 'auto' is one of them, so
    the port's default is 'tiled'.
    """
    if isinstance(a, COO):
        a = coo_to_csr(a)
    if reduce != "sum":
        raise NotImplementedError(
            f"reduce={reduce!r} is not ported; the reducer modes come with "
            "naive_spmm (ROADMAP queue 1, item 5; queue 2, row 10)"
        )
    if method in _UNPORTED_METHODS:
        raise NotImplementedError(
            f"spmm method {method!r} is not ported; it comes with "
            f"{_UNPORTED_METHODS[method]}"
        )
    if method not in ("tiled", "resident", "reference"):
        raise ValueError(f"unknown spmm method {method!r}")
    if b.ndim == 1:  # SpMV: lift to one-column SpMM
        return spmm(a, b[:, None], method, reduce, blocksize)[..., 0]
    _check_spmm_b(a, b)
    _only_2d("spmm", b)
    if method == "tiled":
        return tiled_spmm(a, b, blocksize=blocksize)
    if method == "resident":
        return resident_spmm(a, b, blocksize=blocksize)
    return spmm_reference(a, b)


# ----------------------------------------------------------------------------
# SDDMM
# ----------------------------------------------------------------------------


def _transpose_pattern(s: CSR) -> CSR:
    """Sᵀ as a CSR (values carried along)."""
    m, k = s.shape
    return coo_to_csr(COO(data=s.data, row=s.indices, col=s.row_ids(), shape=(k, m)))


class _Sddmm(torch.autograd.Function):
    """Pattern-restricted X @ Y on `sddmm_reference`; backward as
    `_sddmm_bwd`, tpusparse/ops.py:842-849."""

    @staticmethod
    def forward(ctx, pattern, x, y):
        ctx.pattern = pattern
        ctx.save_for_backward(x, y)
        return sddmm_reference(pattern, x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        p = ctx.pattern
        s = CSR(data=g, indices=p.indices, indptr=p.indptr, shape=p.shape)
        dx = dy = None
        if ctx.needs_input_grad[1]:
            dx = spmm_reference(s, y.transpose(0, 1)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dy = spmm_reference(_transpose_pattern(s), x).transpose(0, 1).to(y.dtype)
        return None, dx, dy


class _SddmmKernel(torch.autograd.Function):
    """The kernel path of `sddmm`: forward only, as JAX's `use_pallas`."""

    @staticmethod
    def forward(ctx, pattern, x, y):
        plan, _, _ = build_plan_pair(pattern)
        blocks = sddmm_kernel(plan, x.contiguous(), y.transpose(0, 1).contiguous())
        return plan.unpack_values(blocks)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "sddmm(use_kernel=True) is forward only, as the JAX package's "
            "use_pallas path; the default path (use_kernel=False) is differentiable"
        )


def sddmm(
    pattern: CSR, x: torch.Tensor, y: torch.Tensor, use_kernel: bool = False
) -> torch.Tensor:
    """Pattern-restricted (X @ Y): returns per-nonzero values in CSR order.

    x: (m, d), y: (d, k) for an (m, k) pattern. use_kernel=True (JAX's
    `use_pallas`) routes through the block SDDMM kernel via a plan, forward
    only; the default gather path is differentiable in x and y.
    """
    if use_kernel:
        return _SddmmKernel.apply(pattern, x, y)
    return _Sddmm.apply(pattern, x, y)
