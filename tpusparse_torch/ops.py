"""Public op surface of the port, with autograd.

Counterpart of `tpusparse/ops.py` l.59-100 (dense `mm` family, same-rank
operands of any rank ≥ 2), l.108-163 (`_block_exec`, `_tiled_spmm` with its
backward), l.166-227 (`_batched_resident_ok`, `_tiled_spmm_b3` with its
backward), l.228-269 (`resident_spmm`), l.273-330 (`footprint_spmm` with its
backward), l.332-455 (`tiled_spmm`, `spmm_blocks` with its backward),
l.464-490 and l.740-823 (`naive_spmm` with its sum VJP, `resolve_ell_width`,
`ell_pack_traced`), l.554-597 (`_fold_cols`, `_unfold_cols`, `_fold_batch`),
l.605 (`_check_spmm_b`), l.831-867 (`sddmm`), l.504-534 and l.616
(`gather_spmm`), l.606-740 (`_dia_pattern`, `dia_spmm`), l.880-946
(`transpose_csr`, `dsmm`), l.967-1170 (the cost constants and the router
`_route_spmm` of method='auto') and l.1173-1311 (`spmm`).

Every op is a `torch.autograd.Function` whose backward runs on the port's
kernels, with the JAX package's gradient algebra:

  dense mm family   dA and dB as `dense.matmul` products (the GEMM kernel
                    when the config's `use_gemm_kernel` is set)
  block SpMM        dA = SDDMM(dC, B) on A's block pattern (kernels/sddmm.py)
  (and footprint)   dB = Aᵀ·dC on the block executor through the transpose
                    plan (`build_plan_pair` or `block_transpose_plan`)
  batched block     dA = SDDMM over the batch folded into columns
  SpMM (3-D B)      dB[g] = Aᵀ·dC[g] on the batched executor through the
                    transpose plan
  sddmm             dX and dY through `spmm_reference`
  gather_spmm and   d_data = per-nonzero g[row]·b[col], dB a scatter-add
  naive_spmm (sum)  (XLA take/scatter-add in JAX, index_select/index_add_
                    here: no Pallas kernel on either side); the naive
                    forward runs the naive SpMM kernel (kernels/naive_spmm.py),
                    its other reducers are forward only, as in JAX
  dia_spmm          torch autograd through the shifted slices; the wide-DIA
                    kernel path through `kernels.dia.dia_spmv` (plain torch
                    backward)

A backward skips the products whose input needs no gradient
(`ctx.needs_input_grad`): a layer whose input is the data launches no dB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpusparse_torch import dense
from tpusparse_torch.kernels.naive_spmm import ell_layout, naive_spmm_kernel
from tpusparse_torch.kernels.sddmm import sddmm_kernel
from tpusparse_torch.kernels.tiled_spmm import (
    footprint_spmm_kernel,
    resident_spmm_batched_kernel,
    resident_spmm_kernel,
    tiled_spmm_kernel,
)
from tpusparse_torch.plan import (
    Plan,
    _fingerprint,
    block_transpose_plan,
    build_plan_pair,
    footprint_plan,
)
from tpusparse_torch.types import (
    BSR,
    COO,
    CSR,
    DIA,
    bsr_to_csr,
    coo_to_csr,
    sddmm_reference,
    spmm_reference,
)
from tpusparse_torch.utils.config import get_config, round_up

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
            # batch dims that the forward broadcast are summed back
            if da is not None and da.shape != a.shape:
                da = da.sum_to_size(a.shape)
            if db is not None and db.shape != b.shape:
                db = db.sum_to_size(b.shape)
            return da, db, None

    def checked(a: torch.Tensor, b: torch.Tensor, use_kernel: Optional[bool] = None):
        """op_a(a) @ op_b(b) for same-rank ≥2-D operands, op = transpose of
        the last two dims; batch dims broadcast as in `torch.matmul`.
        `use_kernel` is passed to every `dense.matmul` of the forward and the
        backward (None: the config's `use_gemm_kernel`); it reaches the GEMM
        kernel for 2-D operands only."""
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
    tpusparse/ops.py:426-452, on the concrete pattern. JAX's traced branch
    (`_db_blocks_traced`, tpusparse/ops.py:399-423) exists because its
    pattern is traced under `shard_map`; the port's sharded callers
    (`parallel.train`, `parallel.gcn`) pass each rank's concrete chunk plan,
    so the dB always takes the transpose-plan path below."""

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


def _widened(fn, data: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fn(data, b) with fp16 operands widened to fp32 for the kernels and
    the result cast to their promoted type, as the JAX ops return it (the
    kernels take fp32 and bf16 only)."""
    if torch.float16 not in (data.dtype, b.dtype):
        return fn(data, b)
    out_dtype = torch.promote_types(data.dtype, b.dtype)
    return fn(data.float(), b.float()).to(out_dtype)


def _packed(executor, a: CSR, b: torch.Tensor, plans) -> torch.Tensor:
    """`_PackedSpmm` on the block executor."""
    plan, plan_t, t_perm = plans
    return _widened(
        lambda d, bb: _PackedSpmm.apply(executor, plan, plan_t, t_perm, d, bb.contiguous()),
        a.data, b)


def _batched_resident_ok(plan: Plan, b: torch.Tensor) -> bool:
    """Does a 3-D b take the batched executor (else the fold onto the 2-D
    one)? JAX's test (tpusparse/ops.py:166-183) has three parts: block
    reuse, nblocks >= num_col_blocks; round_up(n, 128) >= 256; and a VMEM
    fit of the whole packed values. The last two are TPU constraints (128
    lanes, VMEM) and are dropped, as `_block_exec` dropped its VMEM test;
    the reuse test is kept. Both routes run one tensor-core body
    (csrc/block_ell_spmm.cuh) on B folded to (k, batch·n), the batched
    executor in place and the fold after a transposing copy of B and C, so
    on the card the two give the same bits."""
    return plan.nblocks >= plan.num_col_blocks


class _PackedSpmmB3(torch.autograd.Function):
    """C[g] = A @ B[g] for a 3-D B on the batched executor. Backward as
    `_tiled_spmm_b3_bwd`, tpusparse/ops.py:199-222."""

    @staticmethod
    def forward(ctx, plan, plan_t, t_perm, data, b):
        ctx.plan, ctx.plan_t, ctx.t_perm = plan, plan_t, t_perm
        ctx.save_for_backward(data, b)
        return resident_spmm_batched_kernel(plan, plan.pack_values(data), b)

    @staticmethod
    def backward(ctx, g):
        data, b = ctx.saved_tensors
        plan, plan_t = ctx.plan, ctx.plan_t
        g = g.contiguous()
        d_data = db = None
        if ctx.needs_input_grad[3]:  # the fold IS the batch sum the dA needs
            d_data = plan.unpack_values(
                sddmm_kernel(plan, _fold_cols(g), _fold_cols(b))).to(data.dtype)
        if ctx.needs_input_grad[4]:  # dB[g] = Aᵀ·dC[g]
            perm = plan_t.perm_tensor("t_perm", ctx.t_perm, data.device)
            bv_t = plan_t.pack_values(data[perm])
            if _batched_resident_ok(plan_t, g):
                db = resident_spmm_batched_kernel(plan_t, bv_t, g)
            else:
                db = _fold_batch(lambda gg: _block_exec(plan_t, bv_t, gg), g)
            db = db.to(b.dtype)
        return None, None, None, d_data, db


def _block_spmm(name: str, executor, a: CSR, b: torch.Tensor, plans) -> torch.Tensor:
    """A 2-D b on `executor`; a 3-D b on the batched executor where the
    pattern re-uses B (`_batched_resident_ok`), else one 2-D launch of
    `executor` on the batch folded into columns."""
    plan, plan_t, t_perm = plans
    if b.ndim == 2:
        return _packed(executor, a, b, plans)
    if b.ndim != 3:
        raise ValueError(f"{name} supports 2-D/3-D b, got {tuple(b.shape)}")
    if _batched_resident_ok(plan, b):
        return _widened(
            lambda d, bb: _PackedSpmmB3.apply(plan, plan_t, t_perm, d, bb.contiguous()),
            a.data, b)
    return _fold_batch(lambda bb: _packed(executor, a, bb, plans), b)


def tiled_spmm(
    a: CSR,
    b: torch.Tensor,
    blocksize: Optional[Tuple[int, int]] = None,
    plans=None,
) -> torch.Tensor:
    """Inspector-executor SpMM: C = A @ B (A sparse CSR, B dense 2-D, or
    3-D (batch, k, n) under the shared pattern).

    Plans are built once per pattern on the host and cached by fingerprint;
    pass `plans=build_plan_pair(...)` to reuse them explicitly.
    Differentiable in `a.data` and `b`.
    """
    _check_spmm_b(a, b)
    return _block_spmm("tiled_spmm", _block_exec, a, b, plans or build_plan_pair(a, blocksize))


def resident_spmm(
    a: CSR, b: torch.Tensor, blocksize: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Block SpMM through the resident entry point (forced; a 3-D b takes the
    batched executor or folds onto the resident entry point); the same
    gradient algebra as `tiled_spmm`."""
    _check_spmm_b(a, b)
    return _block_spmm("resident_spmm", resident_spmm_kernel, a, b,
                       build_plan_pair(a, blocksize))


def spmm_blocks(plan: Plan, blocks: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B where A is given as the plan's packed ELL blocks and b is
    2-D (a 3-D b raises ValueError, as in JAX). Differentiable in `blocks`
    (the full block gradient, pad slots 0) and `b`."""
    return _BlocksSpmm.apply(plan, blocks, b)


class _FootprintSpmm(torch.autograd.Function):
    """C = A @ B on the footprint executor. Backward as
    `_footprint_spmm_bwd`, tpusparse/ops.py:282-296: the base ELL plan's
    SDDMM for dA and the block executor on the transpose plan for dB, as in
    `_PackedSpmm`."""

    @staticmethod
    def forward(ctx, plan, plan_t, t_perm, fplan, data, b):
        ctx.plan, ctx.plan_t, ctx.t_perm = plan, plan_t, t_perm
        ctx.save_for_backward(data, b)
        return footprint_spmm_kernel(fplan, fplan.pack_values(data), b)

    @staticmethod
    def backward(ctx, g):  # data and b sit at the same inputs as in _PackedSpmm
        d_data, db = _PackedSpmm.backward(ctx, g)[4:]
        return None, None, None, None, d_data, db


def footprint_spmm(
    a: CSR,
    b: torch.Tensor,
    blocksize: Optional[Tuple[int, int]] = None,
    rows_per_super: int = 16,
) -> torch.Tensor:
    """B-tile-reuse SpMM on the footprint executor (`plan.FootprintPlan`):
    the slots of `rows_per_super` row-blocks sorted by column, walked by
    thread blocks that each own a 128-row window of the super-row
    (`footprint_tile`). A 3-D b folds into columns. Differentiable like
    `tiled_spmm`."""
    _check_spmm_b(a, b)
    plan, plan_t, t_perm = build_plan_pair(a, blocksize)
    fplan = footprint_plan(plan, rows_per_super=rows_per_super)

    def run(bb):
        return _widened(
            lambda d, b2: _FootprintSpmm.apply(plan, plan_t, t_perm, fplan, d, b2.contiguous()),
            a.data, bb)

    if b.ndim == 2:
        return run(b)
    if b.ndim == 3:
        return _fold_batch(run, b)
    raise ValueError(f"footprint_spmm supports 2-D/3-D b, got {tuple(b.shape)}")


def _gather_grads(needs_data, needs_b, data, indices, rows, b, g):
    """(d_data, dB) of C = A @ B from per-nonzero gathers: dA[t] =
    g[row_t] · b[col_t] and dB = Aᵀ·g by scatter-add (tpusparse/ops.py:
    475-487, 522-531)."""
    g_rows = g.index_select(0, rows)
    d_data = db = None
    if needs_data:
        d_data = (g_rows.float() * b.index_select(0, indices).float()).sum(1).to(data.dtype)
    if needs_b:
        db = torch.zeros_like(b).index_add_(0, indices, (data[:, None] * g_rows).to(b.dtype))
    return d_data, db


class _GatherSpmm(torch.autograd.Function):
    """C = A @ B by row gather and scatter-add over A's nonzeros; backward
    as `_gather_spmm_bwd`, tpusparse/ops.py:522-531."""

    @staticmethod
    def forward(ctx, m, data, indices, rows, b):
        ctx.save_for_backward(data, indices, rows, b)
        out_dtype = torch.promote_types(data.dtype, b.dtype)
        contrib = b.index_select(0, indices) * data[:, None]
        out = torch.zeros((m, b.shape[1]), dtype=out_dtype, device=b.device)
        return out.index_add_(0, rows, contrib.to(out_dtype))

    @staticmethod
    def backward(ctx, g):
        data, indices, rows, b = ctx.saved_tensors
        d_data, db = _gather_grads(ctx.needs_input_grad[1], ctx.needs_input_grad[4],
                                   data, indices, rows, b, g)
        return None, d_data, None, None, db


# Cap on the (nnz, cols) fp32 intermediate that the gather and segment paths
# materialise (tpusparse/ops.py:563): past it the fold runs in batch chunks.
_FOLD_INTERMEDIATE_BYTES = 1 << 30


def _fold_cols(b: torch.Tensor) -> torch.Tensor:
    """(batch, k, n) -> (k, batch·n), contiguous (at n = 1 the reshape alone
    is a strided view)."""
    batch, k, n = b.shape
    return b.transpose(0, 1).reshape(k, batch * n).contiguous()


def _unfold_cols(c: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """(m, batch·n) -> (batch, m, n), a view."""
    return c.reshape(c.shape[0], batch, n).transpose(0, 1)


def _fold_batch(op2d, b: torch.Tensor, max_cols: Optional[int] = None):
    """Run a 2-D SpMM `op2d((k, cols)) -> (m, cols)` on a (batch, k, n) b by
    folding the batch into the column axis, (batch, k, n) -> (k, batch·n),
    in chunks of at most `max_cols` columns (at least one batch element);
    tuple outputs (value, arg) are unfolded each (tpusparse/ops.py:565-597)."""
    batch, k, n = b.shape
    per = batch if max_cols is None else max(min(int(max_cols) // max(n, 1), batch), 1)
    outs = []
    for s0 in range(0, batch, per):
        bb = b[s0:s0 + per]
        g = bb.shape[0]
        out = op2d(_fold_cols(bb))
        parts = out if isinstance(out, tuple) else (out,)
        outs.append(tuple(_unfold_cols(x, g, n) for x in parts))
    res = tuple(torch.cat(xs) if len(xs) > 1 else xs[0] for xs in zip(*outs))
    return res if isinstance(out, tuple) else res[0]


def _gather_fold_cols(nnz: int) -> int:
    """Max folded columns for the (nnz, cols) fp32 gather intermediate."""
    return max(_FOLD_INTERMEDIATE_BYTES // (4 * max(int(nnz), 1)), 1)


def gather_spmm(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Gather/scatter-add SpMM, differentiable in `a.data` and `b`: moves
    exactly nnz·n elements. A 3-D `b` (batch, k, n) is folded into 2-D
    products along its columns, chunked so that the (nnz, cols)
    intermediate stays bounded."""
    _check_spmm_b(a, b)
    if b.ndim == 3:
        return _fold_batch(lambda bb: gather_spmm(a, bb), b, _gather_fold_cols(a.nnz))
    dev = b.device
    indices = torch.from_numpy(a.indices.astype(np.int64)).to(dev)
    rows = torch.from_numpy(a.row_ids().astype(np.int64)).to(dev)
    return _GatherSpmm.apply(a.shape[0], a.data, indices, rows, b)


# ----------------------------------------------------------------------------
# DIA: the banded product
# ----------------------------------------------------------------------------

_DIA_PATTERN_CACHE: dict = {}
_SCAN_U = 32  # diagonals per chunk of the many-diagonal path (JAX's scan step)


def _dia_pattern(a: CSR, max_offsets: int):
    """Fingerprint-cached (offsets, slot, rows) of a CSR pattern's diagonal
    decomposition, or None if it spreads over more than `max_offsets`
    diagonals (tpusparse/ops.py:606-631). Host pattern work."""
    indptr, indices = np.asarray(a.indptr), np.asarray(a.indices)
    key = (_fingerprint(a.shape, (1, 1), indptr, indices), max_offsets)
    if key in _DIA_PATTERN_CACHE:
        return _DIA_PATTERN_CACHE[key]
    m = a.shape[0]
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    offs_all = indices.astype(np.int64) - rows
    offs = np.unique(offs_all)
    hit = None
    if offs.size <= max_offsets:
        hit = (offs, np.searchsorted(offs, offs_all).astype(np.int32), rows.astype(np.int32))
    _DIA_PATTERN_CACHE[key] = hit
    return hit


def dia_spmm(a: DIA, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B for a DIA operand: per diagonal, a shifted slice of the
    zero-padded B times the diagonal's values, no index-driven access
    (tpusparse/ops.py:634-740). Three paths, as in JAX:

      up to 128 diagonals      the unrolled sum, in ascending offset order;
      more, one column         the wide-DIA kernel (`kernels.dia.dia_spmv`),
                               which sums in JAX's plane order, in fp32;
      more, several columns    JAX's chunked scan: chunks of 32 diagonals,
                               the last padded with zero rows at offset 0.

    The torch paths sum in the promoted dtype of A and B. Slots past the
    edge read the zero padding. Differentiable in both operands; a 1-D b is
    one column, a 3-D b maps over its batch."""
    from tpusparse_torch.kernels.dia import dia_spmv

    if not isinstance(a, DIA):
        raise TypeError(f"dia_spmm needs a DIA operand, got {type(a)}")
    m, k = a.shape
    if b.ndim == 1:
        return dia_spmm(a, b[:, None])[:, 0]
    if b.shape[-2] != k:
        raise ValueError(
            f"b shape {tuple(b.shape)} incompatible with sparse operand {a.shape} "
            f"(need b.shape[-2] == {k})")
    if b.ndim == 3:
        return torch.stack([dia_spmm(a, bb) for bb in b])
    offs = a.offsets
    nd = offs.size
    data = a.data.to(b.device)
    if nd > 128 and b.shape[1] == 1:
        return dia_spmv(data, offs, b[:, 0])[:, None]
    lo = int(max(0, -offs.min(initial=0)))
    hi = int(max(0, offs.max(initial=0) + m - k))
    bp = torch.nn.functional.pad(b, (0, 0, lo, hi))
    acc = torch.zeros((m, b.shape[1]), dtype=torch.promote_types(a.dtype, b.dtype),
                      device=b.device)
    if nd == 0:  # no diagonal: the zeros of a product, so both operands keep their graph
        return torch.einsum("dm,dmn->mn", data.to(acc.dtype),
                            bp[:0, None].expand(0, m, b.shape[1]).to(acc.dtype))
    starts = (offs + lo).tolist()
    if nd > 128:  # the scan's padded tail: zero rows at offset 0
        pad = (-nd) % _SCAN_U
        starts += [lo] * pad
        data = torch.nn.functional.pad(data, (0, 0, 0, pad))
    for d, s in enumerate(starts):
        acc = acc + data[d][:, None] * bp[s:s + m]
    return acc


# ----------------------------------------------------------------------------
# Naive SpMM (the reducer kernel)
# ----------------------------------------------------------------------------

# pattern fingerprint -> ELL width, and (fingerprint, width, device) -> the
# pattern half of the ELL pack on that device
_ELL_CACHE: dict = {}
_ELL_PATTERN_CACHE: dict = {}


def _ell_key(a: CSR) -> str:
    return _fingerprint(a.shape, (1, 1), np.asarray(a.indptr), np.asarray(a.indices))


def _ell_width(key: str, a: CSR) -> int:
    width = _ELL_CACHE.get(key)
    if width is None:
        width = int(np.diff(np.asarray(a.indptr)).max(initial=1))
        _ELL_CACHE[key] = width
    return width


def resolve_ell_width(a: CSR) -> int:
    """ELL width (max row nnz, at least 1) of a CSR pattern, cached by
    pattern fingerprint. The port's patterns are always host arrays, so the
    JAX package's traced worst case (min(nnz, k)) has no counterpart."""
    return _ell_width(_ell_key(a), a)


def _ell_pattern(key: str, a: CSR, width: int, device):
    """(col_idx (m, L) int32, flat slot of each nnz int64, nnz_per_row int32,
    col ids int64, row ids int64) on `device`, built once per pattern."""
    ck = (key, width, str(torch.device(device)))
    hit = _ELL_PATTERN_CACHE.get(ck)
    if hit is not None:
        return hit
    col_idx, flat, per_row, rows = ell_layout(a, width)
    hit = tuple(torch.from_numpy(x).to(device) for x in (
        col_idx, flat, per_row, np.asarray(a.indices).astype(np.int64), rows))
    _ELL_PATTERN_CACHE[ck] = hit
    return hit


def ell_pack_traced(a: CSR, width: Optional[int] = None):
    """ELL packing (col_idx, vals, nnz_per_row) on the device of `a.data`,
    width = max row nnz unless given. The pattern half is built on the host
    once per pattern and cached; the values are scattered on the device
    every call, differentiably in `a.data`."""
    key = _ell_key(a)
    width = width or _ell_width(key, a)
    col_idx, flat, per_row, _, _ = _ell_pattern(key, a, width, a.data.device)
    m = a.shape[0]
    vals = torch.zeros((m * width,), dtype=a.data.dtype, device=a.data.device).index_put(
        (flat,), a.data)
    return col_idx, vals.reshape(m, width), per_row


class _NaiveSpmm(torch.autograd.Function):
    """C = A @ B on the naive kernel (reduce='sum'); backward as
    `_naive_spmm_bwd`, tpusparse/ops.py:475-487: no kernel on either side."""

    @staticmethod
    def forward(ctx, shape, pattern, data, b):
        col_idx, flat, per_row, indices, rows = pattern
        m, width = col_idx.shape
        vals = torch.zeros((m * width,), dtype=data.dtype, device=data.device).index_put(
            (flat,), data)
        ctx.save_for_backward(data, indices, rows, b)
        return naive_spmm_kernel((col_idx, vals.reshape(m, width), per_row), shape, b)

    @staticmethod
    def backward(ctx, g):
        data, indices, rows, b = ctx.saved_tensors
        d_data, db = _gather_grads(ctx.needs_input_grad[2], ctx.needs_input_grad[3],
                                   data, indices, rows, b, g.contiguous())
        return None, None, d_data, db


def naive_spmm(a: CSR, b: torch.Tensor, reduce: str = "sum", return_arg: bool = False):
    """Naive ELL SpMM on the naive kernel, with the reducer modes.

    reduce='sum' is differentiable in `a.data` and `b`; the other reducers
    (mean/max/min/mul/div) are forward only, as in JAX. return_arg=True
    (min/max only) also returns the int32 arg matrix: per output element the
    global nnz index attaining the extremum, `a.nnz` on empty rows. The
    result is fp32 (b is taken as fp32, or bf16 as it is). A 3-D `b` is
    folded into one launch along its columns; every reducer acts per output
    element, so the fold is exact.
    """
    _check_spmm_b(a, b)
    if return_arg and reduce not in ("min", "max"):
        raise ValueError("return_arg is only meaningful for reduce='min'/'max'")
    if b.ndim == 3:
        return _fold_batch(lambda bb: naive_spmm(a, bb, reduce, return_arg=return_arg), b)
    if b.dtype not in (torch.float32, torch.bfloat16):
        b = b.float()
    key = _ell_key(a)
    width = _ell_width(key, a)
    if reduce == "sum":
        pattern = _ell_pattern(key, a, width, b.device)
        return _NaiveSpmm.apply(a.shape, pattern, a.data.to(b.device), b.contiguous())
    return naive_spmm_kernel(
        ell_pack_traced(a, width=width), a.shape, b.contiguous(), reduce=reduce,
        return_arg=return_arg, nnz=a.nnz if return_arg else 0)


# ----------------------------------------------------------------------------
# The cost-model router of method='auto'
# ----------------------------------------------------------------------------

# JAX's router constants (tpusparse/ops.py:967-991), fitted on TPU v5e
# measurements. They are kept so that 'auto' picks the method JAX picks on
# the CPU; they are not times of the CUDA kernels. `calibrate`
# (utils/calibrate.py) refits them on the card and saves the fit stamped with
# the card's name; `_load_calibration_into_cost` applies it to operands on a
# card of that name only.
_COST_DEFAULTS = {
    "gather_row_bw": 80e9,
    "gather_per_nnz_floor": 15e-9,
    "tiled_slot_overhead": 120e-9,
    "tiled_bw": 600e9,
    "densify_per_nnz": 9e-9,
    "dense_fp32_flops": 43e12,
    "pack_per_nnz": 5e-9,
    "dia_bw": 480e9,
}
# the constants of operands that no fit reaches: the defaults, with what
# `set_cost_constants` set
_COST = dict(_COST_DEFAULTS)
# the keys `set_cost_constants` set: they override a fit as well
_SET_KEYS: set = set()
# card name -> its fit (None: the calibration file holds none for it)
_FITS: dict = {}
# the TPU constants the JAX router also reads: v5e's HBM rate
# (tpusparse/plan.py:50-54, not the port's H100 `plan._ROOFLINE`) and the
# VMEM budget of its resident executors (tpusparse/utils/config.py:44,
# kernels/tiled_spmm.py:262-271, 495-505)
_TPU_HBM_BANDWIDTH = 819e9
_TPU_VMEM_LIMIT_BYTES = 64 * 1024 * 1024
_ROUTE_CACHE: dict = {}


def _device_name(device) -> Optional[str]:
    """The card's name for a CUDA device, None for any other device."""
    if device is None:
        return None
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else None


def _load_calibration_into_cost(device_name: Optional[str] = None, force: bool = False
                                ) -> Tuple[dict, Optional[str]]:
    """The constants that route an operand on the card named `device_name`,
    and the name of the fit they hold (None where they hold none).

    The fit in `calibration_path()` is read lazily, once a name (`force`
    reads it again), and applies only where it was stamped with that card's
    name; `set_cost_constants`' keys override it. An operand off the card
    (`device_name` None) routes on `_COST`, JAX's constants, whatever file
    there is: the port's form of JAX's backend guard (calibrate.py:125-146).
    """
    if device_name is None:
        return _COST, None
    if force or device_name not in _FITS:
        from tpusparse_torch.utils.calibrate import load_calibration

        _FITS[device_name] = load_calibration(device_name=device_name)
        _ROUTE_CACHE.clear()
    fit = _FITS[device_name]
    if not fit:
        return _COST, None
    merged = dict(_COST)
    merged.update((k_, v) for k_, v in fit.items() if k_ in _COST and k_ not in _SET_KEYS)
    return merged, device_name


def _install_fit(device_name: str, constants: dict) -> None:
    """Apply a fresh `calibrate` fit to the card named `device_name`: it
    replaces the constants `set_cost_constants` set, as JAX's calibrate
    overwrites them."""
    _FITS[device_name] = {k_: float(v) for k_, v in constants.items()}
    _SET_KEYS.difference_update(constants)
    _ROUTE_CACHE.clear()


def get_cost_constants(device=None) -> dict:
    """The router's cost-model constants in effect (a copy) for an operand
    on `device`: a CUDA device's fit where there is one, else `_COST`."""
    return dict(_load_calibration_into_cost(_device_name(device))[0])


def set_cost_constants(**kwargs) -> dict:
    """Override router cost constants on every device, a fit's too; unknown
    keys raise. Clears the route cache so that new decisions apply. Returns
    the constants of operands off the card."""
    for k_, v in kwargs.items():
        if k_ not in _COST:
            raise KeyError(f"unknown cost constant {k_!r}; known: {sorted(_COST)}")
        _COST[k_] = float(v)
        _SET_KEYS.add(k_)
    _ROUTE_CACHE.clear()
    return dict(_COST)


def _tpu_resident_vmem_bytes(bm: int, bk: int, nbc: int, bn: int) -> int:
    """VMEM of JAX's resident executor at ELL width 0, as its router sizes it
    (tiled_spmm.py:262-271)."""
    return nbc * bk * bn * 4 + 2 * bm * bn * 4


def _tpu_resident_batched_vmem_bytes(bm: int, bk: int, nbc: int, num_slots: int,
                                     bn: int) -> int:
    """VMEM of JAX's batched resident executor (tiled_spmm.py:495-505)."""
    return 2 * nbc * bk * bn * 4 + num_slots * bm * bk * 4 + 2 * bm * bn * 4


def _route_spmm(a: CSR, b: torch.Tensor, blocksize: Optional[Tuple[int, int]]) -> str:
    """The method of spmm(method='auto'), from JAX's host cost model
    (tpusparse/ops.py:1041-1170): 'tiled', 'gather', 'dense' or 'dia',
    whichever projects the least time for this pattern and b, on the
    constants of b's device (`_load_calibration_into_cost`)."""
    cfg = get_config()
    cost, fit = _load_calibration_into_cost(_device_name(b.device))
    indptr, indices = np.asarray(a.indptr), np.asarray(a.indices)
    m, k = a.shape
    bm, bk = blocksize or (cfg.spmm_block_m, cfg.spmm_block_k)
    n = int(b.shape[-1])
    if b.ndim == 3:
        n = int(b.shape[0]) * n  # the batch folds into columns
    # the key names the fit: a decision on one card's constants never
    # answers an operand routed on another's, or on the CPU's
    key = (_fingerprint(a.shape, (bm, bk), indptr, indices), n,
           int(b.shape[-1]) if b.ndim == 3 else 0, fit)
    hit = _ROUTE_CACHE.get(key)
    if hit is not None:
        return hit
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    nbc = (k + bk - 1) // bk
    nblocks = int(np.unique((rows // bm) * nbc + indices // bk).size)
    nnz = int(indices.shape[0])
    fold_copy_s = 0.0
    if b.ndim == 3:
        n_elem = int(b.shape[-1])
        bn_e = min(cfg.spmm_block_n, round_up(n_elem, 128))
        batched_ok = (
            nblocks >= nbc
            and round_up(n_elem, 128) >= 256
            and _tpu_resident_batched_vmem_bytes(bm, bk, nbc, nblocks, bn_e)
            <= _TPU_VMEM_LIMIT_BYTES
        )
        if not batched_ok:
            fold_copy_s = 2.0 * (k * n + m * n) * 4.0 / _TPU_HBM_BANDWIDTH
    t_gather = (
        nnz * max(n * 8.0 / cost["gather_row_bw"], cost["gather_per_nnz_floor"])
        + fold_copy_s
    )
    bn_eff = min(cfg.spmm_block_n, n)
    resident_ok = (
        nblocks >= nbc
        and _tpu_resident_vmem_bytes(bm, bk, nbc, bn_eff) <= _TPU_VMEM_LIMIT_BYTES
    )
    b_bytes = min(nblocks * bk, k) * n if resident_ok else nblocks * bk * n
    tiled_bytes = (b_bytes + nblocks * bm * bk + m * n * 2) * 4.0
    t_tiled = (
        max(tiled_bytes / cost["tiled_bw"],
            nblocks * cost["tiled_slot_overhead"] * max(n // 512, 1))
        + nnz * cost["pack_per_nnz"]
        + fold_copy_s
    )
    t_dense = (
        max(2.0 * m * k * n / cost["dense_fp32_flops"],
            (m * k + k * n + m * n) * 4.0 / _TPU_HBM_BANDWIDTH)
        + nnz * cost["densify_per_nnz"]
        + m * k * 4.0 / _TPU_HBM_BANDWIDTH
    )
    candidates = [(t_tiled, "tiled"), (t_gather, "gather"), (t_dense, "dense")]
    pat = _dia_pattern(a, max_offsets=128)
    if pat is not None:
        noff = int(pat[0].size)
        t_dia = noff * m * (n + 2) * 4.0 / cost["dia_bw"] + nnz * cost["pack_per_nnz"]
        candidates.append((t_dia, "dia"))
    method = min(candidates)[1]
    _ROUTE_CACHE[key] = method
    return method


def _csr_dia_spmm(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """spmm(method='dia') on a CSR: its values go into the plane by one
    index-put over (slot, rows), so the gradient reaches them."""
    pat = _dia_pattern(a, max_offsets=128)
    if pat is None:
        raise ValueError(
            "method='dia' needs a banded pattern (<= 128 distinct diagonals); "
            "use csr_to_dia/gather")
    offs, slot, rows = pat
    dev = b.device
    idx = (torch.from_numpy(slot.astype(np.int64)).to(dev),
           torch.from_numpy(rows.astype(np.int64)).to(dev))
    data = torch.zeros((offs.size, a.shape[0]), dtype=a.dtype, device=dev).index_put(
        idx, a.data.to(dev))
    return dia_spmm(DIA(data=data, offsets=offs, shape=a.shape), b)


# ----------------------------------------------------------------------------
# spmm: method dispatch
# ----------------------------------------------------------------------------


def spmm(
    a,
    b: torch.Tensor,
    method: Optional[str] = "auto",
    reduce: str = "sum",
    blocksize: Optional[Tuple[int, int]] = None,
    return_arg: bool = False,
):
    """Sparse × dense matmul with method dispatch (tpusparse/ops.py:1173-1311).

    methods: 'tiled' (the block-ELL executor; a 3-D `b` takes the batched
    executor), 'resident' (its resident entry point, forced), 'footprint'
    (the B-tile-reuse executor, a 3-D `b` folded), 'gather'
    (gather/scatter-add), 'dense' (densify, then `dense.matmul`:
    `torch.matmul`, or the GEMM kernel when the config asks for it),
    'naive' (the naive kernel, with the reducer modes), 'reference' (the
    gather/segment oracle), 'dia' (the banded product `dia_spmm` of the
    CSR's diagonals, at most 128) and 'auto' (JAX's cost-model router
    `_route_spmm` picks 'tiled', 'gather', 'dense' or 'dia'; 'reference'
    for the other reducers). A DIA operand runs `dia_spmm` (sum only). A
    BSR operand is converted to CSR and its blocksize becomes the plan's; a
    COO is converted to CSR. A 1-D `b` is lifted to one column; leading
    dims past the third are folded into one batch. reduce != 'sum' runs on
    'naive', 'reference' or 'auto' only. return_arg=True (reduce 'min'/'max')
    also returns the int32 arg matrix. The default is 'auto', as in JAX
    (None means it too); on a CUDA operand it routes on `calibrate`'s fit
    for that card where one is saved. With `Config.debug_checks` set, the
    CSR operand is validated first (`utils.debug.validate_csr`).
    """
    if method is None:
        method = "auto"
    if return_arg and reduce not in ("min", "max"):
        raise ValueError("return_arg is only meaningful for reduce='min'/'max'")
    if isinstance(a, DIA):
        if reduce != "sum":
            raise ValueError(f"DIA operands support reduce='sum' only (got {reduce!r})")
        return dia_spmm(a, b)
    if isinstance(a, BSR):
        blocksize = blocksize or a.blocksize  # the natural tile of a BSR
        a = bsr_to_csr(a)
    elif isinstance(a, COO):
        a = coo_to_csr(a)
    if get_config().debug_checks:
        from tpusparse_torch.utils.debug import validate_csr

        validate_csr(a)
    if b.ndim == 1:  # SpMV: lift to one-column SpMM
        out = spmm(a, b[:, None], method, reduce, blocksize, return_arg)
        return tuple(o[..., 0] for o in out) if return_arg else out[..., 0]
    _check_spmm_b(a, b)
    if b.ndim > 3:  # fold the leading batch dims
        lead = b.shape[:-2]
        out = spmm(a, b.reshape((-1,) + tuple(b.shape[-2:])), method, reduce, blocksize,
                   return_arg)
        if return_arg:
            return tuple(o.reshape(lead + o.shape[-2:]) for o in out)
        return out.reshape(lead + out.shape[-2:])
    if reduce != "sum" and method in ("auto", "reference"):
        if b.ndim == 3:
            return _fold_batch(lambda bb: spmm_reference(a, bb, reduce, return_arg), b,
                               _gather_fold_cols(a.nnz))
        return spmm_reference(a, b, reduce=reduce, return_arg=return_arg)
    if reduce != "sum" and method != "naive":
        # the other methods are sum-only kernels: returning the sum for an
        # explicitly requested reducer would be wrong values
        raise ValueError(
            f"method {method!r} supports reduce='sum' only (got {reduce!r}); "
            "use method='naive', 'reference' or 'auto'"
        )
    if method == "auto":
        method = _route_spmm(a, b, blocksize)
    if method == "tiled":
        return tiled_spmm(a, b, blocksize=blocksize)
    if method == "footprint":
        return footprint_spmm(a, b, blocksize=blocksize)
    if method == "resident":
        return resident_spmm(a, b, blocksize=blocksize)
    if method == "gather":
        return gather_spmm(a, b)
    if method == "dia":
        return _csr_dia_spmm(a, b)
    if method == "dense":
        dt = torch.promote_types(a.dtype, b.dtype)
        ad = a.to_dense().to(device=b.device, dtype=dt)
        return mm(ad, b.to(dt)) if b.ndim == 2 else dense.matmul(ad, b.to(dt))
    if method == "naive":
        return naive_spmm(a, b, reduce=reduce, return_arg=return_arg)
    if method == "reference":
        if b.ndim == 3:
            return _fold_batch(lambda bb: spmm_reference(a, bb), b, _gather_fold_cols(a.nnz))
        return spmm_reference(a, b)
    raise ValueError(f"unknown spmm method {method!r}")


# ----------------------------------------------------------------------------
# Dense × sparse: X @ A through the cached transposed pattern
# ----------------------------------------------------------------------------

# pattern fingerprint -> (value permutation, transposed indices, indptr)
_T_CACHE: dict = {}


def transpose_csr(a: CSR) -> CSR:
    """Aᵀ as a CSR, with the pattern work done once per pattern on the host:
    the column-sort permutation is cached by fingerprint, and each call's
    values ride one gather on their device (tpusparse/ops.py:883-920).
    Differentiable in `a.data`."""
    indptr, indices = np.asarray(a.indptr), np.asarray(a.indices)
    key = _fingerprint(a.shape, (1, 1), indptr, indices)
    hit = _T_CACHE.get(key)
    if hit is None:
        m, n = a.shape
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
        perm = np.argsort(indices, kind="stable")
        t_indptr = np.zeros(n + 1, dtype=np.int32)
        t_indptr[1:] = np.cumsum(np.bincount(indices, minlength=n)).astype(np.int32)
        hit = (perm, rows[perm].astype(np.int32), t_indptr)
        _T_CACHE[key] = hit
    perm, t_indices, t_indptr = hit
    return CSR(data=a.data[torch.from_numpy(perm).to(a.data.device)], indices=t_indices,
               indptr=t_indptr, shape=(a.shape[1], a.shape[0]))


def dsmm(
    x: torch.Tensor,
    a,
    method: str = "auto",
    blocksize: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Dense × sparse: X @ A with the sparse CSR A on the right, computed as
    (Aᵀ @ Xᵀ)ᵀ through `transpose_csr`, so it takes every `spmm` method and
    its autograd (tpusparse/ops.py:923-946); a DIA operand is transposed as
    a DIA. A 1-D x is the vector-matrix product xᵀA; an N-D x batches over
    its leading dims. The default is 'auto', as in JAX."""
    if x.ndim >= 1 and x.shape[-1] != a.shape[0]:
        raise ValueError(
            f"x shape {tuple(x.shape)} incompatible with right sparse operand "
            f"{a.shape} (need x.shape[-1] == {a.shape[0]})"
        )
    at = a.transpose() if isinstance(a, DIA) else transpose_csr(a)
    if x.ndim == 1:
        return spmm(at, x, method=method, blocksize=blocksize)
    return spmm(at, x.transpose(-1, -2), method=method, blocksize=blocksize).transpose(-1, -2)


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
