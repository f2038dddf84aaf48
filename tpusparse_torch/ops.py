"""Public SpMM surface of the port (forward only in this slice).

Counterpart of `tpusparse/ops.py` l.108-163 (`_block_exec`, `_tiled_spmm`),
l.244-269 (`resident_spmm`), l.332-392 (`tiled_spmm`, `spmm_blocks`),
l.605 (`_check_spmm_b`) and l.1173-1311 (`spmm`), for 2-D `b`.

Every op here is a `torch.autograd.Function` whose backward raises
NotImplementedError: the dA (SDDMM kernel) and dB (transpose plan) passes
come with the training slice (ROADMAP.md, "Next slice"), and no plain
PyTorch gradient stands in for them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpusparse_torch.kernels.tiled_spmm import (
    resident_spmm_kernel,
    tiled_spmm_kernel,
)
from tpusparse_torch.plan import Plan, build_plan_pair
from tpusparse_torch.types import COO, CSR, coo_to_csr, spmm_reference

_TRAINING_SLICE = (
    "the backward of the block SpMM (SDDMM dA, transpose-plan dB) comes with "
    "the training slice, ROADMAP.md 'Next slice'"
)

# spmm methods of the JAX package that this slice does not port, with the
# ROADMAP item that brings each.
_UNPORTED_METHODS = {
    "auto": "the cost-model router _route_spmm (ROADMAP queue 1, item 5)",
    "footprint": "the footprint executor (ROADMAP queue 2, item 14)",
    "gather": "gather_spmm (ROADMAP queue 1, item 5)",
    "dense": "the densify path (ROADMAP queue 1, item 5)",
    "naive": "naive_spmm (ROADMAP queue 1, item 5; queue 2, item 4)",
    "dia": "the DIA path (ROADMAP queue 1, item 11)",
}


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
    """C = A @ B from CSR values: pack into blocks, then run `executor`."""

    @staticmethod
    def forward(ctx, executor, plan, data, b):
        return executor(plan, plan.pack_values(data), b)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_TRAINING_SLICE)


class _BlocksSpmm(torch.autograd.Function):
    """C = A @ B from packed ELL blocks."""

    @staticmethod
    def forward(ctx, plan, blocks, b):
        return _block_exec(plan, blocks, b)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_TRAINING_SLICE)


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
            "with ROADMAP queue 1, item 5 (and queue 2, item 9)"
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
    """
    _check_spmm_b(a, b)
    _only_2d("tiled_spmm", b)
    plan, _plan_t, _t_perm = plans or build_plan_pair(a, blocksize)
    return _PackedSpmm.apply(_block_exec, plan, a.data, b)


def resident_spmm(
    a: CSR, b: torch.Tensor, blocksize: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Block SpMM through the resident entry point (forced)."""
    _check_spmm_b(a, b)
    _only_2d("resident_spmm", b)
    plan, _plan_t, _t_perm = build_plan_pair(a, blocksize)
    return _PackedSpmm.apply(resident_spmm_kernel, plan, a.data, b)


def spmm_blocks(plan: Plan, blocks: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B where A is given as the plan's packed ELL blocks."""
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
            "naive_spmm (ROADMAP queue 1, item 5)"
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
