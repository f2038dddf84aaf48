"""Naive ELL SpMM with the reducer modes: sum, mean, max, min, mul, div.

Counterpart of `tpusparse/kernels/naive_spmm.py`: `ell_pack` (l.35) and the
TPU kernel `_naive_kernel` (l.68, behind `naive_spmm_pallas` l.142), which
becomes the CUDA kernel `csrc/naive_spmm.cu` behind `naive_spmm_kernel`.

Contract (l.68-135, 142-256): C[i, :] = reduce over row i's ELL slots l <
count[i], in slot order, of vals[i, l] · B[col_idx[i, l], :], from the
reducer's identity, in fp32; `mean` divides by max(count, 1); `max`/`min`
write 0 on an empty row; `div` is a running division from 1. With
`return_arg` (max/min only) it also returns the int32 (m, n) matrix of the
first nnz index attaining the extremum: the update is strict, so ties keep
the first entry; the base of row i is its CSR offset and an empty row keeps
`nnz`. The TPU kernel's SMEM guard (l.170-181) is a budget of the TPU's
scalar memory and has no counterpart here, as the VMEM fit check of the
block executor has none. Its `block_n` tile knob became the kernel's own
choice of B's column strip, the widest that stays in L2
(`_naive_spmm_strips` fixes it, to time widths against each other).

A wrapper given CPU tensors runs `_naive_spmm_plain`, the plain PyTorch
version: a loop over the L slots on whole (m, n) tensors, each step's
product and update rounded on its own, exactly as the kernel rounds them,
so the two are bitwise equal for every reducer. Given CUDA tensors it
launches the kernel or raises. It counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

KERNEL = "naive_spmm"
REDUCTIONS = ("sum", "mean", "max", "min", "mul", "div")
_IDENTITY = {"sum": 0.0, "mean": 0.0, "max": -float("inf"), "min": float("inf"),
             "mul": 1.0, "div": 1.0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"naive_spmm": 0}

Ell = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["naive_spmm"] = 0


def ell_layout(a, width: Optional[int] = None):
    """The pattern half of the ELL pack of a CSR, host numpy: (col_idx (m, L)
    int32 with padded slots at column 0, the flat slot of each nnz int64,
    nnz_per_row (m,) int32, the row of each nnz int64); L = max row nnz (at
    least 1) unless `width` is given."""
    indptr = np.asarray(a.indptr).astype(np.int64)
    indices = np.asarray(a.indices)
    m = a.shape[0]
    per_row = np.diff(indptr)
    L = int(width or max(per_row.max(initial=0), 1))
    if per_row.max(initial=0) > L:
        raise ValueError(f"ell width {L} < max row nnz {per_row.max()}")
    rows = np.repeat(np.arange(m, dtype=np.int64), per_row)
    flat = rows * L + np.arange(indices.shape[0], dtype=np.int64) - np.repeat(indptr[:-1], per_row)
    col_idx = np.zeros((m * L,), dtype=np.int32)
    col_idx[flat] = indices
    return col_idx.reshape(m, L), flat, per_row.astype(np.int32), rows


def ell_pack(a, width: Optional[int] = None) -> Ell:
    """Host-side ELL packing of a CSR matrix (width = max row nnz).

    Returns (col_idx (m, L) int32, vals (m, L) in a's dtype, nnz_per_row
    (m,) int32), on the device of `a.data`. Padded slots point at column 0
    with value 0.
    """
    col_idx, flat, per_row, _ = ell_layout(a, width)
    m, L = col_idx.shape
    dev = a.data.device
    vals = torch.zeros((m * L,), dtype=a.data.dtype, device=dev)
    vals[torch.from_numpy(flat).to(dev)] = a.data
    return (torch.from_numpy(col_idx).to(dev), vals.reshape(m, L),
            torch.from_numpy(per_row).to(dev))


def naive_spmm_kernel(
    ell: Ell, shape: Tuple[int, int], b: torch.Tensor, *, reduce: str = "sum",
    return_arg: bool = False, nnz: int = 0,
):
    """C[i, :] = reduce_{j in row i} A[i, j] · B[j, :] for ELL-packed A.

    ell: (col_idx, vals, nnz_per_row) from `ell_pack`; b: (k, n) fp32 or
    bf16. Returns (m, n) fp32, and with `return_arg` (min/max only) also the
    (m, n) int32 arg matrix, `nnz` on empty rows.
    """
    return _naive_spmm_strips(ell, shape, b, reduce, return_arg, nnz, strip_cols=0)


def _naive_spmm_strips(ell: Ell, shape, b: torch.Tensor, reduce: str, return_arg: bool,
                       nnz: int, strip_cols: int):
    """`naive_spmm_kernel` with the width of the kernel's column strips of B
    given: 0 takes the widest strip that stays within its L2 budget
    (`L2_STRIP_BYTES` in csrc/naive_spmm.cu); a positive count of columns
    fixes it, for timing strip widths against each other. It must be a
    power of two of lanes (at most 32) times the columns a lane owns: 4 fp32
    or 8 bf16 where B's rows are whole 16-byte chunks, else 1."""
    col_idx, vals, nnz_per_row = _check(ell, shape, b, reduce, return_arg)
    if b.device.type == "cpu":
        return _naive_spmm_plain((col_idx, vals, nnz_per_row), shape, b, reduce=reduce,
                                 return_arg=return_arg, nnz=nnz)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    m, n = shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    arg = torch.empty((m, n), dtype=torch.int32, device=b.device) if return_arg else None
    if m and n:
        base = _row_base(nnz_per_row) if return_arg else None
        rc = _kernel_fn()(
            col_idx.data_ptr(), vals.data_ptr(), nnz_per_row.data_ptr(),
            base.data_ptr() if return_arg else None, b.data_ptr(), out.data_ptr(),
            arg.data_ptr() if return_arg else None, _DTYPE_CODE[b.dtype],
            REDUCTIONS.index(reduce), int(return_arg), m, b.shape[0], n, col_idx.shape[1],
            int(nnz), int(strip_cols), b.device.index or 0,
            torch.cuda.current_stream(b.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
        _LAUNCHES["naive_spmm"] += 1
    return (out, arg) if return_arg else out


def _check(ell: Ell, shape, b: torch.Tensor, reduce: str, return_arg: bool) -> Ell:
    """The guards of `naive_spmm_pallas` (l.159-166) and the kernel's own
    layout: int32 indices, fp32 values, contiguous on b's device."""
    if reduce not in REDUCTIONS:
        raise ValueError(f"unknown reduce {reduce!r}; options {REDUCTIONS}")
    if return_arg and reduce not in ("min", "max"):
        raise ValueError("return_arg is only meaningful for min/max")
    m, k = shape
    if b.ndim != 2 or b.shape[0] != k:
        raise ValueError(f"b shape {tuple(b.shape)} incompatible with A {tuple(shape)}")
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"b dtype {b.dtype} not supported (float32, bfloat16)")
    col_idx, vals, nnz_per_row = ell
    if col_idx.ndim != 2 or col_idx.shape[0] != m or vals.shape != col_idx.shape or (
            tuple(nnz_per_row.shape) != (m,)):
        raise ValueError(
            f"ELL arrays {tuple(col_idx.shape)}/{tuple(vals.shape)}/"
            f"{tuple(nnz_per_row.shape)} do not fit A {tuple(shape)}")
    col_idx = col_idx.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    nnz_per_row = nnz_per_row.to(torch.int32).contiguous()
    for name, t in (("col_idx", col_idx), ("vals", vals), ("nnz_per_row", nnz_per_row)):
        if t.device != b.device:
            raise ValueError(f"{name} on {t.device} and b on {b.device}: same device needed")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    return col_idx, vals, nnz_per_row


def _row_base(nnz_per_row: torch.Tensor) -> torch.Tensor:
    """Row -> its first global nnz index (the exclusive prefix sum)."""
    return (torch.cumsum(nnz_per_row, 0, dtype=torch.int32) - nnz_per_row).contiguous()


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/naive_spmm.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # col_idx, vals, nnz_per_row, row_base, b, out, arg, b_dtype, reduce,
    # return_arg, m, k, n, L, nnz_fill, strip_cols, device, stream
    return _build.bind(KERNEL, {"naive_spmm": [p] * 7 + [i] * 10 + [p]})["naive_spmm"]


def _naive_spmm_plain(
    ell: Ell, shape: Tuple[int, int], b: torch.Tensor, *, reduce: str = "sum",
    return_arg: bool = False, nnz: int = 0,
):
    """Plain PyTorch version of the kernel, on the inputs' device: a loop
    over the L slots on whole (m, n) tensors, each slot's product and update
    taken where l < count, in the kernel's order and rounding."""
    col_idx, vals, count = ell
    m, n = shape[0], b.shape[1]
    dev = b.device
    bf, vf = b.float(), vals.float()
    count = count.to(dev).long()
    acc = torch.full((m, n), _IDENTITY[reduce], dtype=torch.float32, device=dev)
    if return_arg:
        arg = torch.full((m, n), nnz, dtype=torch.int32, device=dev)
        base = _row_base(count.to(torch.int32))
    for l in range(col_idx.shape[1]):
        active = (count > l)[:, None]
        x = vf[:, l, None] * bf.index_select(0, col_idx[:, l].long())
        if return_arg:
            better = active & ((x > acc) if reduce == "max" else (x < acc))
            acc = torch.where(better, x, acc)
            arg = torch.where(better, base[:, None] + l, arg)
            continue
        if reduce in ("sum", "mean"):
            new = acc + x
        elif reduce in ("max", "min"):
            new = torch.where(((x > acc) if reduce == "max" else (x < acc)) | x.isnan(), x, acc)
        elif reduce == "mul":
            new = acc * x
        else:
            new = acc / x
        acc = torch.where(active, new, acc)
    if reduce == "mean":
        acc = acc / count.clamp_min(1).float()[:, None]
    if reduce in ("max", "min"):
        acc = torch.where((count > 0)[:, None], acc, 0.0)
    return (acc, arg) if return_arg else acc
