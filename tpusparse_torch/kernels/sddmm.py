"""SDDMM restricted to a plan's block pattern: the dA of C = A @ B.

Counterpart of `tpusparse/kernels/sddmm.py:35-130` (`_sddmm_kernel` behind
`sddmm_pallas`). The TPU kernel becomes the CUDA kernel `csrc/sddmm.cu`.
For every ELL slot (i, l) of the plan it computes the dense (bm, bk) block
dC[i-th row-block] @ B[block_cols[i, l]-th block]ᵀ, summed over n; pad
slots are 0, as are rows past m and columns past k inside a block.
Per-nonzero CSR values come from `plan.unpack_values(...)`.

Precision tiers are those of the block SpMM executor (`tiled_spmm.py`):
'high'/'highest' fp32 FFMA, never TF32; 'default' rounds both operands to
bf16 and accumulates in fp32.

A wrapper given CPU tensors runs `_sddmm_plain`, the plain PyTorch version
of the same function. Given CUDA tensors it launches the kernel or raises.
It counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusparse_torch.plan import Plan
from tpusparse_torch.utils.config import fp32_matmul, resolve_precision

KERNEL = "sddmm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"sddmm": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["sddmm"] = 0


def sddmm_kernel(
    plan: Plan, dc: torch.Tensor, b: torch.Tensor, *, precision: str | None = None
) -> torch.Tensor:
    """Block-pattern-restricted dC @ Bᵀ.

    dc: (m, n) dense gradient of C; b: (k, n) dense operand, both
    row-major. Returns (plan.num_slots, bm, bk) blocks in dc's dtype. The
    TPU kernel's `block_n` tile knob is not carried: the CUDA kernel runs
    the whole n loop per output tile.
    """
    _check(plan, dc, b)
    tier = resolve_precision(precision)
    if dc.device.type == "cpu":
        return _sddmm_plain(plan, dc, b, precision=tier)
    if dc.device.type != "cuda":
        raise ValueError(f"unsupported device {dc.device}")
    out = _launch(plan, dc, b, round_bf16=tier == "default")
    _LAUNCHES["sddmm"] += 1
    return out


def _check(plan: Plan, dc: torch.Tensor, b: torch.Tensor) -> None:
    m, k = plan.shape
    if dc.ndim != 2 or b.ndim != 2 or dc.shape[0] != m or b.shape[0] != k or (
        dc.shape[1] != b.shape[1]
    ):
        raise ValueError(
            f"sddmm shape mismatch: dc {tuple(dc.shape)}, b {tuple(b.shape)}, "
            f"plan {plan.shape}"
        )
    for name, t in (("dc", dc), ("b", b)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dc.device != b.device:
        raise ValueError(f"dc on {dc.device} and b on {b.device}: same device needed")


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/sddmm.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    fn = _build.load(KERNEL).sddmm
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch(plan: Plan, dc: torch.Tensor, b: torch.Tensor, round_bf16: bool):
    m, k = plan.shape
    bm, bk = plan.blocksize
    n = dc.shape[1]
    if min(m, k, n) == 0:  # no block or an empty sum: every block is 0
        return torch.zeros((plan.num_slots, bm, bk), dtype=dc.dtype, device=dc.device)
    out = torch.empty((plan.num_slots, bm, bk), dtype=dc.dtype, device=dc.device)
    cols = plan.index_tensor("block_cols", dc.device)
    nslots = plan.index_tensor("nslots", dc.device)
    stream = torch.cuda.current_stream(dc.device).cuda_stream
    rc = _kernel_fn()(
        dc.data_ptr(), _DTYPE_CODE[dc.dtype], b.data_ptr(), _DTYPE_CODE[b.dtype],
        out.data_ptr(), cols.data_ptr(), nslots.data_ptr(),
        m, k, n, bm, bk, plan.num_row_blocks, plan.ell_width,
        int(round_bf16), dc.device.index or 0, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    return out


def _sddmm_plain(
    plan: Plan, dc: torch.Tensor, b: torch.Tensor, *, precision: str | None = None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the inputs' device.

    Zero-pads dC to (nbr*bm, n) and B to (nbc*bk, n), gathers the
    (nbr, L, bk, n) B tiles at block_cols, contracts in fp32 with TF32 off
    and zeroes the pad slots. The 'default' tier rounds both operands to
    bf16 first, as the kernel does.
    """
    m, k = plan.shape
    bm, bk = plan.blocksize
    nbr, nbc, L = plan.num_row_blocks, plan.num_col_blocks, plan.ell_width
    n = dc.shape[1]
    dev = dc.device
    df, bf = dc.float(), b.float()
    if resolve_precision(precision) == "default":
        df = df.to(torch.bfloat16).float()
        bf = bf.to(torch.bfloat16).float()
    dp = torch.zeros((nbr * bm, n), dtype=torch.float32, device=dev)
    dp[:m] = df
    bp = torch.zeros((nbc * bk, n), dtype=torch.float32, device=dev)
    bp[:k] = bf
    cols = plan.index_tensor("block_cols", dev).reshape(nbr, L).long()
    tiles = bp.reshape(nbc, bk, n)[cols]  # (nbr, L, bk, n)
    with fp32_matmul():
        out = torch.einsum("imn,ilkn->ilmk", dp.reshape(nbr, bm, n), tiles)
    valid = plan.slot_valid_mask(dev).bool()[..., None, None]
    out = torch.where(valid, out, 0.0)
    return out.reshape(plan.num_slots, bm, bk).to(dc.dtype)
