"""SDDMM restricted to a plan's block pattern: the dA of C = A @ B.

Counterpart of `tpusparse/kernels/sddmm.py:35-130` (`_sddmm_kernel` behind
`sddmm_pallas`). The TPU kernel becomes the CUDA kernel `csrc/sddmm.cu`.
For every ELL slot (i, l) of the plan it computes the dense (bm, bk) block
dC[i-th row-block] @ B[block_cols[i, l]-th block]ᵀ, summed over n; pad
slots are 0, as are rows past m and columns past k inside a block.
Per-nonzero CSR values come from `plan.unpack_values(...)`.

Precision tiers are those of the block SpMM executor (`tiled_spmm.py`):
'high'/'highest' are fp32-class (3xTF32 on the tensor cores), never plain
TF32; 'default' rounds both operands to bf16 and sums in fp32.

Where the plan's tiles are too few to fill the card, the kernel splits n
into `sddmm_splits(...)` ranges and adds their fp32 partials in a second
pass, in ascending range order (deterministic for a given split).

A wrapper given CPU tensors runs `_sddmm_plain`, the plain PyTorch version
of the same function. Given CUDA tensors it launches the kernel or raises.
It counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusparse_torch.plan import Plan
from tpusparse_torch.utils.config import cdiv, fp32_matmul, resolve_precision

KERNEL = "sddmm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"sddmm": 0}
# The split over n (csrc/sddmm.cu): a range is made of whole units of
# SPLIT_UNIT n-values (a whole 128-byte chunk in every tier), at least
# SPLIT_MIN_UNITS of them (2,048 values, so a thread block's prologue,
# epilogue and partial tile stay small beside its K loop), at most
# SPLIT_MAX ranges.
SPLIT_UNIT = 64
SPLIT_MIN_UNITS = 32
SPLIT_MAX = 64


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
    TPU kernel's `block_n` tile knob is not carried: the CUDA kernel tiles
    n itself (`sddmm_splits`).
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


def sddmm_tiles(plan: Plan) -> int:
    """Thread blocks of one range of n: the valid slots times the kernel's
    tiles a block, ceil(bm / 128) x ceil(bk / 128) (a tile is 64 or 128
    rows and 32, 64 or 128 columns, csrc/wgmma_tiles.cuh)."""
    bm, bk = plan.blocksize
    return plan.nblocks * cdiv(bm, 128) * cdiv(bk, 128)


def sddmm_splits(tiles: int, n: int, sms: int) -> int:
    """The ranges S that csrc/sddmm.cu splits n into, for `tiles` thread
    blocks of one range, a sum over n and a card of `sms` SMs.

    S = 1 where the tiles fill the card (tiles ≥ sms). Otherwise S is the
    value up to min(SPLIT_MAX, units // SPLIT_MIN_UNITS), units =
    ceil(n / SPLIT_UNIT), that gives the fewest waves per unit of work,
    ceil(tiles · S / sms) / S (one thread block an SM: the 3xTF32 tile's two
    stages take 129 KiB of shared memory); ties go to the smaller S. So S
    never exceeds the number of units.
    """
    if tiles >= sms or tiles <= 0:
        return 1
    best = 1
    for s in range(2, min(SPLIT_MAX, cdiv(n, SPLIT_UNIT) // SPLIT_MIN_UNITS) + 1):
        if cdiv(tiles * s, sms) * best < cdiv(tiles * best, sms) * s:
            best = s
    return best


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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

    p, i = ctypes.c_void_p, ctypes.c_int
    # dc, dc_dtype, b, b_dtype, out, ws, block_cols, nslots, m, k, n, bm, bk,
    # nbr, L, splits, round_bf16, device, stream
    return _build.bind(KERNEL, {"sddmm": [p, i, p, i, p, p, p, p] + [i] * 10 + [p]})["sddmm"]


def _launch(plan: Plan, dc: torch.Tensor, b: torch.Tensor, round_bf16: bool):
    m, k = plan.shape
    bm, bk = plan.blocksize
    n = dc.shape[1]
    dev = dc.device
    if min(m, k, n) == 0:  # no block or an empty sum: every block is 0
        return torch.zeros((plan.num_slots, bm, bk), dtype=dc.dtype, device=dev)
    out = torch.empty((plan.num_slots, bm, bk), dtype=dc.dtype, device=dev)
    splits = sddmm_splits(sddmm_tiles(plan), n, _sm_count(dev.index or 0))
    ws = (torch.empty((splits, plan.num_slots, bm, bk), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    rc = _kernel_fn()(
        dc.data_ptr(), _DTYPE_CODE[dc.dtype], b.data_ptr(), _DTYPE_CODE[b.dtype],
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        plan.index_tensor("block_cols", dev).data_ptr(),
        plan.index_tensor("nslots", dev).data_ptr(),
        m, k, n, bm, bk, plan.num_row_blocks, plan.ell_width, splits,
        int(round_bf16), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
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
