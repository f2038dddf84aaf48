"""Block-ELL SpMM executor: C = A @ B with A given by (Plan, packed values).

Counterpart of `tpusparse/kernels/tiled_spmm.py:43-403`. The two TPU
kernels there, `_executor_kernel` (behind `tiled_spmm_pallas`) and
`_resident_kernel` (behind `resident_spmm_pallas`), become one CUDA kernel,
`csrc/block_ell_spmm.cu`. Both entry points below launch it, so they give
bitwise-equal output, as the JAX pair does (tiled_spmm.py:286-288).

Precision contract (the port of `tpusparse/kernels/mxu.py:28-103`):
'high' and 'highest' are fp32 FFMA, never TF32; 'default' rounds both
operands to bf16 (round to nearest even) and accumulates in fp32. The
3-pass bf16 split of the TPU is a workaround for its matrix unit and is
not ported.

The int8 executors of the serving tier (`tiled_spmm.py:643-1019`,
`_resident_int8_kernel` behind `resident_spmm_int8_pallas` and
`_tiled_int8_kernel` behind `tiled_spmm_int8_pallas`) become one CUDA
kernel too, `csrc/block_ell_spmm_int8.cu`, behind
`resident_spmm_int8_kernel` and `tiled_spmm_int8_kernel`: bitwise equal, as
the JAX pair is. Their contract: C = (Σ_l s_a[l] · float(Qa[l] @ Qb[col_l]))
∘ t, int8 operands, an exact int32 product per slot, the fp32 sum in slot
order. The TPU's VMEM fit check (`resident_int8_vmem_bytes`) has no
counterpart, as for the float executor.

A wrapper given CPU tensors runs `_block_exec_plain` (or
`_block_exec_int8_plain`), the plain PyTorch version of the same function.
Given CUDA tensors it launches the kernel or raises. Each entry point counts
its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusparse_torch.plan import Plan
from tpusparse_torch.utils.config import fp32_matmul, resolve_precision

KERNEL = "block_ell_spmm"
KERNEL_INT8 = "block_ell_spmm_int8"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"tiled_spmm": 0, "resident_spmm": 0, "tiled_spmm_int8": 0,
             "resident_spmm_int8": 0}


def launch_counts() -> dict:
    """Kernel launches per entry point since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def tiled_spmm_kernel(
    plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """C = A @ B, A described by (plan, block_vals).

    block_vals: (plan.num_slots, bm, bk) from plan.pack_values(csr.data).
    b: (k, n) dense. Returns (m, n) in `out_dtype` (default: the result
    type of block_vals and b). The TPU kernel's `block_n` tile knob is not
    carried: the CUDA kernel tiles n itself.
    """
    return _run("tiled_spmm", plan, block_vals, b, out_dtype, precision)


def resident_spmm_kernel(
    plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Same contract and same kernel as `tiled_spmm_kernel` (the TPU's
    resident-B-panel variant; its VMEM fit check has no CUDA counterpart)."""
    return _run("resident_spmm", plan, block_vals, b, out_dtype, precision)


def _check(plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, out_dtype):
    m, k = plan.shape
    bm, bk = plan.blocksize
    if b.ndim != 2 or b.shape[0] != k:
        raise ValueError(f"b shape {tuple(b.shape)} incompatible with plan k={k}")
    if tuple(block_vals.shape) != (plan.num_slots, bm, bk):
        raise ValueError(
            f"block_vals shape {tuple(block_vals.shape)} != plan's "
            f"{(plan.num_slots, bm, bk)}"
        )
    for name, t in (("block_vals", block_vals), ("b", b)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype} not supported (float32, bfloat16)")
    if block_vals.device != b.device:
        raise ValueError(
            f"block_vals on {block_vals.device} and b on {b.device}: same device needed"
        )


def _run(entry, plan, block_vals, b, out_dtype, precision):
    out_dtype = out_dtype or torch.result_type(block_vals, b)
    _check(plan, block_vals, b, out_dtype)
    tier = resolve_precision(precision)
    if b.device.type == "cpu":
        return _block_exec_plain(
            plan, block_vals, b, out_dtype=out_dtype, precision=tier
        )
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    c = _launch(plan, block_vals, b, out_dtype, round_bf16=tier == "default")
    _LAUNCHES[entry] += 1
    return c


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/block_ell_spmm.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    fn = _build.load(KERNEL).block_ell_spmm
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch(plan, block_vals, b, out_dtype, round_bf16: bool) -> torch.Tensor:
    m, k = plan.shape
    bm, bk = plan.blocksize
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    fn = _kernel_fn()
    cols = plan.index_tensor("block_cols", b.device)
    nslots = plan.index_tensor("nslots", b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = fn(
        block_vals.data_ptr(), _DTYPE_CODE[block_vals.dtype],
        b.data_ptr(), _DTYPE_CODE[b.dtype],
        c.data_ptr(), _DTYPE_CODE[out_dtype],
        cols.data_ptr(), nslots.data_ptr(),
        m, k, n, bm, bk, plan.num_row_blocks, plan.ell_width,
        int(round_bf16), b.device.index or 0, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    return c


def _block_exec_plain(
    plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the executor, on the inputs' device.

    Zero-pads B to (nbc*bk, n), gathers the (nbr, L, bk, n) tiles at
    block_cols, masks the slots at or past nslots and contracts in fp32,
    with TF32 off so that on the card it is a true fp32 yardstick. The
    'default' tier rounds both operands to bf16 first, as the kernel does.
    """
    m, k = plan.shape
    bm, bk = plan.blocksize
    nbr, nbc, L = plan.num_row_blocks, plan.num_col_blocks, plan.ell_width
    n = b.shape[1]
    dev = b.device
    out_dtype = out_dtype or torch.result_type(block_vals, b)
    vf, bf = block_vals.float(), b.float()
    if resolve_precision(precision) == "default":
        vf = vf.to(torch.bfloat16).float()
        bf = bf.to(torch.bfloat16).float()
    bp = torch.zeros((nbc * bk, n), dtype=torch.float32, device=dev)
    bp[:k] = bf
    cols = plan.index_tensor("block_cols", dev).reshape(nbr, L).long()
    tiles = bp.reshape(nbc, bk, n)[cols]  # (nbr, L, bk, n)
    valid = plan.slot_valid_mask(dev).bool()[..., None, None]
    vals4 = torch.where(valid, vf.reshape(nbr, L, bm, bk), 0.0)
    with fp32_matmul():
        out = torch.einsum("ilmk,ilkn->imn", vals4, tiles)
    return out.reshape(nbr * bm, n)[:m].to(out_dtype)


# ----------------------------------------------------------------------------
# int8 executor (the serving tier)
# ----------------------------------------------------------------------------


def resident_spmm_int8_kernel(
    plan: Plan, qvals: torch.Tensor, scales: torch.Tensor, b_q: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """C ≈ A @ B from quantized operands (`quant.py` packs them).

    qvals: (plan.num_slots, bm, bk) int8; scales: (plan.num_slots,) fp32,
    one per ELL slot (0 on pad slots); b_q: (k, n) int8; t: (n,) fp32
    per-column scales of B. Returns (m, n) fp32. The TPU kernel's `block_n`
    and `unroll` knobs are not carried: the CUDA kernel tiles n itself.
    """
    return _run_int8("resident_spmm_int8", plan, qvals, scales, b_q, t)


def tiled_spmm_int8_kernel(
    plan: Plan, qvals: torch.Tensor, scales: torch.Tensor, b_q: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Same contract and same kernel as `resident_spmm_int8_kernel` (the
    TPU's DMA-ring form, for any k), so the two are bitwise equal."""
    return _run_int8("tiled_spmm_int8", plan, qvals, scales, b_q, t)


def _check_int8(plan: Plan, qvals, scales, b_q, t) -> None:
    m, k = plan.shape
    bm, bk = plan.blocksize
    if b_q.dtype != torch.int8 or qvals.dtype != torch.int8:
        raise TypeError(
            f"int8 executor needs int8 operands, got {qvals.dtype}/{b_q.dtype}"
        )
    if b_q.ndim != 2 or b_q.shape[0] != k:
        raise ValueError(f"b shape {tuple(b_q.shape)} incompatible with plan k={k}")
    if tuple(qvals.shape) != (plan.num_slots, bm, bk):
        raise ValueError(
            f"qvals shape {tuple(qvals.shape)} != plan's {(plan.num_slots, bm, bk)}"
        )
    for name, s, size in (("scales", scales, plan.num_slots), ("t", t, b_q.shape[1])):
        if s.dtype != torch.float32 or tuple(s.shape) != (size,):
            raise TypeError(f"{name} must be float32 of shape ({size},), got "
                            f"{s.dtype} {tuple(s.shape)}")
    for name, x in (("qvals", qvals), ("scales", scales), ("b_q", b_q), ("t", t)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != b_q.device:
            raise ValueError(f"{name} on {x.device} and b_q on {b_q.device}: same device needed")


def _run_int8(entry, plan, qvals, scales, b_q, t):
    _check_int8(plan, qvals, scales, b_q, t)
    if b_q.device.type == "cpu":
        return _block_exec_int8_plain(plan, qvals, scales, b_q, t)
    if b_q.device.type != "cuda":
        raise ValueError(f"unsupported device {b_q.device}")
    m, k = plan.shape
    bm, bk = plan.blocksize
    n = b_q.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=b_q.device)
    if m == 0 or n == 0:
        return c
    cols = plan.index_tensor("block_cols", b_q.device)
    nslots = plan.index_tensor("nslots", b_q.device)
    rc = _int8_kernel_fn()(
        qvals.data_ptr(), scales.data_ptr(), b_q.data_ptr(), t.data_ptr(), c.data_ptr(),
        cols.data_ptr(), nslots.data_ptr(), m, k, n, bm, bk, plan.num_row_blocks,
        plan.ell_width, b_q.device.index or 0, torch.cuda.current_stream(b_q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL_INT8} launch failed: CUDA error {rc}")
    _LAUNCHES[entry] += 1
    return c


@functools.cache
def _int8_kernel_fn():
    """The C entry point of csrc/block_ell_spmm_int8.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # qvals, scales, b_q, t, c, block_cols, nslots, m, k, n, bm, bk, nbr, L,
    # device, stream
    return _build.bind(KERNEL_INT8, {"block_ell_spmm_int8": [p] * 7 + [i] * 8 + [p]})[
        "block_ell_spmm_int8"]


def _block_exec_int8_plain(
    plan: Plan, qvals: torch.Tensor, scales: torch.Tensor, b_q: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the int8 executor, on the inputs' device.

    Per ELL slot, the int8 product in float64 (exact below 2⁵³; neither
    int8 nor int32 products run on the card's `torch.matmul`), cast to int32
    and then to fp32; then acc = acc + s·prod in fp32, slot by slot, each
    multiply and add rounded on its own as the kernel rounds them, pad slots
    skipped; C = acc ∘ t.
    """
    m, k = plan.shape
    bm, bk = plan.blocksize
    nbr, nbc, L = plan.num_row_blocks, plan.num_col_blocks, plan.ell_width
    n = b_q.shape[1]
    dev = b_q.device
    bp = torch.zeros((nbc * bk, n), dtype=torch.float64, device=dev)
    bp[:k] = b_q.double()
    tiles = bp.reshape(nbc, bk, n)
    cols = plan.index_tensor("block_cols", dev).reshape(nbr, L).long()
    valid = plan.slot_valid_mask(dev).bool()
    q4 = qvals.reshape(nbr, L, bm, bk)
    s2 = scales.reshape(nbr, L)
    acc = torch.zeros((nbr, bm, n), dtype=torch.float32, device=dev)
    for l in range(L):
        prod = torch.bmm(q4[:, l].double(), tiles[cols[:, l]]).to(torch.int32).float()
        acc = torch.where(valid[:, l, None, None], acc + s2[:, l, None, None] * prod, acc)
    return acc.reshape(nbr * bm, n)[:m] * t
