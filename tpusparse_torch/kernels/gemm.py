"""Dense GEMM kernel: C = op(A) @ op(B) for 2-D operands.

Counterpart of `tpusparse/kernels/gemm.py:31-159` (`_gemm_kernel` behind
`gemm_pallas`). The TPU kernel becomes the CUDA kernel `csrc/gemm.cu`,
which takes the transpose flags itself (row-major strides), so a
transposed operand is never copied. Its tile sizes are its own; the TPU
tile heuristics, the `gemm_block_*` config fields and `autotune_gemm`
(gemm.py:43-93, 175-295) tune the TPU's tiles and are not carried.

Precision tiers are those of the block SpMM executor (`tiled_spmm.py`):
'high'/'highest' fp32 FFMA, never TF32; 'default' rounds both operands to
bf16 and accumulates in fp32. C is written in the result type of A and B
unless `out_dtype` says otherwise.

A wrapper given CPU tensors runs `_gemm_plain`, the plain PyTorch version:
`torch.matmul` in fp32 with TF32 off. The same call is the yardstick
(`library_ms`) that `chip_smoke.py` times beside the kernel, so here the
plain version and the library call coincide. Given CUDA tensors the
wrapper launches the kernel or raises. It counts its launches
(`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusparse_torch.utils.config import fp32_matmul, resolve_precision

KERNEL = "gemm"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"gemm": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["gemm"] = 0


def gemm_kernel(
    a: torch.Tensor, b: torch.Tensor, *, transa: bool = False, transb: bool = False,
    out_dtype=None, precision: str | None = None,
) -> torch.Tensor:
    """op(a) @ op(b), op = transpose where the flag is set.

    a is stored (m, k), or (k, m) with transa; b is stored (k, n), or (n, k)
    with transb; both contiguous. Returns (m, n) in `out_dtype` (default:
    the result type of a and b), accumulated in fp32.
    """
    out_dtype = out_dtype or torch.result_type(a, b)
    m, n, k = _check(a, b, transa, transb, out_dtype)
    tier = resolve_precision(precision)
    if a.device.type == "cpu":
        return _gemm_plain(a, b, transa=transa, transb=transb, out_dtype=out_dtype,
                           precision=tier)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    c = _launch(a, b, m, n, k, transa, transb, out_dtype, round_bf16=tier == "default")
    _LAUNCHES["gemm"] += 1
    return c


def _check(a, b, transa, transb, out_dtype):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm is 2-D only, got {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape[::-1] if transa else a.shape
    k2, n = b.shape[::-1] if transb else b.shape
    if k != k2:
        raise ValueError(
            f"contraction mismatch: {tuple(a.shape)} (transa={transa}) @ "
            f"{tuple(b.shape)} (transb={transb})"
        )
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pass a transpose as a flag)")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype} not supported (float32, bfloat16)")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}: same device needed")
    return m, n, k


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/gemm.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    fn = _build.load(KERNEL).gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _launch(a, b, m, n, k, transa, transb, out_dtype, round_bf16: bool):
    if min(m, n) == 0:
        return torch.empty((m, n), dtype=out_dtype, device=a.device)
    if k == 0:  # an empty sum
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _kernel_fn()(
        a.data_ptr(), _DTYPE_CODE[a.dtype], b.data_ptr(), _DTYPE_CODE[b.dtype],
        c.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k, int(transa), int(transb),
        int(round_bf16), a.device.index or 0, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    return c


def _gemm_plain(
    a: torch.Tensor, b: torch.Tensor, *, transa: bool = False, transb: bool = False,
    out_dtype=None, precision: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch version, on the inputs' device: `torch.matmul` of the
    fp32 operands with TF32 off. The 'default' tier rounds both operands to
    bf16 first, as the kernel does."""
    out_dtype = out_dtype or torch.result_type(a, b)
    af, bf = a.float(), b.float()
    if resolve_precision(precision) == "default":
        af = af.to(torch.bfloat16).float()
        bf = bf.to(torch.bfloat16).float()
    if transa:
        af = af.transpose(0, 1)
    if transb:
        bf = bf.transpose(0, 1)
    with fp32_matmul():
        return torch.matmul(af, bf).to(out_dtype)
