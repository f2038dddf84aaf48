"""Dense GEMM kernel: C = op(A) @ op(B) for 2-D operands.

Counterpart of `tpusparse/kernels/gemm.py:31-159` (`_gemm_kernel` behind
`gemm_pallas`). The TPU kernel becomes the CUDA kernel `csrc/gemm.cu`, on
the H100's tensor cores (`wgmma`), which takes the transpose flags itself
(row-major strides), so a transposed operand is never copied. Its tile
sizes are its own; the TPU tile heuristics, the `gemm_block_*` config
fields and `autotune_gemm` (gemm.py:43-93, 175-295) tune the TPU's tiles
and are not carried.

Precision tiers, fp32-class and never plain TF32: 'high'/'highest' with an
fp32 operand run 3xTF32 (each value split into a tf32 high part and a tf32
remainder, three tf32 passes summed in fp32); bf16 operands run one bf16
pass in any tier (their products are exact in fp32); 'default' rounds
fp32 operands to bf16 and runs one bf16 pass. Sums are fp32. C is written
in the result type of A and B unless `out_dtype` says otherwise.

The int8 GEMM of the serving tier (`gemm.py:298-378`, `_gemm_s8_kernel`
behind `gemm_int8_pallas`) becomes `csrc/gemm_s8.cu` behind
`gemm_int8_kernel`: int8 (m, k) @ int8 (k, n) → exact int32, the caller
owning dequantization. Its TPU block-size knobs are not carried. The s8
tensor cores read both operands K-major, so the wrapper first makes B
K-major with `int8_kmajor_kernel` (`kernels/tiled_spmm.py`, counted as
'int8_kmajor'): each call launches one 'int8_kmajor' and one 'gemm_s8'.

A wrapper given CPU tensors runs the plain PyTorch version: `_gemm_plain`,
`torch.matmul` in fp32 with TF32 off; for int8 the card's composition with
plain parts (`_int8_kmajor_plain`, then `_gemm_s8_kmajor_plain`, the
product in float64, exact, cast to int32), whose result is
`_gemm_int8_plain`'s. For the float GEMM the same call is the yardstick
(`library_ms`) that `chip_smoke.py` times beside the kernel, so there the
plain version and the library call coincide. Given CUDA tensors the wrapper
launches the kernel or raises. It counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusparse_torch.kernels.tiled_spmm import int8_kmajor_kernel
from tpusparse_torch.utils.config import cdiv, fp32_matmul, resolve_precision

KERNEL = "gemm"
KERNEL_INT8 = "gemm_s8"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"gemm": 0, "gemm_s8": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


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


def gemm_int8_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for int8 a (m, k) and b (k, n), both contiguous, with exact
    int32 sums; returns (m, n) int32. The sums wrap past int32, that is for
    k beyond ~133,000 (127²·k > 2³¹), as on the TPU."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"gemm_int8_kernel needs int8 operands, got {a.dtype}/{b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes: {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}: same device needed")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    (m, k), n = a.shape, b.shape[1]
    if min(m, n) == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
    ldt = _s8_ldt(k)
    bt = int8_kmajor_kernel(b, ldt)  # the card's kernel, or on the CPU its plain version
    a_k = _rows_for_tma(a, ldt)
    if a.device.type == "cpu":
        return _gemm_s8_kmajor_plain(a_k, bt, k)
    return _gemm_s8_launch(a_k, bt, k)


def _s8_ldt(k: int) -> int:
    """The row length of B made K-major, and of A where it is copied: k
    rounded up to 128 bytes, so that each 128-byte chunk the kernel's TMA
    reads is one aligned 128-byte line."""
    return cdiv(k, 128) * 128


def _rows_for_tma(a: torch.Tensor, ldt: int) -> torch.Tensor:
    """A as the kernel's TMA reads it, rows a multiple of 16 bytes apart
    from a 16-byte-aligned base: a itself where k % 16 == 0 and its base is
    aligned, else a copy zero-padded to ldt columns."""
    k = a.shape[1]
    if k % 16 == 0 and a.data_ptr() % 16 == 0:
        return a
    padded = torch.zeros((a.shape[0], ldt), dtype=torch.int8, device=a.device)
    padded[:, :k] = a
    return padded


def _gemm_s8_launch(a_k: torch.Tensor, bt: torch.Tensor, k: int) -> torch.Tensor:
    """C (m, n) int32 = a_k[:, :k] @ bt[:, :k]ᵀ by csrc/gemm_s8.cu: a_k (m,
    lda) from `_rows_for_tma`, bt (n, ldt) from `int8_kmajor_kernel`. One
    launch, counted."""
    m, n = a_k.shape[0], bt.shape[0]
    c = torch.empty((m, n), dtype=torch.int32, device=a_k.device)
    rc = _int8_fns()["gemm_s8"](a_k.data_ptr(), bt.data_ptr(), c.data_ptr(), m, n, k,
                                a_k.shape[1], bt.shape[1], a_k.device.index or 0,
                                torch.cuda.current_stream(a_k.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_INT8} launch failed: CUDA error {rc}")
    _LAUNCHES["gemm_s8"] += 1
    return c


def _s8_tile_n(m: int, n: int, device: int = 0) -> int:
    """The width of C's tiles (128 or 256) that csrc/gemm_s8.cu takes for an
    (m, n) C on the card `device`."""
    bn = _int8_fns()["gemm_s8_tile_n"](m, n, device)
    if bn < 0:
        raise RuntimeError(f"{KERNEL_INT8} tile width: CUDA error {-bn}")
    return bn


@functools.cache
def _int8_fns():
    """The C entry points of csrc/gemm_s8.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # gemm_s8: a, bt, c, m, n, k, lda, ldt, device, stream; gemm_s8_tile_n: m, n, device
    return _build.bind(KERNEL_INT8, {"gemm_s8": [p] * 3 + [i] * 6 + [p],
                                     "gemm_s8_tile_n": [i] * 3})


def _gemm_s8_kmajor_plain(a_k: torch.Tensor, bt: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of `_gemm_s8_launch`, on the inputs' device:
    a_k[:, :k] @ bt[:, :k]ᵀ in float64 (exact while |sum| < 2⁵³), cast to
    int32."""
    return torch.matmul(a_k[:, :k].double(), bt[:, :k].double().t()).to(torch.int32)


def _gemm_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on the inputs' device: the product in float64
    (exact while |sum| < 2⁵³; the card's `torch.matmul` takes neither int8
    nor int32), cast to int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)
