"""Dense GEMM kernel: C = op(A) @ op(B) for 2-D operands.

Counterpart of `tpusparse/kernels/gemm.py:31-159` (`_gemm_kernel` behind
`gemm_pallas`). The TPU kernel becomes the CUDA kernel `csrc/gemm.cu`, on
the H100's tensor cores (`wgmma`), which takes the transpose flags itself
(row-major strides), so a transposed operand is never copied.

Tiles. A thread block owns a (bm, bn) tile of C and walks k in chunks of
bk: bm 64 or 128 (one or two warpgroups), bn 128, and bk the tier's chunk
of 128 bytes (32 in 3xTF32, 64 in one bf16 pass; `gemm_tiles`). The
(bm, bn, bk) tile is resolved as JAX's (gemm.py:43-93), in this order:
explicit `block_m`/`block_n`/`block_k` (a tile the kernel lacks raises
ValueError naming the ones it has); the tile `autotune_gemm` saved for
JAX's key `f"{m}x{k}x{n}x{dtype}"` (`_tile_key`) in the calibration
file's 'gemm_tiles' section, stamped with the card's name and read once
into `_TILE_CACHE`, where it names a tile of this call's tier; else the
kernel's own choice (csrc/gemm.cu `default_block_m`: 128 rows where the
grid of 128-row tiles has two blocks an SM, else 64). Both heights sum
every element in the same order, so the tile changes the time and not
the bits. JAX's `gemm_block_*` config fields tune the TPU's tiles and are
not carried.

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
from tpusparse_torch.utils.config import cdiv, dtype_name, fp32_matmul, resolve_precision

KERNEL = "gemm"
KERNEL_INT8 = "gemm_s8"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"gemm": 0, "gemm_s8": 0}
BLOCK_MS = (64, 128)  # the heights of C's tiles (csrc/gemm.cu: one or two warpgroups)
BLOCK_N = 128         # the width of C's tiles (one wgmma's n)
# autotuned tiles by `_tile_key`, read once from the calibration file
_TILE_CACHE: dict = {}
_TILE_CACHE_LOADED = False


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def gemm_kernel(
    a: torch.Tensor, b: torch.Tensor, *, transa: bool = False, transb: bool = False,
    out_dtype=None, precision: str | None = None, block_m: int | None = None,
    block_n: int | None = None, block_k: int | None = None,
) -> torch.Tensor:
    """op(a) @ op(b), op = transpose where the flag is set.

    a is stored (m, k), or (k, m) with transa; b is stored (k, n), or (n, k)
    with transb; both contiguous. Returns (m, n) in `out_dtype` (default:
    the result type of a and b), accumulated in fp32. `block_m`/`block_n`/
    `block_k` pick the kernel's tile (module docstring); the plain version
    on the CPU has none, but a tile the kernel lacks raises there too.
    """
    out_dtype = out_dtype or torch.result_type(a, b)
    m, n, k = _check(a, b, transa, transb, out_dtype)
    tier = resolve_precision(precision)
    tile = resolve_tile(m, k, n, a.dtype, b.dtype, tier, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return _gemm_plain(a, b, transa=transa, transb=transb, out_dtype=out_dtype,
                           precision=tier)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    c = _launch(a, b, m, n, k, transa, transb, out_dtype, round_bf16=tier == "default",
                block_m=tile[0] if tile else 0)
    _LAUNCHES["gemm"] += 1
    return c


def _tile_key(m: int, k: int, n: int, dtype_name: str) -> str:
    """JAX's key of a saved GEMM tile (tpusparse/kernels/gemm.py:178)."""
    return f"{m}x{k}x{n}x{dtype_name}"


def _chunk_k(a_dtype, b_dtype, tier: str) -> int:
    """The k a staged chunk holds: 128 bytes of the tier's staged values, 32
    fp32 in 3xTF32, 64 bf16 in one bf16 pass (bf16 operand pairs and
    'default')."""
    return 64 if tier == "default" or a_dtype == b_dtype == torch.bfloat16 else 32


def gemm_tiles(a_dtype=torch.float32, b_dtype=None, precision: str | None = None) -> list:
    """The (bm, bn, bk) tiles the kernel has for these operand types and
    tier: each height by BLOCK_N, bk the tier's chunk (`_chunk_k`)."""
    bk = _chunk_k(a_dtype, b_dtype or a_dtype, resolve_precision(precision))
    return [(bm, BLOCK_N, bk) for bm in BLOCK_MS]


def _saved_tiles() -> dict:
    """The 'gemm_tiles' section of the calibration file for this card, read
    once into `_TILE_CACHE` (JAX's `_tuned_tile`)."""
    global _TILE_CACHE_LOADED
    if not _TILE_CACHE_LOADED:
        from tpusparse_torch.utils.calibrate import load_gemm_tiles

        _TILE_CACHE.update(load_gemm_tiles())
        _TILE_CACHE_LOADED = True
    return _TILE_CACHE


def resolve_tile(m: int, k: int, n: int, a_dtype, b_dtype, precision, block_m=None,
                 block_n=None, block_k=None):
    """The (bm, bn, bk) tile a call launches, or None for the kernel's own
    choice: explicit arguments (the missing ones from the kernel's default,
    bm then its own; a tile it lacks raises ValueError), else the saved tile
    for JAX's key where it is a tile of this tier, else None. Every
    `gemm_kernel` call takes this path, so the saved-tile branch is kept to
    a dict lookup and a few compares."""
    if block_m is None and block_n is None and block_k is None:
        saved = _saved_tiles()
        hit = saved.get(_tile_key(m, k, n, dtype_name(a_dtype))) if saved else None
        if hit is None:
            return None
        bm, bn, bk = hit
        ok = (bm in BLOCK_MS and bn == BLOCK_N
              and bk == _chunk_k(a_dtype, b_dtype, resolve_precision(precision)))
        return (bm, bn, bk) if ok else None
    tiles = gemm_tiles(a_dtype, b_dtype, precision)
    tile = (block_m, block_n or BLOCK_N, block_k or tiles[0][2])
    if not any(tile[1:] == t[1:] and tile[0] in (None, t[0]) for t in tiles):
        raise ValueError(f"gemm has no tile {tile} for {dtype_name(a_dtype)} x "
                         f"{dtype_name(b_dtype)} at '{resolve_precision(precision)}'; "
                         f"its tiles are {tiles}")
    return tile if block_m is not None else None


def autotune_gemm(m: int, k: int, n: int, dtype=torch.bfloat16, *, repeats: int = 2,
                  save: bool = True, verbose: bool = True):
    """Time each of the kernel's tiles (`gemm_tiles`, at the config's tier)
    for an (m, k) @ (k, n) product of `dtype` on the card and keep the
    fastest for JAX's key (`_tile_key`); with `save`, also in the
    calibration file's 'gemm_tiles' section, stamped with the card's name.
    Later `gemm_kernel` calls at this exact shape and type take it.
    Returns (tile, tflops). Raises without a card, as JAX's raises on the
    CPU.

    Each tile is timed by `utils.timing.device_time_per_iter` on a chain
    that feeds a's next value through a scalar of C (JAX's), the median of
    `repeats`; the two heights give the same bits, so the choice moves only
    time."""
    import numpy as np

    from tpusparse_torch.utils.timing import device_time_per_iter

    if not torch.cuda.is_available():
        raise RuntimeError("autotune_gemm runs on the CUDA card; no CUDA device is available")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to("cuda", dtype)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to("cuda", dtype)
    flops = 2.0 * m * n * k
    best, best_t = None, float("inf")
    for tile in gemm_tiles(dtype, dtype):
        def chained(x, tile=tile):
            y = gemm_kernel(x, b, block_m=tile[0], block_n=tile[1], block_k=tile[2])
            return x * (1.0 + 0.0 * y.abs().max().to(x.dtype))

        t = float(np.median([device_time_per_iter(chained, a, iters_lo=2, iters_hi=6)
                             for _ in range(repeats)]))
        if verbose:
            print(f"[autotune] {tile}: {flops / t / 1e12:.1f} TFLOP/s", flush=True)
        if t < best_t:
            best, best_t = tile, t
    key = _tile_key(m, k, n, dtype_name(dtype))
    _saved_tiles()[key] = list(best)
    if save:
        from tpusparse_torch.utils.calibrate import save_gemm_tile

        save_gemm_tile(key, best)
    if verbose:
        print(f"[autotune] best {best} = {flops / best_t / 1e12:.1f} TFLOP/s", flush=True)
    return best, flops / best_t / 1e12


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
def _kernel_fns() -> dict:
    """The C entry points of csrc/gemm.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # gemm: a, a_dtype, b, b_dtype, c, c_dtype, m, n, k, transa, transb,
    # round_bf16, block_m, device, stream; gemm_default_block_m: m, n
    return _build.bind(KERNEL, {"gemm": [p, i, p, i, p, i] + [i] * 8 + [p],
                                "gemm_default_block_m": [i, i]})


def default_block_m(m: int, n: int) -> int:
    """The height of C's tiles that csrc/gemm.cu picks for an (m, n) C when
    none is asked for (builds the source: the card's machine only)."""
    return _kernel_fns()["gemm_default_block_m"](m, n)


def _launch(a, b, m, n, k, transa, transb, out_dtype, round_bf16: bool, block_m: int = 0):
    if min(m, n) == 0:
        return torch.empty((m, n), dtype=out_dtype, device=a.device)
    if k == 0:  # an empty sum
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _kernel_fns()["gemm"](
        a.data_ptr(), _DTYPE_CODE[a.dtype], b.data_ptr(), _DTYPE_CODE[b.dtype],
        c.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k, int(transa), int(transb),
        int(round_bf16), block_m, a.device.index or 0, stream,
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
