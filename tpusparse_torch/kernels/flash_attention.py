"""Fused attention: forward, dq and dk/dv kernels, and their autograd.

Counterpart of `tpusparse/kernels/flash_attention.py:53-775`: the TPU
kernels `_flash_kernel` (l.53), `_flash_dq_kernel` (l.495) and
`_flash_dkv_kernel` (l.538) become the three CUDA kernels of
`csrc/flash_attention.cu`; `flash_attention` (l.157),
`flash_attention_bwd` (l.587) and `flash_attention_diff` (l.763) keep
their signatures, the last as a `torch.autograd.Function` that saves
(q, k, v, o, lse) and runs its backward on the dq and dk/dv kernels.

Contracts carried over (l.207-308, l.618-734):
  - operands (..., s, d), all of one shape and type (fp32 or bf16); the
    leading dims are flattened to bh. o has q's type, lse = m + log(l) is
    fp32 of shape (..., s);
  - `sm_scale` defaults to 1/sqrt(d); q is pre-scaled by it in q's type
    before any product, dq gets it in its epilogue, dk uses the pre-scaled q;
  - `delta = sum_d do * o` is computed outside the kernels, in the result
    type of do and o, then fp32;
  - causal masking on global positions, `kv_offset + key <= q_offset +
    query`; masked scores are -1e30 and whole tiles above the diagonal are
    skipped; keys at or past s are masked, as are padded q rows in the
    backward;
  - tiers: 'high' and 'highest' are fp32-class, never one TF32 pass:
    3xTF32 on the tensor cores.
    'default' on fp32 inputs stores the pre-scaled q, k, v (and do) as bf16
    and rounds p (forward) and dS (dq, dk) to bf16 before their products,
    with fp32 sums (on bf16 tensor cores where 3xTF32 would run); bf16
    inputs do so in every tier (the TPU's non-3-pass tiers cast p and dS to
    the operands' type).
  - d is taken as it is, any size (the TPU wrapper padded it to a multiple
    of 128). Above 128 the forward and the backward run teams of warps
    that split d into slices (the forward's 128 wide, the backward's 64),
    above 512 in 512-wide output chunks.

One deliberate difference: a row that sees no key (reachable only through
the offsets, e.g. causal with kv_offset > q_offset) gets o = 0,
lse = -1e30 and no gradient. The TPU kernel gives such a row the mean of
v over the tiles it visits, since exp(-1e30 - (-1e30)) = 1, which depends
on its tile size (ROADMAP section 3).

Tiles. The forward at d <= 128 runs q-tiles of 128 rows (eight warps, the
default) or 64 (four) by k-tiles of 64 keys: `FLASH_TILES`, as (block_q,
block_k). Every row is summed by one warp in the same order in both, so
the tile moves the time and not the bits. `flash_attention` (and so
`flash_attention_diff`'s forward) resolves it as JAX's does
(flash_attention.py:327-352): `block_q`/`block_k` where they name one of
`FLASH_TILES` (a missing `block_k` is 64), else the tile `autotune_flash`
saved for JAX's key (`_flash_tile_key`: bh, s, d, dtype, causal, tier) in
the calibration file's 'flash_tiles' section for this card, read once into
`_FLASH_TILE_CACHE`, else (128, 64). Other values are the TPU's tile knobs
and are accepted and ignored, as JAX's callers pass them. The backward
kernels and d > 128 keep tiles of their own (the forward's teams at d >
128: 64 rows by 32 keys up to d 256, 32 by 16 above; the backward's 128-row
A tiles and W-row streamed tiles, and its teams at d > 128: 32 rows by 32
keys (dq) or 16 queries (dk/dv) up to d 256, 16 by 16 above): JAX's
backward shares the forward's key (flash_attention.py:602), the port's
does not.

The serving tier's attention over an int8 K/V cache (l.1415-1591):
`quantize_kv` and `flash_attention_q8` keep their signatures, and the TPU
kernel `_flash_q8_kernel` (l.1434) becomes `csrc/flash_attention_q8.cu`
behind `flash_q8_kernel`. Forward only. Its products are at the 'default'
tier, as `Precision.DEFAULT` runs on the TPU: q and p rounded to bf16, int8
K and V exact, fp32 sums. The K scale folds into the score scale after the
product, the V scale into the epilogue. A row that sees no key gets o = 0
here too; the TPU kernel gives 0 where it skips every tile of the row and
the mean of vs·v over a visited tile whose keys are all masked for it
(ROADMAP section 3).

A wrapper given CPU tensors runs the plain PyTorch version of its kernel
(`_flash_fwd_plain`, `_flash_dq_plain`, `_flash_dkv_plain`,
`_flash_q8_plain`: a dense masked softmax in fp32 with TF32 off, rounded as
the tier says). Given CUDA tensors it launches the kernel or raises. It
counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpusparse_torch.utils.config import dtype_name, fp32_matmul, resolve_precision

KERNEL = "flash_attention"
KERNEL_Q8 = "flash_attention_q8"
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_q8": 0}
FLASH_TILES = ((128, 64), (64, 64))  # the forward's (block_q, block_k) at d <= 128, default first
# autotuned forward tiles by `_flash_tile_key`, read once from the calibration file
_FLASH_TILE_CACHE: dict = {}
_FLASH_TILE_LOADED = False


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ----------------------------------------------------------------------------
# Checks and the tier
# ----------------------------------------------------------------------------


def _rounds(dtype: torch.dtype, precision: str | None) -> bool:
    """Whether operands, p and dS are rounded to bf16: the 'default' tier,
    or bf16 inputs in any tier."""
    return resolve_precision(precision) == "default" or dtype == torch.bfloat16


def _scale_in(dtype: torch.dtype, sm_scale: float) -> float:
    """sm_scale rounded to `dtype`, the factor q is pre-scaled by."""
    return torch.tensor(sm_scale, dtype=dtype).item()


def _check_qkv(q, k, v) -> None:
    if q.ndim < 2:
        raise ValueError(f"need (..., seq, head_dim), got {tuple(q.shape)}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )


def _check_kernel_args(tensors: dict, stats: dict) -> None:
    """3-D (bh, s, d) operands of one type and shape, fp32 (bh, s) stats,
    all contiguous on one device."""
    first = next(iter(tensors.values()))
    if first.ndim != 3:
        raise ValueError(f"kernel operands are (bh, s, d), got {tuple(first.shape)}")
    _check_qkv(*list(tensors.values())[:3])
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
        if t.dtype != first.dtype or t.shape != first.shape:
            raise TypeError(
                f"{name} is {t.dtype} {tuple(t.shape)}, q is {first.dtype} "
                f"{tuple(first.shape)}: one type and shape needed"
            )
    for name, t in stats.items():
        if t.dtype != torch.float32 or t.shape != first.shape[:2]:
            raise TypeError(f"{name} must be float32 of shape {tuple(first.shape[:2])}")
    for name, t in {**tensors, **stats}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device} and q on {first.device}: same device needed")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")


# ----------------------------------------------------------------------------
# Kernel wrappers on (bh, s, d) operands
# ----------------------------------------------------------------------------


def flash_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float,
    causal: bool = False, q_offset: int = 0, kv_offset: int = 0,
    precision: str | None = None, block_q: int = 0,
):
    """(o, lse) of softmax(q kᵀ sm_scale) v for contiguous (bh, s, d)
    operands: o in q's type, lse fp32 (bh, s). `block_q`: the q-tile's rows
    at d <= 128, 128 or 64 (0: 128); d > 128 takes the wide kernel's own."""
    if block_q not in (0,) + tuple(bq for bq, _ in FLASH_TILES):
        raise ValueError(f"flash_fwd has q-tiles of {[bq for bq, _ in FLASH_TILES]} rows, "
                         f"not {block_q}")
    _check_kernel_args({"q": q, "k": k, "v": v}, {})
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=int(q_offset),
              kv_offset=int(kv_offset), precision=precision)
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, **kw)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    rc = _kernel_fns()["flash_fwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], bh, s, d, _scale_in(q.dtype, sm_scale), int(causal),
        kw["q_offset"], kw["kv_offset"], int(_rounds(q.dtype, precision)), block_q,
        q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "flash_fwd")
    _LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_dq_kernel(
    q, k, v, do, lse, delta, *, sm_scale: float, causal: bool = False,
    q_offset: int = 0, kv_offset: int = 0, precision: str | None = None,
) -> torch.Tensor:
    """dq for contiguous (bh, s, d) q, k, v, do and fp32 (bh, s) lse, delta."""
    _check_kernel_args({"q": q, "k": k, "v": v, "do": do}, {"lse": lse, "delta": delta})
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=int(q_offset),
              kv_offset=int(kv_offset), precision=precision)
    if q.device.type == "cpu":
        return _flash_dq_plain(q, k, v, do, lse, delta, **kw)
    bh, s, d = q.shape
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    rc = _kernel_fns()["flash_dq"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype], bh, s, d,
        _scale_in(q.dtype, sm_scale), float(sm_scale), int(causal), kw["q_offset"],
        kw["kv_offset"], int(_rounds(q.dtype, precision)), q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "flash_dq")
    _LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv_kernel(
    q, k, v, do, lse, delta, *, sm_scale: float, causal: bool = False,
    q_offset: int = 0, kv_offset: int = 0, precision: str | None = None,
):
    """(dk, dv) for contiguous (bh, s, d) q, k, v, do and fp32 (bh, s) lse,
    delta."""
    _check_kernel_args({"q": q, "k": k, "v": v, "do": do}, {"lse": lse, "delta": delta})
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=int(q_offset),
              kv_offset=int(kv_offset), precision=precision)
    if q.device.type == "cpu":
        return _flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    bh, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    rc = _kernel_fns()["flash_dkv"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], bh, s, d,
        _scale_in(q.dtype, sm_scale), int(causal), kw["q_offset"], kw["kv_offset"],
        int(_rounds(q.dtype, precision)), q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "flash_dkv")
    _LAUNCHES["flash_dkv"] += 1
    return dk, dv


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


@functools.cache
def _kernel_fns() -> dict:
    """The C entry points of csrc/flash_attention.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers..., dtype, bh, s, d, scale_q, [sm_scale,] causal, q_off,
    # kv_off, round_bf16, [block_q,] device, stream
    return _build.bind(KERNEL, {
        "flash_fwd": [p] * 5 + [i, i, i, i, f, i, i, i, i, i, i, p],
        "flash_dq": [p] * 7 + [i, i, i, i, f, f, i, i, i, i, i, p],
        "flash_dkv": [p] * 8 + [i, i, i, i, f, i, i, i, i, i, p],
    })


# ----------------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------------


def _tier(x: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if round_bf16 else x


def _staged(q, k, v, sm_scale, round_bf16):
    """fp32 copies of the operands as the kernels read them: q pre-scaled in
    its own type, then all three rounded by the tier."""
    qs = (q.float() * _scale_in(q.dtype, sm_scale)).to(q.dtype).float()
    return _tier(qs, round_bf16), _tier(k.float(), round_bf16), _tier(v.float(), round_bf16)


def _visible(s: int, causal: bool, q_offset: int, kv_offset: int, device) -> torch.Tensor:
    """(s, s) bool: which key each query row sees (keys past s are not there)."""
    if not causal:
        return torch.ones((s, s), dtype=torch.bool, device=device)
    pos = torch.arange(s, device=device)
    return kv_offset + pos[None, :] <= q_offset + pos[:, None]


def _flash_fwd_plain(
    q, k, v, *, sm_scale: float, causal: bool = False, q_offset: int = 0,
    kv_offset: int = 0, precision: str | None = None,
):
    """Plain version of the forward, on the inputs' device: a dense masked
    softmax over the whole row (one tile), p rounded as the tier says."""
    round_bf16 = _rounds(q.dtype, precision)
    qf, kf, vf = _staged(q, k, v, sm_scale, round_bf16)
    vis = _visible(q.shape[-2], causal, q_offset, kv_offset, q.device)
    with fp32_matmul():
        sc = torch.where(vis, qf @ kf.transpose(-1, -2), NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(vis, torch.exp(sc - m), 0.0)
        l = p.sum(-1, keepdim=True)
        o = (_tier(p, round_bf16) @ vf) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(l), NEG_INF)[..., 0]
    return o.to(q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, delta, *, sm_scale, causal, q_offset, kv_offset,
                  round_bf16):
    """(staged q, staged k, staged do, P, dS) of the backward, in fp32."""
    qf, kf, vf = _staged(q, k, v, sm_scale, round_bf16)
    dof = _tier(do.float(), round_bf16)
    vis = _visible(q.shape[-2], causal, q_offset, kv_offset, q.device)
    with fp32_matmul():
        p = torch.where(vis, torch.exp(qf @ kf.transpose(-1, -2) - lse[..., None]), 0.0)
        ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    return qf, kf, dof, p, ds


def _flash_dq_plain(
    q, k, v, do, lse, delta, *, sm_scale: float, causal: bool = False,
    q_offset: int = 0, kv_offset: int = 0, precision: str | None = None,
):
    """Plain version of the dq kernel: sm_scale · round(dS) · k."""
    round_bf16 = _rounds(q.dtype, precision)
    _, kf, _, _, ds = _probs_and_ds(
        q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal,
        q_offset=q_offset, kv_offset=kv_offset, round_bf16=round_bf16)
    with fp32_matmul():
        return ((_tier(ds, round_bf16) @ kf) * sm_scale).to(q.dtype)


def _flash_dkv_plain(
    q, k, v, do, lse, delta, *, sm_scale: float, causal: bool = False,
    q_offset: int = 0, kv_offset: int = 0, precision: str | None = None,
):
    """Plain version of the dk/dv kernel: dv = round(P)ᵀ·do,
    dk = round(dS)ᵀ·(scaled q)."""
    round_bf16 = _rounds(q.dtype, precision)
    qf, _, dof, p, ds = _probs_and_ds(
        q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal,
        q_offset=q_offset, kv_offset=kv_offset, round_bf16=round_bf16)
    with fp32_matmul():
        dv = _tier(p, round_bf16).transpose(-1, -2) @ dof
        dk = _tier(ds, round_bf16).transpose(-1, -2) @ qf
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------------
# Public functions, with the JAX signatures
# ----------------------------------------------------------------------------


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., s, d) -> contiguous (bh, s, d)."""
    return x.reshape(-1, *x.shape[-2:]).contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
    return_lse: bool = False,
    q_offset=0,
    kv_offset=0,
    precision: str | None = None,
):
    """softmax(q·kᵀ·sm_scale)·v for (..., s, d) operands, on the forward
    kernel. Returns o, or (o, lse) with `return_lse`. q_offset/kv_offset
    shift the global positions of causal masking (ring attention passes its
    shard bases). `block_q`/`block_k` pick the forward's tile where they
    name one of `FLASH_TILES`; other values are the TPU's knobs, accepted
    and ignored (module docstring: the saved tile, else the default)."""
    _check_qkv(q, k, v)
    *lead, s, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    tile = resolve_flash_tile(q.shape, q.dtype, causal, precision, block_q, block_k)
    o, lse = flash_fwd_kernel(
        _flat(q), _flat(k), _flat(v), sm_scale=sm_scale, causal=causal,
        q_offset=q_offset, kv_offset=kv_offset, precision=precision,
        block_q=tile[0] if tile else 0)
    o = o.reshape(*lead, s, d)
    return (o, lse.reshape(*lead, s)) if return_lse else o


def flash_attention_bwd(
    q, k, v, o, lse, do,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
    q_offset=0,
    kv_offset=0,
    precision: str | None = None,
):
    """(dq, dk, dv) from the saved per-row logsumexp, on the dq and dk/dv
    kernels. `precision` must be the forward's. do is taken in q's type.
    `block_q`/`block_k` are accepted and ignored: the backward kernels keep
    their own tiles, where JAX's backward resolves the forward's key."""
    del block_q, block_k
    _check_qkv(q, k, v)
    *lead, s, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    do = do.to(q.dtype)
    out_dtype = torch.result_type(do, o)
    delta = (do.float() * o.float()).sum(-1).to(out_dtype).float()
    args = (_flat(q), _flat(k), _flat(v), _flat(do),
            lse.reshape(-1, s).float().contiguous(), delta.reshape(-1, s).contiguous())
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=q_offset,
              kv_offset=kv_offset, precision=precision)
    dq = flash_dq_kernel(*args, **kw)
    dk, dv = flash_dkv_kernel(*args, **kw)
    return tuple(x.reshape(*lead, s, d) for x in (dq, dk, dv))


def _flash_tile_key(bh, s, d, dtype_name, causal, tier) -> str:
    """JAX's key of a saved flash tile (tpusparse/kernels/flash_attention.py:323)."""
    return f"{bh}x{s}x{d}x{dtype_name}x{'c' if causal else 'f'}x{tier}"


def _saved_flash_tiles() -> dict:
    """The 'flash_tiles' section of the calibration file for this card, read
    once into `_FLASH_TILE_CACHE`."""
    global _FLASH_TILE_LOADED
    if not _FLASH_TILE_LOADED:
        from tpusparse_torch.utils.calibrate import load_tile_section

        _FLASH_TILE_CACHE.update(load_tile_section("flash_tiles"))
        _FLASH_TILE_LOADED = True
    return _FLASH_TILE_CACHE


def resolve_flash_tile(shape, dtype, causal, precision, block_q=None, block_k=None):
    """The forward's (block_q, block_k) for (..., s, d) operands of `dtype`,
    or None for the default (128, 64) (and at d > 128, whose kernel has a
    tile of its own): explicit arguments where they name one of
    `FLASH_TILES` (block_k defaulting to 64), else the saved tile for JAX's
    key where it is one, else None."""
    *lead, s, d = shape
    if d > 128:
        return None
    if block_q is not None and (int(block_q), int(block_k or 64)) in FLASH_TILES:
        return int(block_q), int(block_k or 64)
    saved = _saved_flash_tiles()
    if not saved:
        return None
    bh = 1
    for x in lead:
        bh *= int(x)
    key = _flash_tile_key(bh, s, d, dtype_name(dtype), causal,
                          resolve_precision(precision))
    hit = saved.get(key)
    return tuple(hit) if hit and tuple(hit) in FLASH_TILES else None


def autotune_flash(seq: int, head_dim: int, bh: int, *, causal: bool = False,
                   dtype=torch.float32, precision: str | None = None, repeats: int = 2,
                   save: bool = True, verbose: bool = True, candidates=None):
    """Time the forward's tiles (`candidates`, default `FLASH_TILES`; a tile
    the kernel lacks raises ValueError) for (bh, seq, head_dim) operands on
    the card and keep the fastest for JAX's key (`_flash_tile_key`, at the
    resolved tier); with `save`, also in the calibration file's
    'flash_tiles' section, stamped with the card's name. Later
    `flash_attention` calls at the shape take it. Returns ((bq, bk),
    seconds a call). Raises without a card, as JAX's raises on the CPU.

    Each tile is timed by `utils.timing.device_time_per_iter` on a chain
    that feeds q's next value through a scalar of o (JAX's), the median of
    `repeats`. The backward keeps its own tiles, so only the forward is
    tuned."""
    import numpy as np

    from tpusparse_torch.utils.timing import device_time_per_iter

    tier = resolve_precision(precision)
    cands = []
    for bq, bk in candidates or FLASH_TILES:
        tile = (int(bq), int(bk))
        if tile not in FLASH_TILES:
            raise ValueError(f"flash_fwd has no tile {tile}; its tiles are {list(FLASH_TILES)}")
        if tile not in cands:
            cands.append(tile)
    if not torch.cuda.is_available():
        raise RuntimeError("autotune_flash runs on the CUDA card; no CUDA device is available")

    def mk(seed):
        x = np.random.default_rng(seed).standard_normal((bh, seq, head_dim))
        return torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)

    q, k, v = mk(0), mk(1), mk(2)
    best, best_t = None, float("inf")
    for bq, bk in cands:
        def step(x, bq=bq, bk=bk):
            y = flash_attention(x, k, v, causal=causal, block_q=bq, block_k=bk,
                                precision=tier)
            return x * (1.0 + 0.0 * y.abs().max().to(x.dtype))

        t = float(np.median([device_time_per_iter(step, q, iters_lo=2, iters_hi=6)
                             for _ in range(repeats)]))
        if verbose:
            print(f"[autotune-flash] ({bq},{bk}): {t * 1e3:.4f} ms", flush=True)
        if t < best_t:
            best, best_t = (bq, bk), t
    key = _flash_tile_key(bh, seq, head_dim, dtype_name(dtype), causal, tier)
    _saved_flash_tiles()[key] = list(best)
    if save:
        from tpusparse_torch.utils.calibrate import save_tile_entry

        save_tile_entry("flash_tiles", key, best)
    if verbose:
        print(f"[autotune-flash] best {best} = {best_t * 1e3:.4f} ms", flush=True)
    return best, best_t


class _FlashAttention(torch.autograd.Function):
    """o = flash_attention(q, k, v); saves (q, k, v, o, lse) and runs the
    backward on the dq and dk/dv kernels (tpusparse l.737-760)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, precision):
        o, lse = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                 return_lse=True, precision=precision)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, sm_scale=sm_scale, precision=precision)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q, k, v, causal=False, sm_scale=None, precision=None):
    """Differentiable fused attention: forward and backward on the kernels,
    only the per-row logsumexp saved beside the operands. The tier is
    resolved once, here, so the backward's score recompute matches the
    forward's."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale, resolve_precision(precision))


# ----------------------------------------------------------------------------
# int8 K/V cache (the serving tier), forward only
# ----------------------------------------------------------------------------


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per-(batch·head) symmetric int8 quantization of a KV cache.

    k, v: (..., seq, head_dim). Returns (kq, ks, vq, vs): kq, vq int8 of the
    same shape, ks, vs fp32 of the leading shape, with
    k ≈ ks[..., None, None] · kq. An all-zero head gets scale 1. The scale
    and the division are taken in the input's type, as in JAX, so the
    values equal JAX's exactly."""

    def one(x):
        amax = x.abs().amax(dim=(-2, -1))
        # a tensor divisor: the card divides by a Python scalar as a multiply
        # by its reciprocal, which rounds differently from JAX's division
        s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
        q = torch.clamp(torch.round(x / s[..., None, None]), -127, 127).to(torch.int8)
        return q, s.float()

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, ks, vq, vs


def flash_q8_kernel(
    q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    *, sm_scale: float, causal: bool = False, q_offset: int = 0, kv_offset: int = 0,
) -> torch.Tensor:
    """o of softmax(q·(ks·kq)ᵀ·sm_scale)·(vs·vq) for contiguous (bh, s, d) q
    (fp32 or bf16) and int8 kq, vq, with fp32 (bh,) scales; o in q's type."""
    if q.ndim != 3:
        raise ValueError(f"kernel operands are (bh, s, d), got {tuple(q.shape)}")
    _check_q8(q, kq, vq, ks, vs)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    for name, t in (("ks", ks), ("vs", vs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("q", q), ("kq", kq), ("vq", vq), ("ks", ks), ("vs", vs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} and q on {q.device}: same device needed")
    kw = dict(sm_scale=sm_scale, causal=causal, q_offset=int(q_offset),
              kv_offset=int(kv_offset))
    if q.device.type == "cpu":
        return _flash_q8_plain(q, kq, vq, ks, vs, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bh, s, d = q.shape
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    rc = _q8_kernel_fn()(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(), vs.data_ptr(), o.data_ptr(),
        _DTYPE_CODE[q.dtype], bh, s, d, float(sm_scale), int(causal), kw["q_offset"],
        kw["kv_offset"], q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "flash_q8")
    _LAUNCHES["flash_q8"] += 1
    return o


def _check_q8(q, kq, vq, ks, vs) -> None:
    """The guards of JAX `flash_attention_q8`: equal shapes, int8 K and V,
    scales of the leading shape."""
    if q.shape != kq.shape or kq.shape != vq.shape:
        raise ValueError(
            f"q/kq/vq shapes differ: {tuple(q.shape)} {tuple(kq.shape)} {tuple(vq.shape)}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError(f"kq/vq must be int8, got {kq.dtype}/{vq.dtype}")
    lead = tuple(q.shape[:-2])
    if tuple(ks.shape) != lead or tuple(vs.shape) != lead:
        raise ValueError(f"scales must have the leading shape {lead}, got "
                         f"{tuple(ks.shape)}/{tuple(vs.shape)}")


@functools.cache
def _q8_kernel_fn():
    """The C entry point of csrc/flash_attention_q8.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, kq, vq, ks, vs, o, q_dtype, bh, s, d, sm_scale, causal, q_off, kv_off,
    # device, stream
    return _build.bind(KERNEL_Q8, {"flash_q8": [p] * 6 + [i] * 4 + [f] + [i] * 4 + [p]})[
        "flash_q8"]


def _flash_q8_plain(q, kq, vq, ks, vs, *, sm_scale: float, causal: bool = False,
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Plain version of the int8-KV forward, on the inputs' device: a dense
    masked softmax over the whole row, q and p rounded to bf16, the scores
    scaled by fp32(sm_scale)·ks after the product, o = (p·vq) / l · vs."""
    qf = _tier(q.float(), True)
    vis = _visible(q.shape[-2], causal, q_offset, kv_offset, q.device)
    scale = torch.tensor(sm_scale, dtype=torch.float32) * ks
    with fp32_matmul():
        sc = torch.where(vis, (qf @ kq.float().transpose(-1, -2)) * scale[:, None, None],
                         NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(vis, torch.exp(sc - m), 0.0)
        l = p.sum(-1, keepdim=True)
        o = (_tier(p, True) @ vq.float()) / torch.where(l == 0, 1.0, l) * vs[:, None, None]
    return o.to(q.dtype)


def flash_attention_q8(
    q: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
    q_offset=0,
    kv_offset=0,
) -> torch.Tensor:
    """softmax(q·(ks·kq)ᵀ·sm_scale)·(vs·vq), fused, int8 K/V, forward only.

    Shapes as `flash_attention`: (..., s, d); kq, vq int8 from `quantize_kv`,
    ks, vs the per-(batch·head) scales of the leading shape. Serving-tier
    numerics (~1e-2 relative against the float kernel, int8's information
    limit). `block_q`/`block_k` are the TPU kernel's tile knobs, accepted and
    ignored."""
    del block_q, block_k
    _check_q8(q, kq, vq, ks, vs)
    *lead, s, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    o = flash_q8_kernel(
        _flat(q), _flat(kq), _flat(vq), ks.reshape(-1).float().contiguous(),
        vs.reshape(-1).float().contiguous(), sm_scale=sm_scale, causal=causal,
        q_offset=q_offset, kv_offset=kv_offset)
    return o.reshape(*lead, s, d)
