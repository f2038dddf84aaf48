"""Block-pattern fused attention: the plan, the forward, dq and dk/dv
kernels, and their autograd.

Counterpart of `tpusparse/kernels/flash_attention.py:792-1398`:
`BlockAttnPlan` (l.792) with `from_token_pattern`, `density` and
`padding_ratio`; the TPU kernels `_blk_flash_kernel` (l.929),
`_blk_dq_kernel` (l.1136) and `_blk_dkv_kernel` (l.1175) become the three
CUDA kernels of `csrc/block_flash_attention.cu`; `block_flash_attention`
(l.1010), `block_flash_attention_bwd` (l.1219) and
`block_flash_attention_diff` (l.1392) keep their signatures, the last as a
`torch.autograd.Function` that saves (q, k, v, o, lse).

Contracts carried over:
  - operands (..., s, d) of one shape and type (fp32 or bf16), s the plan's
    seq; the leading dims are flattened to bh. o has q's type, lse =
    m + log(l) is fp32 (..., s);
  - `sm_scale` defaults to 1/sqrt(d) and multiplies the product q·kᵀ, not q
    (l.957, l.1126); dS = p·(dp − delta)·sm_scale, dq = dS·k, dk = dSᵀ·q
    with the unscaled q, dv = pᵀ·do;
  - `delta = sum_d do * o` is computed outside the kernels, in the result
    type of do and o, then fp32 (l.1237); do is taken in q's type;
  - masking: a key at or past s, a query at or past s (backward), and an
    entry whose tile mask is 0 are masked (-1e30) and their probabilities
    are exactly 0; a row with no visible key gets o = 0, lse = -1e30;
  - tiers: 'high' and 'highest' are fp32-class, never one TF32 pass
    (3xTF32 on the tensor cores).
    'default' on fp32 inputs rounds every product's operands to bf16 (q, k,
    v, do, and p, dS) with fp32 sums: what the TPU's DEFAULT
    dot does to the fp32 operands that the JAX wrapper leaves uncast. bf16
    inputs round p and dS to bf16 in every tier (l.979, l.1163, l.1201,
    l.1206);
  - d is taken as it is, any size (the TPU wrapper padded it to a multiple
    of 128): above 128 all three kernels run on teams of warps that split d
    into slices (128 wide in the forward, 64 in the backward), above 512 in
    512-wide output chunks.

A wrapper given CPU tensors runs the plain PyTorch version of its kernel
(`_blk_fwd_plain`, `_blk_dq_plain`, `_blk_dkv_plain`: a dense masked
softmax over the plan's token-exact (s, s) mask in fp32 with TF32 off,
rounded as the tier says). Given CUDA tensors it launches the kernel or
raises. It counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpusparse_torch.kernels.flash_attention import (
    NEG_INF,
    _check_kernel_args,
    _check_qkv,
    _DTYPE_CODE,
    _flat,
    _raise_on,
    _rounds,
    _stream,
    _tier,
)
from tpusparse_torch.utils.config import fp32_matmul, resolve_precision

KERNEL = "block_flash_attention"
_LAUNCHES = {"blk_flash_fwd": 0, "blk_flash_dq": 0, "blk_flash_dkv": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ----------------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------------


class BlockAttnPlan:
    """Host-side plan for a block-sparse attention pattern.

    kv_list (nq, L) int32: the kv-block ids each q-block attends to, pad
    slots repeating the last valid id (never computed); kv_cnt (nq,): the
    valid counts; q_list (nk, Lt) / q_cnt (nk,): the transposed lists that
    drive the dK/dV backward. `from_token_pattern` builds the plan from a
    token CSR and attaches an int8 (bq, bk) mask tile for each covered
    block (`tile_masks`, shape (nq·L, bq, bk)) when any covered block is
    only partly allowed; `q_slot` (nk·Lt,) maps the dK/dV cell (kv-block j,
    slot l) to the forward's tile id, so the masks are stored once. Plans
    whose covered blocks are all full keep tile_masks = None and run the
    mask-free kernels. The arrays equal the JAX package's.

    The device copies of the arrays (`device_arrays`) are made once per
    device and kept with the plan.
    """

    def __init__(self, block_mask, block_q: int, block_k: int, seq: int):
        mask = np.asarray(block_mask, bool)
        nq, nk = mask.shape
        if nq * block_q < seq or nk * block_k < seq:
            raise ValueError(
                f"block grid {mask.shape} x ({block_q},{block_k}) "
                f"does not cover seq {seq}"
            )
        kv_cnt = mask.sum(axis=1).astype(np.int32)
        q_cnt = mask.sum(axis=0).astype(np.int32)
        if (kv_cnt == 0).any():
            raise ValueError(
                "every q block must attend to at least one kv block "
                f"(empty rows: {np.flatnonzero(kv_cnt == 0).tolist()[:8]})"
            )
        L = int(kv_cnt.max())
        Lt = max(int(q_cnt.max()), 1)
        kv_list = np.zeros((nq, L), np.int32)
        q_list = np.zeros((nk, Lt), np.int32)
        # slot_of[i, j] = position of kv-block j in row i's list (or -1)
        slot_of = np.full((nq, nk), -1, np.int32)
        for i in range(nq):
            ids = np.flatnonzero(mask[i]).astype(np.int32)
            kv_list[i, : ids.size] = ids
            kv_list[i, ids.size:] = ids[-1]
            slot_of[i, ids] = np.arange(ids.size, dtype=np.int32)
        for j in range(nk):
            ids = np.flatnonzero(mask[:, j]).astype(np.int32)
            q_list[j, : ids.size] = ids
            q_list[j, ids.size:] = ids[-1] if ids.size else 0
        self.kv_list, self.kv_cnt = kv_list, kv_cnt
        self.q_list, self.q_cnt = q_list, q_cnt
        self.block_q, self.block_k = int(block_q), int(block_k)
        self.seq = int(seq)
        self.nq, self.nk, self.L, self.Lt = nq, nk, L, Lt
        self.block_mask = mask
        self._slot_of = slot_of
        self.tile_masks = None  # (nq*L, bq, bk) int8, partial-block plans only
        self.q_slot = None      # (nk*Lt,) int32 tile-id lookup for dK/dV
        self.token_nnz = None   # token pattern nnz (from_token_pattern)
        self._on_device = {}

    @classmethod
    def from_token_pattern(cls, indices, indptr, seq: int, block_q: int,
                           block_k: int) -> "BlockAttnPlan":
        """Plan for an arbitrary token-level pattern (CSR indices/indptr over
        (seq, seq)): block-ifies it to the (block_q, block_k) grid and
        attaches exact per-tile token masks when a covered block is only
        partly allowed. Every token row must allow at least one key."""
        indices = np.asarray(indices, np.int64)
        indptr = np.asarray(indptr, np.int64)
        if indptr.shape[0] != seq + 1:
            raise ValueError(f"indptr covers {indptr.shape[0] - 1} rows, seq={seq}")
        row_nnz = np.diff(indptr)
        if (row_nnz == 0).any():
            raise ValueError(
                "every token row must attend to at least one key (empty "
                f"rows: {np.flatnonzero(row_nnz == 0).tolist()[:8]})"
            )
        rows = np.repeat(np.arange(seq, dtype=np.int64), row_nnz)
        nq = -(-seq // block_q)
        nk = -(-seq // block_k)
        bi, bj = rows // block_q, indices // block_k
        block_mask = np.zeros((nq, nk), bool)
        block_mask[bi, bj] = True
        plan = cls(block_mask, block_q, block_k, seq)
        plan.token_nnz = int(indices.size)
        # a covered tile is full when every in-range (row, col) entry is set
        tid = bi * np.int64(plan.L) + plan._slot_of[bi, bj]
        counts = np.bincount(tid, minlength=nq * plan.L)
        ii, ll = np.divmod(np.arange(nq * plan.L), plan.L)
        jj = plan.kv_list.reshape(-1)
        vr = np.minimum(seq - ii * block_q, block_q).clip(0)
        vc = np.minimum(seq - jj * block_k, block_k).clip(0)
        covered = ll < plan.kv_cnt[ii]
        if bool(((counts >= vr * vc) | ~covered).all()):
            return plan  # a pure block pattern: the mask-free kernels
        masks = np.zeros((nq * plan.L, block_q, block_k), np.int8)
        masks[tid, rows % block_q, indices % block_k] = 1
        plan.tile_masks = masks
        # tile id of the dK/dV cell (kv-block j, slot l): the forward stored
        # the (q_list[j, l], j) tile at q_list[j, l]·L + slot_of[q_list[j, l], j];
        # pad slots repeat a valid q-block, and an unreached -1 maps to 0
        slot = plan._slot_of[plan.q_list, np.arange(nk, dtype=np.int64)[:, None]]
        tid_t = plan.q_list.astype(np.int64) * plan.L + np.maximum(slot, 0)
        plan.q_slot = tid_t.reshape(-1).astype(np.int32)
        return plan

    @property
    def density(self) -> float:
        return float(self.block_mask.mean())

    @property
    def padding_ratio(self) -> float:
        """Covered token slots / pattern nnz: the block-ification cost (1.0 =
        the pattern is exactly blocks)."""
        covered = float(self.kv_cnt.sum()) * self.block_q * self.block_k
        return covered / float(self.token_nnz or covered)

    @property
    def covered_tiles(self) -> int:
        """Covered (q-block, kv-block) tiles: the work of one head."""
        return int(self.kv_cnt.sum())

    def token_mask_np(self) -> np.ndarray:
        """(seq, seq) bool: the exact token pattern the plan computes."""
        bq, bk = self.block_q, self.block_k
        tiles = np.zeros((self.nq, self.nk, bq, bk), bool)
        ii, ll = np.nonzero(np.arange(self.L)[None, :] < self.kv_cnt[:, None])
        jj = self.kv_list[ii, ll]
        tiles[ii, jj] = True if self.tile_masks is None else (
            self.tile_masks[ii * self.L + ll] != 0)
        full = tiles.transpose(0, 2, 1, 3).reshape(self.nq * bq, self.nk * bk)
        return full[: self.seq, : self.seq]

    def _device(self, name: str, device, make) -> torch.Tensor:
        key = (name, str(torch.device(device)))
        t = self._on_device.get(key)
        if t is None:
            t = make().to(device)
            self._on_device[key] = t
        return t

    def token_mask(self, device) -> torch.Tensor:
        """`token_mask_np` as a bool tensor on `device`, kept with the plan."""
        return self._device("token_mask", device,
                            lambda: torch.from_numpy(self.token_mask_np()))

    def device_arrays(self, device) -> dict:
        """The kernels' plan arrays on `device`: int32 kv_list, kv_cnt,
        q_list, q_cnt and, for masked plans, q_slot and the int8 tile_masks
        (None otherwise)."""
        out = {}
        for name in ("kv_list", "kv_cnt", "q_list", "q_cnt", "q_slot", "tile_masks"):
            arr = getattr(self, name)
            out[name] = None if arr is None else self._device(
                name, device, lambda a=arr: torch.from_numpy(np.ascontiguousarray(a)))
        return out


# ----------------------------------------------------------------------------
# Kernel wrappers on (bh, s, d) operands
# ----------------------------------------------------------------------------


def _check_plan(q: torch.Tensor, plan: BlockAttnPlan) -> None:
    if q.shape[-2] != plan.seq:
        raise ValueError(f"plan is for seq {plan.seq}, got {q.shape[-2]}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _plan_args(plan: BlockAttnPlan, device, transposed: bool) -> list:
    """Pointers to the plan arrays one kernel reads: (kv_list, kv_cnt,
    tile_masks) for the forward and dq, (q_list, q_cnt, q_slot,
    tile_masks) for dk/dv."""
    arr = plan.device_arrays(device)
    names = ("q_list", "q_cnt", "q_slot") if transposed else ("kv_list", "kv_cnt")
    return [_ptr(arr[n]) for n in names] + [_ptr(arr["tile_masks"])]


def _shape_args(q: torch.Tensor, plan: BlockAttnPlan, transposed: bool) -> list:
    bh, s, d = q.shape
    width = plan.Lt if transposed else plan.L
    return [bh, s, d, plan.block_q, plan.block_k, plan.nq, plan.nk, width]


def blk_flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         plan: BlockAttnPlan, *, sm_scale: float,
                         precision: str | None = None):
    """(o, lse) of the block-pattern attention for contiguous (bh, s, d)
    operands: o in q's type, lse fp32 (bh, s)."""
    _check_kernel_args({"q": q, "k": k, "v": v}, {})
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return _blk_fwd_plain(q, k, v, plan, sm_scale=sm_scale, precision=precision)
    bh, s, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    rc = _kernel_fns()["blk_flash_fwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_plan_args(plan, q.device, False), _DTYPE_CODE[q.dtype],
        *_shape_args(q, plan, False), float(sm_scale), int(_rounds(q.dtype, precision)),
        q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "blk_flash_fwd")
    _LAUNCHES["blk_flash_fwd"] += 1
    return o, lse


def blk_flash_dq_kernel(q, k, v, do, lse, delta, plan: BlockAttnPlan, *,
                        sm_scale: float, precision: str | None = None) -> torch.Tensor:
    """dq for contiguous (bh, s, d) q, k, v, do and fp32 (bh, s) lse, delta."""
    _check_kernel_args({"q": q, "k": k, "v": v, "do": do}, {"lse": lse, "delta": delta})
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return _blk_dq_plain(q, k, v, do, lse, delta, plan, sm_scale=sm_scale,
                             precision=precision)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    rc = _kernel_fns()["blk_flash_dq"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_plan_args(plan, q.device, False),
        _DTYPE_CODE[q.dtype], *_shape_args(q, plan, False), float(sm_scale),
        int(_rounds(q.dtype, precision)), q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "blk_flash_dq")
    _LAUNCHES["blk_flash_dq"] += 1
    return dq


def blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan: BlockAttnPlan, *,
                         sm_scale: float, precision: str | None = None):
    """(dk, dv) for contiguous (bh, s, d) q, k, v, do and fp32 (bh, s) lse,
    delta."""
    _check_kernel_args({"q": q, "k": k, "v": v, "do": do}, {"lse": lse, "delta": delta})
    _check_plan(q, plan)
    if q.device.type == "cpu":
        return _blk_dkv_plain(q, k, v, do, lse, delta, plan, sm_scale=sm_scale,
                              precision=precision)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    rc = _kernel_fns()["blk_flash_dkv"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_plan_args(plan, q.device, True),
        _DTYPE_CODE[q.dtype], *_shape_args(q, plan, True), float(sm_scale),
        int(_rounds(q.dtype, precision)), q.device.index or 0, _stream(q),
    )
    _raise_on(rc, "blk_flash_dkv")
    _LAUNCHES["blk_flash_dkv"] += 1
    return dk, dv


@functools.cache
def _kernel_fns() -> dict:
    """The C entry points of csrc/block_flash_attention.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # tensors..., plan arrays..., dtype, bh, s, d, bq, bk, nq, nk, L (or Lt),
    # sm_scale, round_bf16, device, stream
    tail = [i] * 9 + [f, i, i, p]
    return _build.bind(KERNEL, {
        "blk_flash_fwd": [p] * 5 + [p] * 3 + tail,
        "blk_flash_dq": [p] * 7 + [p] * 3 + tail,
        "blk_flash_dkv": [p] * 8 + [p] * 4 + tail,
    })


# ----------------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------------


def _blk_fwd_plain(q, k, v, plan: BlockAttnPlan, *, sm_scale: float,
                   precision: str | None = None):
    """Plain version of the forward, on the inputs' device: a dense masked
    softmax over the plan's token mask (one tile a row), p rounded as the
    tier says."""
    round_bf16 = _rounds(q.dtype, precision)
    qf, kf, vf = (_tier(x.float(), round_bf16) for x in (q, k, v))
    vis = plan.token_mask(q.device)
    with fp32_matmul():
        sc = torch.where(vis, (qf @ kf.transpose(-1, -2)) * sm_scale, NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(vis, torch.exp(sc - m), 0.0)
        den = p.sum(-1, keepdim=True)
        den = torch.where(den == 0, 1.0, den)
        o = (_tier(p, round_bf16) @ vf) / den
    return o.to(q.dtype), (m + torch.log(den))[..., 0]


def _blk_probs_and_ds(q, k, v, do, lse, delta, plan, sm_scale, round_bf16):
    """(staged q, staged k, staged do, P, dS) of the backward, in fp32."""
    qf, kf, vf, dof = (_tier(x.float(), round_bf16) for x in (q, k, v, do))
    vis = plan.token_mask(q.device)
    with fp32_matmul():
        sc = (qf @ kf.transpose(-1, -2)) * sm_scale
        p = torch.where(vis, torch.exp(sc - lse[..., None]), 0.0)
        ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * sm_scale
    return qf, kf, dof, p, ds


def _blk_dq_plain(q, k, v, do, lse, delta, plan: BlockAttnPlan, *, sm_scale: float,
                  precision: str | None = None):
    """Plain version of the dq kernel: round(dS) · k."""
    round_bf16 = _rounds(q.dtype, precision)
    _, kf, _, _, ds = _blk_probs_and_ds(q, k, v, do, lse, delta, plan, sm_scale, round_bf16)
    with fp32_matmul():
        return (_tier(ds, round_bf16) @ kf).to(q.dtype)


def _blk_dkv_plain(q, k, v, do, lse, delta, plan: BlockAttnPlan, *, sm_scale: float,
                   precision: str | None = None):
    """Plain version of the dk/dv kernel: dv = round(P)ᵀ·do, dk = round(dS)ᵀ·q."""
    round_bf16 = _rounds(q.dtype, precision)
    qf, _, dof, p, ds = _blk_probs_and_ds(q, k, v, do, lse, delta, plan, sm_scale, round_bf16)
    with fp32_matmul():
        dv = _tier(p, round_bf16).transpose(-1, -2) @ dof
        dk = _tier(ds, round_bf16).transpose(-1, -2) @ qf
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------------
# Public functions, with the JAX signatures
# ----------------------------------------------------------------------------


def block_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: BlockAttnPlan,
    *,
    sm_scale: float | None = None,
    return_lse: bool = False,
    precision: str | None = None,
):
    """Fused attention restricted to the plan's block pattern, on the
    forward kernel: compute and traffic scale with the covered tiles, not
    seq². Matches masked dense softmax attention on the allowed pattern
    (rows with no allowed key return 0). Returns o, or (o, lse)."""
    _check_qkv(q, k, v)
    *lead, s, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    o, lse = blk_flash_fwd_kernel(_flat(q), _flat(k), _flat(v), plan, sm_scale=sm_scale,
                                  precision=precision)
    o = o.reshape(*lead, s, d)
    return (o, lse.reshape(*lead, s)) if return_lse else o


def block_flash_attention_bwd(q, k, v, o, lse, do, plan: BlockAttnPlan, *,
                              sm_scale: float | None = None, precision: str | None = None):
    """(dq, dk, dv) of the block-pattern attention from the saved lse, on
    the dq and dk/dv kernels. `precision` must be the forward's."""
    _check_qkv(q, k, v)
    *lead, s, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    out_dtype = torch.result_type(do, o)
    delta = (do.float() * o.float()).sum(-1).to(out_dtype).float()
    args = (_flat(q), _flat(k), _flat(v), _flat(do.to(q.dtype)),
            lse.reshape(-1, s).float().contiguous(), delta.reshape(-1, s).contiguous(), plan)
    kw = dict(sm_scale=sm_scale, precision=precision)
    dq = blk_flash_dq_kernel(*args, **kw)
    dk, dv = blk_flash_dkv_kernel(*args, **kw)
    return tuple(x.reshape(*lead, s, d) for x in (dq, dk, dv))


class _BlockFlashAttention(torch.autograd.Function):
    """o = block_flash_attention(q, k, v, plan); saves (q, k, v, o, lse) and
    runs the backward on the dq and dk/dv kernels (tpusparse l.1367-1389)."""

    @staticmethod
    def forward(ctx, q, k, v, plan, sm_scale, precision):
        o, lse = block_flash_attention(q, k, v, plan, sm_scale=sm_scale, return_lse=True,
                                       precision=precision)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plan = plan
        ctx.args = dict(sm_scale=sm_scale, precision=precision)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = block_flash_attention_bwd(q, k, v, o, lse, g, ctx.plan, **ctx.args)
        return dq, dk, dv, None, None, None


def block_flash_attention_diff(q, k, v, plan: BlockAttnPlan, sm_scale=None, precision=None):
    """Differentiable block-pattern fused attention: forward and backward on
    the kernels. The tier is resolved once, here, so the backward's score
    recompute matches the forward's."""
    return _BlockFlashAttention.apply(q, k, v, plan, sm_scale, resolve_precision(precision))
