"""Sequence-parallel attention: the ring-halo band, Ulysses and ring flash.

Counterpart of `tpusparse/parallel/attention.py`. q, k and v are the global
(batch, heads, seq, head_dim) tensors that every rank holds; each rank takes
its block of the sequence (`mesh.shard`), runs its part, and every rank
returns the global context (`mesh.gather`), with the gradients of the global
loss:

  * `ring_local_attention`: banded attention |i - j| <= window. A rank sends
    its last K/V block to its right neighbour and its first to its left
    (`mesh.ring_permute`, two hops), then runs `nn.attention.banded_blocks`
    on its blocks with their global positions; the blocks that wrap round
    the ring are masked by those positions.
  * `ulysses_attention`: an all-to-all trades the sequence block for a block
    of heads, each rank runs full attention over its heads (the dense form
    on `dense.einsum`, or `flash_attention_diff` with `fused=True`), and a
    second all-to-all trades them back. A per-head mask is sliced to this
    rank's heads.
  * `ring_flash_attention`: full attention that never holds the whole
    sequence. Each rank keeps its q block and passes the K/V blocks round
    the ring, one hop a step (the next block is sent while the kernel works
    on this one), calling the flash forward kernel once per block with the
    block's global `q_offset`/`kv_offset` and `return_lse=True`; the
    partials merge in fp32 through their logsumexps. The backward
    (`_RingFlash`) calls the dq and dk/dv kernels once per block on the
    saved global logsumexp: dq sums on its rank, dk/dv travel on with their
    block and land back on its owner after the last hop. The tier is
    resolved once, so every call and the backward share it.

At world size 1 nothing is sent, ring flash and fused Ulysses are
`flash_attention_diff` bit for bit (one block, the same kernel calls), and
the ring band is `LocalAttention`'s core.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpusparse_torch import dense
from tpusparse_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_diff,
)
from tpusparse_torch.nn.attention import banded_blocks
from tpusparse_torch.parallel.mesh import (
    all_to_all,
    axis_rank,
    axis_size,
    finish_permute,
    gather,
    ring_permute,
    shard,
    start_permute,
)
from tpusparse_torch.utils.config import resolve_precision

__all__ = ["ring_local_attention", "ulysses_attention", "ring_flash_attention"]

SEQ = 2  # the sequence dim of (batch, heads, seq, head_dim)


def ring_local_attention(q, k, v, window: int, mesh, axis: str = "seq") -> torch.Tensor:
    """Banded attention with the sequence split over `axis`.

    q/k/v: (batch, heads, seq, head_dim); seq must divide into window-sized
    blocks spread evenly over the axis. Returns the global context."""
    b, h, s, hd = q.shape
    B, n = window, axis_size(mesh, axis)
    if s % (B * n) != 0:
        raise ValueError(f"seq {s} must divide into window {B} blocks over {n} shards")
    nbl = s // B // n
    group = mesh.get_group(axis)
    qb, kb, vb = (shard(x, group, SEQ).reshape(b, h, nbl, B, hd) for x in (q, k, v))
    # my last block is my right neighbour's left halo, my first its left's right
    k_left, v_left = ring_permute((kb[:, :, -1], vb[:, :, -1]), group, 1)
    k_right, v_right = ring_permute((kb[:, :, 0], vb[:, :, 0]), group, -1)
    k_pad = torch.cat([k_left[:, :, None], kb, k_right[:, :, None]], dim=2)
    v_pad = torch.cat([v_left[:, :, None], vb, v_right[:, :, None]], dim=2)
    ctx = banded_blocks(qb, k_pad, v_pad, B, axis_rank(mesh, axis) * nbl, s)
    return gather(ctx.reshape(b, h, nbl * B, hd), group, SEQ)


def ulysses_attention(q, k, v, mesh, axis: str = "seq", mask=None, fused: bool = False,
                      causal: bool = False) -> torch.Tensor:
    """Full attention over sequence-split inputs by the Ulysses reshard.

    q/k/v: (batch, heads, seq, head_dim); heads and seq must divide the axis.
    `mask` (bool, broadcast against (b, h, s, s)) applies to the unfused
    form; a mask with the full heads dim is sliced to this rank's heads.
    `fused=True` runs `flash_attention_diff` and takes `causal` only."""
    b, h, s, hd = q.shape
    n = axis_size(mesh, axis)
    if h % n != 0 or s % n != 0:
        raise ValueError(f"heads {h} and seq {s} must divide the '{axis}' axis ({n})")
    if fused and mask is not None:
        raise ValueError("fused ulysses supports causal masks only")
    group = mesh.get_group(axis)
    qh, kh, vh = (all_to_all(shard(x, group, SEQ), group, 1, SEQ) for x in (q, k, v))
    if fused:
        ctx = flash_attention_diff(qh, kh, vh, causal, None)
    else:
        if mask is not None and mask.ndim == 4 and mask.shape[1] == h:
            mask = mask.narrow(1, axis_rank(mesh, axis) * (h // n), h // n)
        scores = dense.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(hd)
        if causal:
            tril = torch.ones((s, s), dtype=torch.bool, device=scores.device).tril()
            scores = torch.where(tril, scores, -1e9)
        if mask is not None:
            scores = torch.where(mask.to(scores.device), scores, -1e9)
        ctx = dense.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vh)
    return gather(all_to_all(ctx, group, SEQ, 1), group, SEQ)


def _merge_partial(o1, lse1, o2, lse2):
    """Two normalised partial attentions combined through their logsumexps."""
    lse = torch.logaddexp(lse1, lse2)
    return o1 * torch.exp(lse1 - lse)[..., None] + o2 * torch.exp(lse2 - lse)[..., None], lse


class _RingFlash(torch.autograd.Function):
    """(q, k, v) blocks of this rank -> its block of the context."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, precision):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        sl = q.shape[SEQ]
        kw = dict(causal=causal, return_lse=True, precision=precision)
        kc, vc = k.contiguous(), v.contiguous()
        o = lse = None
        for t in range(size):
            hop = start_permute((kc, vc), group) if t + 1 < size else None
            o_t, lse_t = flash_attention(q, kc, vc, q_offset=rank * sl,
                                         kv_offset=(rank - t) % size * sl, **kw)
            if o is None:
                o, lse = o_t, lse_t
            else:
                o, lse = _merge_partial(o.float(), lse, o_t.float(), lse_t)
            if hop is not None:
                kc, vc = finish_permute(*hop)
        # the merge is fp32; the result has q's type whatever the rank count
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.precision = group, causal, precision
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        sl = q.shape[SEQ]
        kc, vc = k.contiguous(), v.contiguous()
        dq = dk = dv = None
        for t in range(size):
            if t:
                kc, vc, dk, dv = finish_permute(*start_permute((kc, vc, dk, dv), group))
            dq_t, dk_t, dv_t = flash_attention_bwd(
                q, kc, vc, o, lse, g, causal=ctx.causal, q_offset=rank * sl,
                kv_offset=(rank - t) % size * sl, precision=ctx.precision)
            if dq is None:
                dq, dk, dv = dq_t, dk_t, dv_t
            else:
                dq, dk, dv = dq + dq_t, dk + dk_t, dv + dv_t
        if size > 1:  # one more hop: each block's sums back to its owner
            dk, dv = finish_permute(*start_permute((dk, dv), group))
        return dq, dk, dv, None, None, None


def ring_flash_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False,
                         precision: str | None = None) -> torch.Tensor:
    """Full flash attention with the sequence split over `axis`.

    q/k/v: (batch, heads, seq, head_dim), seq divisible by the axis size.
    `causal=True` masks on global positions through each call's offsets.
    Returns the global context in q's type."""
    s = q.shape[SEQ]
    n = axis_size(mesh, axis)
    if s % n != 0:
        raise ValueError(f"seq {s} must divide the '{axis}' axis ({n})")
    group = mesh.get_group(axis)
    qs, ks, vs = (shard(x, group, SEQ) for x in (q, k, v))
    o = _RingFlash.apply(qs, ks, vs, group, causal, resolve_precision(precision))
    return gather(o, group, SEQ)
