"""Multi-head self-attention modules as `torch.nn.Module`s, and the
attention patterns and router they use.

Counterpart of `tpusparse/nn/attention.py`. The query, key, value and output
projections are the port's `DenseLinear`s, named as the flax submodules, so
`convert.load_flax_params` carries a flax tree across. Q, K and V are kept
in the JAX layouts at every function they reach, so the tests compare like
with like.

  SelfAttention        (l.370) fused=False: scores = transb_mm(q, k) /
                       sqrt(hd) on the dense ops, causal and user masks fill
                       with -1e9, then softmax and mm(probs, v); fused=True:
                       `flash_attention_diff` (csrc/flash_attention.cu),
                       causal masking only;
  SparseSelfAttention  (l.173) a token pattern (local + global band by
                       default) on one of three engines: 'blockflash' (the
                       block-pattern kernels of csrc/block_flash_attention.cu
                       with exact per-tile masks), 'dense' (a masked softmax
                       on the dense ops) or 'sddmm' (per-nonzero scores by
                       `ops.sddmm`, a segment softmax, `ops.gather_spmm`);
                       'auto' asks `route_sparse_attention`;
  LocalAttention       (l.324) the band |i - j| <= window, blockwise on
                       `dense.einsum` (no kernel);
  BigBirdAttention     (l.454) window + global + random blocks on the
                       block-pattern kernels.

The pattern builders draw the same random blocks as the JAX package's, from
`np.random.default_rng(seed)`. Plans are cached by pattern, as in JAX
(l.160-170, l.524-529); a module keeps the pattern, plan and engine it
resolved for each seq, which the JAX package gets once per trace.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpusparse_torch import dense, ops
from tpusparse_torch.kernels.block_flash_attention import (
    BlockAttnPlan,
    block_flash_attention_diff,
)
from tpusparse_torch.kernels.flash_attention import flash_attention_diff
from tpusparse_torch.nn.layers import DenseLinear
from tpusparse_torch.types import CSR


# ----------------------------------------------------------------------------
# Patterns
# ----------------------------------------------------------------------------


def local_global_pattern(seq: int, window: int, num_global: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Static (seq, seq) attention pattern as host CSR (indices, indptr):
    row i attends to keys j with |i - j| <= window, to the first
    `num_global` keys, and rows < num_global attend everywhere."""
    i = np.arange(seq)[:, None]
    j = np.arange(seq)[None, :]
    allowed = np.abs(i - j) <= window
    if num_global:
        allowed |= j < num_global
        allowed |= i < num_global
    indptr = np.zeros(seq + 1, dtype=np.int32)
    np.cumsum(allowed.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(allowed)[1].astype(np.int32)
    return indices, indptr


def bigbird_block_mask(seq: int, block: int = 64, window_blocks: int = 3,
                       num_global_blocks: int = 1, num_random_blocks: int = 2,
                       seed: int = 0) -> np.ndarray:
    """The BigBird block-grid mask (nb, nb): the `window_blocks`-wide block
    diagonal, the first `num_global_blocks` block rows and columns, and
    `num_random_blocks` extra blocks per block row drawn from
    `np.random.default_rng(seed)` (fixed for a whole run, so plans cache)."""
    if seq % block:
        raise ValueError(f"seq {seq} must be a multiple of block {block}")
    nb = seq // block
    bi = np.arange(nb)[:, None]
    bj = np.arange(nb)[None, :]
    allowed = np.abs(bi - bj) <= window_blocks // 2
    if num_global_blocks:
        allowed |= bj < num_global_blocks
        allowed |= bi < num_global_blocks
    if num_random_blocks and nb > window_blocks + num_global_blocks:
        rng = np.random.default_rng(seed)
        for r in range(nb):
            cand = np.flatnonzero(~allowed[r])
            if cand.size:
                pick = rng.choice(cand, size=min(num_random_blocks, cand.size), replace=False)
                allowed[r, pick] = True
    return allowed


def bigbird_pattern(seq: int, block: int = 64, window_blocks: int = 3,
                    num_global_blocks: int = 1, num_random_blocks: int = 2,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """`bigbird_block_mask` expanded to a token CSR (indices, indptr), like
    `local_global_pattern`, for `SparseSelfAttention`'s engines."""
    allowed = bigbird_block_mask(seq, block, window_blocks, num_global_blocks,
                                 num_random_blocks, seed)
    tok = np.kron(allowed, np.ones((block, block), bool))
    indptr = np.zeros(seq + 1, dtype=np.int32)
    np.cumsum(tok.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(tok)[1].astype(np.int32)
    return indices, indptr


# ----------------------------------------------------------------------------
# Routing
# ----------------------------------------------------------------------------

# The JAX package's routing model (tpusparse/nn/attention.py:98-105), kept at
# its values so that the port sends every pattern to the same engine. They
# were fitted on that package's accelerator and are not times of the
# CUDA engines; refitting them on the card is ROADMAP queue 1, item 13.
_BLOCKFLASH_TILE_S = 1.2e-6   # per head and occupied 256² tile
_SDDMM_PER_NNZ_S = 45e-9      # per pattern nonzero
_DENSE_PER_SCORE_S = 8.2e-12  # per head and score element


def route_sparse_attention(indices, indptr, seq: int, block: int = 0, head_dim: int = 64
                           ) -> Tuple[str, Optional[BlockAttnPlan], str]:
    """Pick the engine for a token-level attention pattern: 'blockflash'
    (the pattern block-ified onto a (block, block) grid, block=0 auto-picks,
    token-exact through tile masks), 'dense' (a masked dense softmax) or
    'sddmm' (per-nonzero gathers), by the JAX package's cost model. Returns
    (method, plan or None, report); the plan is returned whenever the seq
    is tileable, so a forced 'blockflash' can use it."""
    del head_dim  # part of the JAX signature; the model does not use it
    nnz = int(np.asarray(indptr)[-1])
    t_dn = seq * seq * _DENSE_PER_SCORE_S
    t_sd = nnz * _SDDMM_PER_NNZ_S
    if block <= 0:
        block = 256 if seq % 256 == 0 and seq >= 1024 else (128 if seq % 128 == 0 else 64)
    if seq % block:
        method = "dense" if t_dn < t_sd else "sddmm"
        return method, None, (
            f"{method}: seq {seq} not tileable by any block size "
            f"(dense model {t_dn * 1e3:.3f} vs sddmm model {t_sd * 1e3:.2f})"
        )
    plan = _block_attn_plan_from_tokens(_np_bytes(indices), _np_bytes(indptr), seq, block)
    tiles = plan.covered_tiles
    t_bf = tiles * _BLOCKFLASH_TILE_S * max((block / 256.0) ** 2, 0.35)
    report = (
        f"pattern nnz={nnz}, block {block}: {tiles} occupied tiles "
        f"(block density {plan.density:.3f}, padding x{plan.padding_ratio:.1f}"
        f"{', token-exact masks' if plan.tile_masks is not None else ', pure block'}) "
        f"-> model blockflash {t_bf * 1e3:.3f} vs dense {t_dn * 1e3:.3f} vs "
        f"sddmm {t_sd * 1e3:.2f}"
    )
    best = min(("blockflash", t_bf), ("dense", t_dn), ("sddmm", t_sd), key=lambda kv: kv[1])[0]
    return best, plan, report + f" -> {best}"


def _np_bytes(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x, np.int32)).tobytes()


@functools.lru_cache(maxsize=32)
def _block_attn_plan_from_tokens(ind_b: bytes, ptr_b: bytes, seq: int, block: int):
    indices = np.frombuffer(ind_b, np.int32)
    indptr = np.frombuffer(ptr_b, np.int32)
    return BlockAttnPlan.from_token_pattern(indices, indptr, seq, block, block)


@functools.lru_cache(maxsize=64)
def _block_attn_plan_cached(mask_bytes: bytes, mask_shape, block: int, seq: int):
    mask = np.frombuffer(mask_bytes, dtype=bool).reshape(mask_shape)
    return BlockAttnPlan(mask, block, block, seq)


# ----------------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------------


class _Projections(nn.Module):
    """The query, key, value and out projections of a multi-head attention
    module, created in that order from `generator`."""

    def __init__(self, num_heads: int, head_dim: int, hidden: int, device, generator):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        d = num_heads * head_dim
        kw = dict(device=device, generator=generator)
        self.query = DenseLinear(hidden, d, **kw)
        self.key = DenseLinear(hidden, d, **kw)
        self.value = DenseLinear(hidden, d, **kw)
        self.out = DenseLinear(d, hidden, **kw)

    def _qkv(self, hidden: torch.Tensor):
        """q, k, v as (b, heads, s, head_dim)."""
        b, s, _ = hidden.shape

        def split(x):
            return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        return split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))

    def _merge_out(self, ctx: torch.Tensor) -> torch.Tensor:
        """(b, heads, s, head_dim) context -> the out projection of (b, s, d)."""
        b, h, s, hd = ctx.shape
        return self.out(ctx.transpose(1, 2).reshape(b, s, h * hd))


class SelfAttention(_Projections):
    """Multi-head self-attention over (batch, seq, hidden) inputs.

    hidden is the input width (flax infers it at init); the projections map
    it to num_heads * head_dim and back.
    """

    def __init__(self, num_heads: int, head_dim: int, fused: bool = False,
                 causal: bool = False, *, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_heads, head_dim, hidden, device, generator)
        self.fused, self.causal = fused, causal

    def forward(self, hidden: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = hidden.shape[1]
        q, k, v = self._qkv(hidden)
        if self.fused:
            if mask is not None:
                raise ValueError(
                    "fused attention supports causal masking only; pass "
                    "causal=True or use the unfused path for custom masks"
                )
            ctx = flash_attention_diff(q, k, v, self.causal, None)
        else:
            scores = ops.transb_mm(q, k) / math.sqrt(self.head_dim)
            if self.causal:
                tril = torch.ones((s, s), dtype=torch.bool, device=scores.device).tril()
                scores = torch.where(tril, scores, -1e9)
            if mask is not None:
                scores = torch.where(mask, scores, -1e9)
            ctx = ops.mm(torch.softmax(scores, dim=-1), v)
        return self._merge_out(ctx)


SPARSE_METHODS = ("auto", "blockflash", "dense", "sddmm")


class SparseSelfAttention(_Projections):
    """Multi-head self-attention over a static token pattern.

    The pattern is `pattern_fn(seq)` -> (indices, indptr) when given (e.g.
    `functools.partial(bigbird_pattern, block=64)`), else
    `local_global_pattern(seq, window, num_global)`. `method` picks the
    engine: 'auto' routes through `route_sparse_attention`; 'blockflash',
    'dense' and 'sddmm' force one ('blockflash' raises on a seq that no
    block size tiles). `block` is the blockflash tile, 0 = auto-pick from
    seq. Every engine trains and matches the masked dense softmax on the
    exact token pattern.
    """

    def __init__(self, num_heads: int, head_dim: int, window: int = 64,
                 num_global: int = 0, pattern_fn: Optional[Callable] = None,
                 method: str = "auto", block: int = 0, *, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        if method not in SPARSE_METHODS:
            raise ValueError(f"unknown method {method!r} (auto/blockflash/dense/sddmm)")
        super().__init__(num_heads, head_dim, hidden, device, generator)
        self.window, self.num_global = window, num_global
        self.pattern_fn, self.method, self.block = pattern_fn, method, block
        self._engines = {}  # seq -> (method, plan, indices, indptr)
        self._masks = {}    # (seq, device) -> (s, s) bool mask of the 'dense' engine

    def engine(self, seq: int):
        """(method, plan or None, indices, indptr) for `seq`, resolved once."""
        if seq not in self._engines:
            if self.pattern_fn is not None:
                indices, indptr = self.pattern_fn(seq)
            else:
                indices, indptr = local_global_pattern(seq, self.window, self.num_global)
            method, plan = self.method, None
            if method in ("auto", "blockflash"):
                routed, plan, report = route_sparse_attention(
                    indices, indptr, seq, self.block, self.head_dim)
                if method == "auto":
                    method = routed
                elif plan is None:  # forced blockflash on an untileable seq
                    raise ValueError(report)
            self._engines[seq] = (method, plan, indices, indptr)
        return self._engines[seq]

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, _ = hidden.shape
        method, plan, indices, indptr = self.engine(s)
        q, k, v = (x.reshape(b * self.num_heads, s, self.head_dim) for x in self._qkv(hidden))
        if method == "blockflash":
            ctx = block_flash_attention_diff(q, k, v, plan)
        elif method == "dense":
            scores = ops.transb_mm(q, k) / math.sqrt(self.head_dim)
            scores = torch.where(self._dense_mask(s, indices, indptr, hidden.device), scores, -1e9)
            ctx = ops.mm(torch.softmax(scores, dim=-1), v)
        else:
            ctx = self._sddmm_attention(q, k, v, s, indices, indptr)
        return self._merge_out(ctx.reshape(b, self.num_heads, s, self.head_dim))

    def _dense_mask(self, s, indices, indptr, device) -> torch.Tensor:
        key = (s, str(device))
        if key not in self._masks:
            mask = np.zeros((s, s), bool)
            mask[np.repeat(np.arange(s), np.diff(indptr)), np.asarray(indices)] = True
            self._masks[key] = torch.from_numpy(mask).to(device)
        return self._masks[key]

    def _sddmm_attention(self, q, k, v, s, indices, indptr):
        """Per head: scores on the pattern by `ops.sddmm`, a softmax over
        each row's nonzeros, then `ops.gather_spmm` (JAX vmaps the heads)."""
        rows = torch.from_numpy(np.repeat(np.arange(s), np.diff(indptr))).to(q.device)
        pattern = CSR(q.new_zeros(len(indices)), indices, indptr, (s, s))
        scale = 1.0 / math.sqrt(self.head_dim)
        out = []
        for qh, kh, vh in zip(q, k, v):
            vals = ops.sddmm(pattern, qh, kh.transpose(0, 1)) * scale
            # the row max only shifts the exponent: its gradient cancels
            mx = vals.new_full((s,), -torch.inf).scatter_reduce(
                0, rows, vals.detach(), "amax")
            e = torch.exp(vals - mx[rows])
            z = vals.new_zeros(s).index_add(0, rows, e)
            out.append(ops.gather_spmm(CSR(e / z[rows], indices, indptr, (s, s)), vh))
        return torch.stack(out)  # (b*heads, s, head_dim)


def banded_blocks(q, k_pad, v_pad, window: int, block0_pos, s_total: int):
    """Blockwise band attention given K/V padded with a halo block at each
    end. q: (b, h, nbl, B, hd); k_pad, v_pad: (b, h, nbl + 2, B, hd), block 0
    the left halo and block nbl + 1 the right. block0_pos: global block index
    of q's first block (0 for `LocalAttention`)."""
    B = window
    nbl = q.shape[2]
    k_ext = torch.cat([k_pad[:, :, :-2], k_pad[:, :, 1:-1], k_pad[:, :, 2:]], dim=3)
    v_ext = torch.cat([v_pad[:, :, :-2], v_pad[:, :, 1:-1], v_pad[:, :, 2:]], dim=3)
    scores = dense.einsum("bhnqd,bhnkd->bhnqk", q, k_ext) / np.sqrt(q.shape[-1])
    qi = np.arange(B)[:, None]
    kj = np.arange(3 * B)[None, :]
    band = np.abs(qi - kj + B) <= B  # (B, 3B), the same for every block
    key_pos = (block0_pos + np.arange(nbl)[:, None, None] - 1) * B + kj[None]
    mask = band[None] & (key_pos >= 0) & (key_pos < s_total)
    scores = torch.where(torch.from_numpy(mask).to(scores.device), scores, -1e9)
    return dense.einsum("bhnqk,bhnkd->bhnqd", torch.softmax(scores, dim=-1), v_ext)


class LocalAttention(_Projections):
    """Banded (sliding-window) attention |i - j| <= window computed
    blockwise: each window-sized query block attends densely to its own and
    both neighbouring key blocks, masked back to the exact band. Runs on
    `dense.einsum`; no kernel of its own."""

    def __init__(self, num_heads: int, head_dim: int, window: int = 128, *, hidden: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(num_heads, head_dim, hidden, device, generator)
        self.window = window

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, _ = hidden.shape
        B = self.window
        if s % B != 0:
            raise ValueError(f"seq {s} must be a multiple of window {B}")
        nb = s // B
        q, k, v = (x.reshape(b, self.num_heads, nb, B, self.head_dim) for x in self._qkv(hidden))

        def halo_pad(x):  # a zero block at both ends: (..., nb + 2, B, hd)
            return F.pad(x, (0, 0, 0, 0, 1, 1))

        ctx = banded_blocks(q, halo_pad(k), halo_pad(v), B, 0, s)
        return self._merge_out(ctx.reshape(b, self.num_heads, s, self.head_dim))


class BigBirdAttention(_Projections):
    """Block-sparse attention (window + global + random blocks of `block`
    tokens) on the block-pattern kernels: only the pattern's kv blocks are
    read or computed, forward and backward. Numerically the dense softmax
    masked to the block pattern."""

    def __init__(self, num_heads: int, head_dim: int, block: int = 256,
                 window_blocks: int = 3, num_global_blocks: int = 1,
                 num_random_blocks: int = 2, pattern_seed: int = 0, *, hidden: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(num_heads, head_dim, hidden, device, generator)
        self.block, self.window_blocks = block, window_blocks
        self.num_global_blocks, self.num_random_blocks = num_global_blocks, num_random_blocks
        self.pattern_seed = pattern_seed
        self._plans = {}  # seq -> BlockAttnPlan

    def plan(self, seq: int) -> BlockAttnPlan:
        """The block plan for `seq`, resolved once (drawing the random blocks
        costs more host time than a forward's kernel launch)."""
        if seq not in self._plans:
            mask = bigbird_block_mask(seq, self.block, self.window_blocks,
                                      self.num_global_blocks, self.num_random_blocks,
                                      self.pattern_seed)
            self._plans[seq] = _block_attn_plan_cached(mask.tobytes(), mask.shape, self.block,
                                                       seq)
        return self._plans[seq]

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, _ = hidden.shape
        q, k, v = (x.reshape(b * self.num_heads, s, self.head_dim) for x in self._qkv(hidden))
        ctx = block_flash_attention_diff(q, k, v, self.plan(s))
        return self._merge_out(ctx.reshape(b, self.num_heads, s, self.head_dim))
