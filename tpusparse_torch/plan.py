"""Inspector plans for the block-ELL SpMM executor.

Counterpart of `tpusparse/plan.py:48-411, 878-928`. A one-time host pass
over a CSR pattern densifies it into (block_m, block_k) blocks and pads
each row-block's block list to a fixed ELL width L. Padded slots repeat
the row-block's last valid block id, and the executor skips them. The
plan arrays are equal to the JAX ones at the same blocksize; plans are
cached by a content fingerprint of the pattern.

Values are not part of the plan: `pack_values` scatters the CSR value
vector into block form on the values' device, every call.

The backward of the block SpMM runs on transpose plans: `build_plan_pair`
derives the Aᵀ plan from a CSR pattern, `block_transpose_plan` from a
plan's block pattern alone.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpusparse_torch.types import CSR, Shape2
from tpusparse_torch.utils.config import cdiv, get_config

# Speed-of-light constants of one NVIDIA H100 SXM for the roofline
# projection in Plan.report(). Datasheet values (dense, no sparsity, at the
# 700 W power limit), not measurements.
_ROOFLINE = {
    "peak_bf16_flops": 989e12,  # tensor cores, bf16
    "peak_fp32_flops": 67e12,  # FFMA outside the tensor cores
    "hbm_bandwidth": 3.35e12,  # bytes/s
}


@dataclass(frozen=True)
class Plan:
    """A compiled sparsity-pattern plan for one (pattern, blocksize)."""

    block_cols: np.ndarray  # (nbr, L) int32: col-block id per ELL slot
    nslots: np.ndarray  # (nbr,) int32: valid slots per row-block
    scatter_idx: np.ndarray  # (nnz,) int32/int64: csr nnz -> flat block_vals idx
    shape: Shape2  # logical (m, k) of the sparse operand
    blocksize: Shape2  # (block_m, block_k)
    ell_width: int  # L
    nnz: int
    nblocks: int  # valid (non-pad) blocks
    stats: Tuple[Tuple[str, float], ...] = ()
    # device copies of the index arrays, made on first use per device
    _on_device: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def num_row_blocks(self) -> int:
        return cdiv(self.shape[0], self.blocksize[0])

    @property
    def num_col_blocks(self) -> int:
        return cdiv(self.shape[1], self.blocksize[1])

    @property
    def num_slots(self) -> int:
        return self.num_row_blocks * self.ell_width

    def _device_copy(self, name: str, arr: np.ndarray, device) -> torch.Tensor:
        key = (name, str(torch.device(device)))
        t = self._on_device.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)).to(device)
            self._on_device[key] = t
        return t

    def index_tensor(self, name: str, device) -> torch.Tensor:
        """`block_cols` (flattened), `nslots` or `scatter_idx` as a tensor on
        `device`, copied there once and kept with the plan."""
        arr = getattr(self, name)
        if name == "scatter_idx":
            arr = np.asarray(arr, dtype=np.int64)  # torch indexes with int64
        return self._device_copy(name, arr, device)

    def perm_tensor(self, name: str, perm: np.ndarray, device) -> torch.Tensor:
        """A host permutation that belongs with this plan (the `t_perm` or
        `t_slot_perm` that feeds a transpose plan) as an int64 tensor on
        `device`, copied there once and kept with the plan under `name`."""
        return self._device_copy(name, np.asarray(perm, dtype=np.int64), device)

    # -- value packing (every call, pattern-free) ---------------------------
    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        """Scatter the CSR value vector into ELL block form (num_slots, bm, bk)."""
        bm, bk = self.blocksize
        flat = torch.zeros(
            (self.num_slots * bm * bk,), dtype=data.dtype, device=data.device
        )
        flat[self.index_tensor("scatter_idx", data.device)] = data
        return flat.reshape(self.num_slots, bm, bk)

    def unpack_values(self, block_vals: torch.Tensor) -> torch.Tensor:
        """Gather the per-nonzero values back out of block form."""
        idx = self.index_tensor("scatter_idx", block_vals.device)
        return block_vals.reshape(-1)[idx]

    def slot_valid_mask(self, device="cpu") -> torch.Tensor:
        """(nbr, L) 1/0 float mask of the valid (non-pad) ELL slots."""
        slots = torch.arange(self.ell_width, device=device)[None, :]
        nslots = self.index_tensor("nslots", device)
        return (slots < nslots[:, None]).to(torch.float32)

    def blocks_to_dense(self, block_vals: torch.Tensor) -> torch.Tensor:
        """Scatter ELL blocks back to a dense (m, k) matrix. Padded slots
        repeat a valid block id, so they are masked before the scatter-add."""
        bm, bk = self.blocksize
        nbr, nbc, L = self.num_row_blocks, self.num_col_blocks, self.ell_width
        dev = block_vals.device
        blk = block_vals.reshape(nbr, L, bm, bk)
        mask = self.slot_valid_mask(dev).to(blk.dtype)
        blk = blk * mask[..., None, None]
        rows = torch.arange(nbr, device=dev)[:, None].expand(nbr, L)
        cols = self.index_tensor("block_cols", dev).reshape(nbr, L).long()
        dense4 = torch.zeros((nbr, nbc, bm, bk), dtype=blk.dtype, device=dev)
        dense4.index_put_((rows, cols), blk, accumulate=True)
        full = dense4.permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bk)
        return full[: self.shape[0], : self.shape[1]]

    # -- reporting -----------------------------------------------------------
    def report(self, n_cols: int = 256, dtype_bytes: int = 4) -> Dict[str, float]:
        """Inspector stats and a projected H100 roofline for C = A @ B, B (k, n).

        Keys are those of the JAX report. `vmem_bytes_per_step` keeps the
        reference's name; here it is the working set of one (A block, B
        tile, C tile) step.
        """
        m, k = self.shape
        bm, bk = self.blocksize
        d = dict(self.stats)
        useful_flops = 2.0 * self.nnz * n_cols
        block_flops = 2.0 * self.nblocks * bm * bk * n_cols
        # bytes: block values + gathered B tiles + C out
        bytes_moved = (
            self.nblocks * bm * bk * dtype_bytes
            + self.nblocks * bk * n_cols * dtype_bytes
            + m * n_cols * dtype_bytes
        )
        t_compute = block_flops / _ROOFLINE["peak_fp32_flops"]
        t_memory = bytes_moved / _ROOFLINE["hbm_bandwidth"]
        t_sol = max(t_compute, t_memory)
        d.update(
            density=self.nnz / float(m * k),
            nnz=float(self.nnz),
            nblocks=float(self.nblocks),
            ell_width=float(self.ell_width),
            block_fill=self.nnz / float(max(self.nblocks, 1) * bm * bk),
            ell_pad_overhead=(self.num_slots - self.nblocks)
            / float(max(self.nblocks, 1)),
            vmem_bytes_per_step=float(
                (bm * bk + bk * n_cols + bm * n_cols) * dtype_bytes
            ),
            useful_flops=useful_flops,
            block_flops=block_flops,
            bytes_moved=float(bytes_moved),
            arithmetic_intensity=block_flops / max(bytes_moved, 1),
            projected_time_s=t_sol,
            projected_gflops_effective=useful_flops / t_sol / 1e9,
            projected_nnz_per_s=self.nnz * n_cols / t_sol,
            bound="compute" if t_compute > t_memory else "memory",
        )
        return d


# ----------------------------------------------------------------------------
# Inspector (host side, numpy).
# ----------------------------------------------------------------------------


def _inspect_numpy(
    indptr: np.ndarray, indices: np.ndarray, shape: Shape2, blocksize: Shape2
):
    m, k = shape
    bm, bk = blocksize
    nbr, nbc = cdiv(m, bm), cdiv(k, bk)

    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    brow = rows // bm
    bcol = cols // bk

    keys = brow * nbc + bcol
    uniq, inv = np.unique(keys, return_inverse=True)
    ub = (uniq // nbc).astype(np.int64)
    uc = (uniq % nbc).astype(np.int64)

    counts = np.bincount(ub, minlength=nbr)
    ell_width = int(max(counts.max(initial=0), 1))
    group_start = np.zeros(nbr + 1, dtype=np.int64)
    np.cumsum(counts, out=group_start[1:])
    slot_of_uniq = np.arange(len(uniq), dtype=np.int64) - group_start[ub]

    block_cols = np.zeros((nbr, ell_width), dtype=np.int32)
    block_cols[ub, slot_of_uniq] = uc
    # Pad slots repeat the last valid block id (the reference layout; the
    # executor skips them).
    for i in range(nbr):
        c = counts[i]
        if 0 < c < ell_width:
            block_cols[i, c:] = block_cols[i, c - 1]

    slot = slot_of_uniq[inv]
    scatter_idx = (
        (brow * ell_width + slot) * (bm * bk) + (rows % bm) * bk + (cols % bk)
    )
    # keep int64 when the flat pack buffer exceeds int32
    if nbr * np.int64(ell_width) * bm * bk < 2**31:
        scatter_idx = scatter_idx.astype(np.int32)

    return block_cols, counts.astype(np.int32), scatter_idx, ell_width, len(uniq)


def build_plan(
    pattern: CSR, blocksize: Optional[Shape2] = None, use_cache: bool = True
) -> Plan:
    """Inspect a CSR pattern into a block-ELL Plan (host-side, one-time),
    cached by content fingerprint."""
    cfg = get_config()
    blocksize = blocksize or (cfg.spmm_block_m, cfg.spmm_block_k)
    indptr = np.asarray(pattern.indptr)
    indices = np.asarray(pattern.indices)
    key = _fingerprint(pattern.shape, blocksize, indptr, indices)
    if use_cache and key in _PLAN_CACHE:
        _CACHE_STATS["hits"] += 1
        return _PLAN_CACHE[key]
    _CACHE_STATS["misses"] += 1

    block_cols, nslots, scatter_idx, ell_width, nblocks = _inspect_numpy(
        indptr, indices, pattern.shape, blocksize
    )
    plan = Plan(
        block_cols=np.ascontiguousarray(block_cols),
        nslots=np.ascontiguousarray(nslots),
        scatter_idx=np.ascontiguousarray(scatter_idx),
        shape=tuple(pattern.shape),
        blocksize=tuple(blocksize),
        ell_width=ell_width,
        nnz=int(indices.shape[0]),
        nblocks=int(nblocks),
    )
    if use_cache:
        _PLAN_CACHE[key] = plan
    return plan


_PAIR_CACHE: Dict[str, tuple] = {}


def build_plan_pair(pattern: CSR, blocksize: Optional[Shape2] = None):
    """(plan for A, plan for Aᵀ, permutation mapping A.data -> Aᵀ.data).

    The transpose plan drives the dB = Aᵀ·dC backward of `tiled_spmm`;
    the pair is cached by pattern fingerprint.
    """
    plan = build_plan(pattern, blocksize)
    indptr = np.asarray(pattern.indptr)
    indices = np.asarray(pattern.indices).astype(np.int64)
    key = _fingerprint(
        pattern.shape, plan.blocksize, indptr, indices.astype(np.int32)
    )
    hit = _PAIR_CACHE.get(key)
    if hit is not None:
        return hit
    m, k = pattern.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    t_perm = np.lexsort((rows, indices))  # sort by (col, row): Aᵀ CSR order
    t_counts = np.bincount(indices, minlength=k)
    t_indptr = np.zeros(k + 1, dtype=np.int32)
    np.cumsum(t_counts, out=t_indptr[1:])
    bm, bk = plan.blocksize
    pattern_t = CSR(
        data=torch.zeros((0,)),  # the inspector reads the pattern only
        indices=rows[t_perm].astype(np.int32),
        indptr=t_indptr,
        shape=(k, m),
    )
    plan_t = build_plan(pattern_t, (bk, bm))
    out = (plan, plan_t, t_perm.astype(np.int32))
    _PAIR_CACHE[key] = out
    return out


_BLOCK_T_CACHE: Dict[str, tuple] = {}


def block_transpose_plan(plan: Plan):
    """(transpose Plan, slot permutation) derived from a Plan's block
    pattern alone, no CSR needed.

    Drives the `spmm_blocks` backward dB = Aᵀ·dC: the block at (row-block
    i, col-block j) becomes the (j, i) block of Aᵀ with its (bm, bk) tile
    transposed, so the transpose operand is the `(bk, bm)` transposes of
    the blocks gathered at `t_slot_perm`, whose pad slots point at index
    `plan.num_slots`, a zero block appended by the caller. Pad slots of
    `block_cols` here are 0 (not the last valid id as in `build_plan`),
    as in the JAX package. The returned Plan has an empty `scatter_idx`;
    executors never read it. Host-side, cached by block-pattern
    fingerprint.
    """
    nbr, nbc = plan.num_row_blocks, plan.num_col_blocks
    L = plan.ell_width
    bc = np.asarray(plan.block_cols).reshape(nbr, L)
    ns = np.asarray(plan.nslots)
    key = _fingerprint(plan.shape, plan.blocksize, ns, bc)
    hit = _BLOCK_T_CACHE.get(key)
    if hit is not None:
        return hit

    valid = np.arange(L, dtype=np.int64)[None, :] < ns[:, None]
    i_ids, l_ids = np.nonzero(valid)
    j_ids = bc[i_ids, l_ids].astype(np.int64)
    slot_ids = i_ids * L + l_ids
    order = np.lexsort((i_ids, j_ids))  # (col-block, row-block): Aᵀ order
    tj, ti, tslot = j_ids[order], i_ids[order], slot_ids[order]
    counts = np.bincount(tj, minlength=nbc)
    L_t = max(int(counts.max()) if counts.size else 1, 1)
    row_start = np.zeros(nbc, dtype=np.int64)
    np.cumsum(counts[:-1], out=row_start[1:])
    pos = np.arange(tj.size, dtype=np.int64) - np.repeat(row_start, counts)
    block_cols_t = np.zeros((nbc, L_t), np.int32)
    block_cols_t[tj, pos] = ti
    t_slot_perm = np.full((nbc * L_t,), plan.num_slots, np.int64)
    t_slot_perm[tj * L_t + pos] = tslot

    m, k = plan.shape
    bm, bk = plan.blocksize
    plan_t = Plan(
        block_cols=np.ascontiguousarray(block_cols_t),
        nslots=counts.astype(np.int32),
        scatter_idx=np.zeros((0,), np.int32),
        shape=(k, m),
        blocksize=(bk, bm),
        ell_width=L_t,
        nnz=plan.nnz,
        nblocks=plan.nblocks,
    )
    out = (plan_t, np.ascontiguousarray(t_slot_perm.astype(np.int32)))
    _BLOCK_T_CACHE[key] = out
    return out


# -- plan cache ---------------------------------------------------------------

_PLAN_CACHE: Dict[str, Plan] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def _fingerprint(shape, blocksize, indptr: np.ndarray, indices: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(repr((tuple(shape), tuple(blocksize))).encode())
    h.update(indptr.tobytes())
    h.update(indices.tobytes())
    return h.hexdigest()


def plan_cache_info() -> Dict[str, int]:
    return {"size": len(_PLAN_CACHE), **_CACHE_STATS}


def clear_plan_cache():
    _PLAN_CACHE.clear()
    _PAIR_CACHE.clear()
    _BLOCK_T_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)
