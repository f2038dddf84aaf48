"""Inspector plans for the block-ELL SpMM executor.

Counterpart of `tpusparse/plan.py:48-928`. A one-time host pass
over a CSR pattern densifies it into (block_m, block_k) blocks and pads
each row-block's block list to a fixed ELL width L. Padded slots repeat
the row-block's last valid block id, and the executor skips them. The pass
runs in the native C++ inspector (`runtime/native.py`) where a host
compiler built it, else in numpy; both give the same arrays. The plan
arrays are equal to the JAX ones at the same blocksize; plans are cached
by a content fingerprint of the pattern.

Values are not part of the plan: `pack_values` scatters the CSR value
vector into block form on the values' device, every call.

The backward of the block SpMM runs on transpose plans: `build_plan_pair`
derives the Aᵀ plan from a CSR pattern, `block_transpose_plan` from a
plan's block pattern alone.

Three layouts derive from a Plan for the other executors, each cached by a
fingerprint that includes `scatter_idx`: `compact_plan` (no ELL padding),
`group_plan` (the slots of G row-blocks as one stream) and `footprint_plan`
(S row-blocks per super-row, slots sorted by column). `save_plan` and
`load_plan` read and write the JAX package's `.npz` layout.
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


def set_roofline_constants(**kwargs):
    """Override the constants of `Plan.report()` (for another card, or the
    power limit the card is set to)."""
    _ROOFLINE.update(kwargs)


def _device_copy(cache: dict, name: str, arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """`arr` flattened (and cast to `dtype`, if given) as a tensor on
    `device`, copied there once and kept in `cache` under (name, device)."""
    key = (name, str(torch.device(device)))
    t = cache.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype).reshape(-1)).to(device)
        cache[key] = t
    return t


def _pack(plan, data: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Scatter a CSR value vector into (num_slots, bm, bk) block form
    through the plan's `scatter_idx`."""
    bm, bk = plan.blocksize
    flat = torch.zeros((num_slots * bm * bk,), dtype=data.dtype, device=data.device)
    flat[plan.index_tensor("scatter_idx", data.device)] = data
    return flat.reshape(num_slots, bm, bk)


def _unpack(plan, block_vals: torch.Tensor) -> torch.Tensor:
    """Gather the per-nonzero values back out of block form."""
    return block_vals.reshape(-1)[plan.index_tensor("scatter_idx", block_vals.device)]


def _index_tensor(plan, name: str, device) -> torch.Tensor:
    """An index array of a plan as a tensor on `device` (`scatter_idx` as
    int64, since torch indexes with int64), copied there once."""
    hit = plan._on_device.get((name, str(torch.device(device))))
    if hit is not None:
        return hit
    arr = getattr(plan, name)
    if name == "scatter_idx":
        arr = np.asarray(arr, dtype=np.int64)
    return _device_copy(plan._on_device, name, arr, device)


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

    @property
    def heaviest_first(self) -> np.ndarray:
        """(nbr,) int32: the row-blocks by slot count, most first (stable),
        the order in which the block executor starts them."""
        return np.argsort(-np.asarray(self.nslots), kind="stable").astype(np.int32)

    def index_tensor(self, name: str, device) -> torch.Tensor:
        """`block_cols` (flattened), `nslots`, `scatter_idx` or
        `heaviest_first` as a tensor on `device`, copied there once and kept
        with the plan."""
        return _index_tensor(self, name, device)

    def perm_tensor(self, name: str, perm: np.ndarray, device) -> torch.Tensor:
        """A host permutation that belongs with this plan (the `t_perm` or
        `t_slot_perm` that feeds a transpose plan) as an int64 tensor on
        `device`, copied there once and kept with the plan under `name`."""
        return _device_copy(self._on_device, name, np.asarray(perm, dtype=np.int64), device)

    # -- value packing (every call, pattern-free) ---------------------------
    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        """Scatter the CSR value vector into ELL block form (num_slots, bm, bk)."""
        return _pack(self, data, self.num_slots)

    def unpack_values(self, block_vals: torch.Tensor) -> torch.Tensor:
        """Gather the per-nonzero values back out of block form."""
        return _unpack(self, block_vals)

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


def _inspect(indptr, indices, shape, blocksize):
    """The native inspector where it is built (`runtime/native.py`), else
    the numpy one; both give the same arrays (tpusparse/plan.py:260-267)."""
    from tpusparse_torch.runtime import native

    if native.available():
        return native.inspect(indptr, indices, shape, blocksize)
    return _inspect_numpy(indptr, indices, shape, blocksize)


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

    block_cols, nslots, scatter_idx, ell_width, nblocks = _inspect(
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


# -- derived layouts ------------------------------------------------------------


def _derived_key(plan: Plan, tag: str) -> str:
    """Fingerprint of a Plan for the derived-plan caches. `scatter_idx` is
    part of it: two patterns with the same block structure but other
    positions inside the blocks must not share a value scatter
    (tpusparse/plan.py:480-486)."""
    return hashlib.sha1(
        np.asarray(plan.block_cols).tobytes()
        + np.asarray(plan.nslots).tobytes()
        + np.asarray(plan.scatter_idx).tobytes()
        + repr((plan.shape, plan.blocksize) + ((tag,) if tag else ())).encode()
    ).hexdigest()


def _remap_scatter(plan: Plan, old_slot: np.ndarray, new_slot: np.ndarray) -> np.ndarray:
    """The plan's nnz -> flat block index map, with each valid ELL slot
    `old_slot` moved to `new_slot` of the derived layout (int64)."""
    bm, bk = plan.blocksize
    o2n = np.zeros(plan.num_slots, dtype=np.int64)
    o2n[old_slot] = new_slot
    bb = bm * bk
    old = np.asarray(plan.scatter_idx, dtype=np.int64)
    return o2n[old // bb] * bb + old % bb


def _valid_slots(plan: Plan):
    """(row-block ids, ELL slot ids) of the valid slots, row-block-major."""
    ns = np.asarray(plan.nslots).astype(np.int64)
    valid = np.arange(plan.ell_width)[None, :] < ns[:, None]
    return np.nonzero(valid)


@dataclass(frozen=True)
class CompactPlan:
    """Padding-free slot layout (tpusparse/plan.py:419-476): the occupied
    blocks stored contiguously per row-block, row-block i owning the slots
    `row_base[i] .. row_base[i+1] - 1` in the base plan's ascending column
    order. Values are (nblocks, bm, bk)."""

    cols: np.ndarray  # (nblocks,) int32: col-block id per slot
    row_base: np.ndarray  # (nbr + 1,) int32: slot range per row-block
    scatter_idx: np.ndarray  # (nnz,) int64: csr nnz -> flat compact vals idx
    shape: Shape2
    blocksize: Shape2
    nnz: int
    nblocks: int
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
    def heaviest_first(self) -> np.ndarray:
        """(nbr,) int32: the row-blocks by slot count, most first (stable),
        the order in which the compact executor starts them."""
        return np.argsort(-np.diff(np.asarray(self.row_base)), kind="stable").astype(np.int32)

    def index_tensor(self, name: str, device) -> torch.Tensor:
        """`cols`, `row_base`, `scatter_idx` or `heaviest_first` as a tensor
        on `device`, copied there once and kept with the plan."""
        return _index_tensor(self, name, device)

    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        return _pack(self, data, self.nblocks)

    def unpack_values(self, block_vals: torch.Tensor) -> torch.Tensor:
        return _unpack(self, block_vals)


def compact_plan(plan: Plan) -> CompactPlan:
    """Derive the padding-free layout from an ELL Plan (host, cached)."""
    fp = _derived_key(plan, "compact")
    hit = _COMPACT_CACHE.get(fp)
    if hit is not None:
        return hit
    bc = np.asarray(plan.block_cols)
    ns = np.asarray(plan.nslots).astype(np.int64)
    L = plan.ell_width
    row_base = np.zeros(plan.num_row_blocks + 1, dtype=np.int64)
    np.cumsum(ns, out=row_base[1:])
    rb_ids, l_ids = _valid_slots(plan)
    cp = CompactPlan(
        cols=bc[rb_ids, l_ids].astype(np.int32),
        row_base=row_base.astype(np.int32),
        scatter_idx=_remap_scatter(plan, rb_ids * np.int64(L) + l_ids,
                                   row_base[rb_ids] + l_ids),
        shape=plan.shape,
        blocksize=plan.blocksize,
        nnz=plan.nnz,
        nblocks=int(ns.sum()),
    )
    _COMPACT_CACHE[fp] = cp
    return cp


_COMPACT_CACHE: Dict[str, CompactPlan] = {}


@dataclass(frozen=True)
class GroupedPlan:
    """The slots of `group_size` consecutive row-blocks concatenated into
    one stream per group (tpusparse/plan.py:531-603), ELL-padded to Lg per
    group; `local_rb` is each slot's row-block within its group. Slots keep
    row-block-major order, each row-block's in ascending column order.
    Values are (num_groups * Lg, bm, bk)."""

    block_cols: np.ndarray  # (ngroups, Lg) int32: col-block per slot
    local_rb: np.ndarray  # (ngroups, Lg) int32: row-block within group
    nslots: np.ndarray  # (ngroups,) int32: valid slots per group
    scatter_idx: np.ndarray  # (nnz,) int64: csr nnz -> flat grouped vals idx
    shape: Shape2
    blocksize: Shape2
    group_size: int
    ell_width: int  # Lg
    nnz: int
    nblocks: int
    _on_device: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def num_row_blocks(self) -> int:
        return cdiv(self.shape[0], self.blocksize[0])

    @property
    def num_groups(self) -> int:
        return cdiv(self.num_row_blocks, self.group_size)

    @property
    def num_col_blocks(self) -> int:
        return cdiv(self.shape[1], self.blocksize[1])

    @property
    def num_slots(self) -> int:
        return self.num_groups * self.ell_width

    def index_tensor(self, name: str, device) -> torch.Tensor:
        return _index_tensor(self, name, device)

    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        return _pack(self, data, self.num_slots)

    def unpack_values(self, block_vals: torch.Tensor) -> torch.Tensor:
        return _unpack(self, block_vals)


def group_plan(plan: Plan, group_size: int = 64) -> GroupedPlan:
    """Repack a row-block Plan into a GroupedPlan (host-side, cached)."""
    gkey = (_derived_key(plan, ""), group_size)
    hit = _GROUPED_CACHE.get(gkey)
    if hit is not None:
        return hit
    bc = np.asarray(plan.block_cols)
    G = group_size
    ng = cdiv(plan.num_row_blocks, G)
    rb_ids, l_ids = _valid_slots(plan)  # row-block-major order
    g_ids = rb_ids // G
    counts = np.bincount(g_ids, minlength=ng)
    Lg = int(max(counts.max(initial=0), 1))
    offsets = np.zeros(ng + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(len(g_ids), dtype=np.int64) - offsets[g_ids]
    gcols = np.zeros((ng, Lg), dtype=np.int32)
    glrb = np.zeros((ng, Lg), dtype=np.int32)
    gcols[g_ids, pos] = bc[rb_ids, l_ids]
    glrb[g_ids, pos] = (rb_ids % G).astype(np.int32)
    gp = GroupedPlan(
        block_cols=gcols,
        local_rb=glrb,
        nslots=counts.astype(np.int32),
        scatter_idx=_remap_scatter(plan, rb_ids * np.int64(plan.ell_width) + l_ids,
                                   g_ids * np.int64(Lg) + pos),
        shape=plan.shape,
        blocksize=plan.blocksize,
        group_size=G,
        ell_width=Lg,
        nnz=plan.nnz,
        nblocks=plan.nblocks,
    )
    _GROUPED_CACHE[gkey] = gp
    return gp


_GROUPED_CACHE: Dict[Tuple[str, int], GroupedPlan] = {}


@dataclass(frozen=True)
class FootprintPlan:
    """Slots of S consecutive row-blocks (a super-row) sorted by (column,
    row-block), so that each distinct B tile is fetched once per super-row
    (tpusparse/plan.py:672-773; the reference inspector's footprint
    compression). Per super, `ucols` lists the distinct col-blocks, and per
    slot `lrow` gives its row-block within the super, `bslot` the ordinal of
    its column among `ucols` and `newcol` 1 where a new column starts.
    Values are ELL-padded per super to Ls: (num_supers * Ls, bm, bk); pad
    slots are zero and never run. `ntiles` counts the distinct (super,
    column) B-tile fetches."""

    ucols: np.ndarray  # (ns, Lu) int32: distinct col-block ids per super
    ucnt: np.ndarray  # (ns,) int32: number of distinct col-blocks
    nslots: np.ndarray  # (ns,) int32: valid slots per super
    lrow: np.ndarray  # (ns, Ls) int32: row-block within super (0..S-1)
    bslot: np.ndarray  # (ns, Ls) int32: distinct-col ordinal of the slot
    newcol: np.ndarray  # (ns, Ls) int32: 1 iff slot starts a new col
    scatter_idx: np.ndarray  # (nnz,) int64: csr nnz -> flat packed vals idx
    shape: Shape2
    blocksize: Shape2
    rows_per_super: int  # S
    u_width: int  # Lu
    ell_width: int  # Ls
    nnz: int
    nblocks: int
    ntiles: int
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
    def num_supers(self) -> int:
        return cdiv(self.num_row_blocks, self.rows_per_super)

    @property
    def num_slots(self) -> int:
        return self.num_supers * self.ell_width

    def index_tensor(self, name: str, device) -> torch.Tensor:
        return _index_tensor(self, name, device)

    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        return _pack(self, data, self.num_slots)

    def unpack_values(self, block_vals: torch.Tensor) -> torch.Tensor:
        return _unpack(self, block_vals)


def footprint_plan(plan: Plan, rows_per_super: int = 16) -> FootprintPlan:
    """Derive the column-sorted super-row-block layout from an ELL Plan
    (host-side, cached)."""
    key = (_derived_key(plan, "footprint"), rows_per_super)
    hit = _FOOTPRINT_CACHE.get(key)
    if hit is not None:
        return hit
    bc = np.asarray(plan.block_cols)
    S = rows_per_super
    ns = cdiv(plan.num_row_blocks, S)
    rb_ids, l_ids = _valid_slots(plan)
    cols = bc[rb_ids, l_ids].astype(np.int64)
    s_ids = rb_ids // S

    order = np.lexsort((rb_ids, cols, s_ids))  # (super, col, row)
    srt_s, srt_c = s_ids[order], cols[order]
    nblocks = len(order)
    counts = np.bincount(srt_s, minlength=ns)
    sbase = np.zeros(ns + 1, dtype=np.int64)
    np.cumsum(counts, out=sbase[1:])
    Ls = int(max(counts.max(initial=0), 1))
    pos = np.arange(nblocks, dtype=np.int64) - sbase[srt_s]

    newcol_flat = np.ones(nblocks, dtype=np.int32)
    if nblocks > 1:
        same = (srt_s[1:] == srt_s[:-1]) & (srt_c[1:] == srt_c[:-1])
        newcol_flat[1:][same] = 0
    csum = np.cumsum(newcol_flat)
    start_csum = csum[sbase[srt_s]] if nblocks else np.zeros(0, np.int64)
    bslot_flat = (csum - start_csum).astype(np.int32)

    ucnt = np.bincount(srt_s, weights=newcol_flat, minlength=ns).astype(np.int32)
    Lu = int(max(ucnt.max(initial=0), 1))
    ucols = np.zeros((ns, Lu), dtype=np.int32)
    is_new = newcol_flat == 1
    ucols[srt_s[is_new], bslot_flat[is_new]] = srt_c[is_new].astype(np.int32)

    lrow = np.zeros((ns, Ls), dtype=np.int32)
    bslot = np.zeros((ns, Ls), dtype=np.int32)
    newcol = np.zeros((ns, Ls), dtype=np.int32)
    lrow[srt_s, pos] = (rb_ids[order] % S).astype(np.int32)
    bslot[srt_s, pos] = bslot_flat
    newcol[srt_s, pos] = newcol_flat

    fpl = FootprintPlan(
        ucols=ucols,
        ucnt=ucnt,
        nslots=counts.astype(np.int32),
        lrow=lrow,
        bslot=bslot,
        newcol=newcol,
        scatter_idx=_remap_scatter(
            plan, (rb_ids * np.int64(plan.ell_width) + l_ids)[order],
            srt_s * np.int64(Ls) + pos),
        shape=plan.shape,
        blocksize=plan.blocksize,
        rows_per_super=S,
        u_width=Lu,
        ell_width=Ls,
        nnz=plan.nnz,
        nblocks=nblocks,
        ntiles=int(newcol_flat.sum()),
    )
    _FOOTPRINT_CACHE[key] = fpl
    return fpl


_FOOTPRINT_CACHE: Dict[Tuple[str, int], FootprintPlan] = {}


# -- plan files -----------------------------------------------------------------


def save_plan(plan: Plan, path: str) -> None:
    """Persist an inspected plan in the JAX package's `.npz` layout
    (tpusparse/plan.py:889-903), so that a plan saved by one package loads
    in the other: inspect once, load in every serving job."""
    np.savez_compressed(
        path,
        block_cols=np.asarray(plan.block_cols),
        nslots=np.asarray(plan.nslots),
        scatter_idx=np.asarray(plan.scatter_idx),
        shape=np.asarray(plan.shape, dtype=np.int64),
        blocksize=np.asarray(plan.blocksize, dtype=np.int64),
        ell_width=np.asarray(plan.ell_width, dtype=np.int64),
        nnz=np.asarray(plan.nnz, dtype=np.int64),
        nblocks=np.asarray(plan.nblocks, dtype=np.int64),
    )


def load_plan(path: str) -> Plan:
    """A Plan from a `.npz` written by `save_plan` (of either package)."""
    with np.load(path) as z:
        return Plan(
            block_cols=np.ascontiguousarray(z["block_cols"]),
            nslots=np.ascontiguousarray(z["nslots"]),
            scatter_idx=np.ascontiguousarray(z["scatter_idx"]),
            shape=tuple(int(v) for v in z["shape"]),
            blocksize=tuple(int(v) for v in z["blocksize"]),
            ell_width=int(z["ell_width"]),
            nnz=int(z["nnz"]),
            nblocks=int(z["nblocks"]),
        )


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
    """Clear the base caches (plans, plan pairs, block transposes) and the
    hit counters. As in the JAX package (tpusparse/plan.py:924-928), the
    compact, grouped and footprint caches are kept: they are keyed by the
    full content of the plan they derive from, so an entry is never stale."""
    _PLAN_CACHE.clear()
    _PAIR_CACHE.clear()
    _BLOCK_T_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)
