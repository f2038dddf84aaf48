"""Multi-rank SpMM: the row-partitioned and the ring-halo forms.

Counterpart of `tpusparse/parallel/spmm.py`. The sparse operand is
partitioned over one axis of the mesh, and each rank runs the block-ELL
executor (`csrc/block_ell_spmm.cu`, through `ops._block_exec`) on its own
chunk's plan:

  * `sharded_spmm`: A in row chunks, B replicated. No communication but the
    `all_gather` that assembles the global C.
  * `halo_spmm`: A in (row chunk i, column strip j) blocks, B in row strips.
    Each of the ndev steps multiplies the strip a rank holds by its A block
    while it passes the strip on around the ring (`dist.batch_isend_irecv`,
    the send and the receive in one batch), the last rotation peeled off.

Every chunk's plan is padded to one ELL width and the values enter through
one global scatter (`pack_values`), as in JAX, so the plan arrays equal
JAX's. A chunk's local plan carries its real block count (`nblocks`, the
sum of its slot counts): JAX's sets it to 0 and chooses the executor by a
VMEM budget, which has no counterpart here, so the local plan takes the
entry point that `ops._block_exec` takes for the same pattern on one card.
Both entry points launch the same kernel.

The bytes each rank sends point to point are counted (`p2p_bytes`), the
counterpart of JAX's `count_ppermute_bytes`; the `all_gather` of the
global result is not ring traffic and is not counted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpusparse_torch.ops import _block_exec
from tpusparse_torch.parallel.mesh import all_gather_rows, axis_rank, axis_size
from tpusparse_torch.plan import Plan, _inspect
from tpusparse_torch.types import CSR
from tpusparse_torch.utils.config import cdiv, get_config, round_up

_DUMMY = np.zeros((0,), np.int32)  # local plans don't carry scatter maps
_P2P = {"bytes": 0}


def p2p_bytes() -> int:
    """Bytes this rank has sent point to point since the process started."""
    return _P2P["bytes"]


def count_p2p_bytes(fn, *args) -> int:
    """Bytes this rank sends point to point during `fn(*args)`: the
    counterpart of JAX's `count_ppermute_bytes`, read from the counter
    around one call."""
    before = p2p_bytes()
    fn(*args)
    return p2p_bytes() - before


def exchange(sends, recvs, group) -> list:
    """Start one batch of point-to-point sends and receives on `group`:
    `sends`/`recvs` are (tensor, group rank) pairs. Returns the requests;
    wait on each before reading a received tensor or writing a sent one.
    The bytes sent are counted."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group) for t, r in recvs]
    _P2P["bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
    return dist.batch_isend_irecv(ops) if ops else []


def _chunk_plan_arrays(rows, cols, m_local, k_local, blocksize):
    """Inspect one chunk's (row, col) pattern; returns raw plan arrays in
    chunk-entry order plus the achieved ELL width. The inspector is
    `plan._inspect`: the native one where it is built, else
    `plan._inspect_numpy`, which JAX's takes; both give the same arrays."""
    indptr = np.zeros(m_local + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m_local), out=indptr[1:])
    return _inspect(indptr, cols, (m_local, k_local), blocksize)


def _pad_width(block_cols, scatter_idx, L0, L, blocksize):
    """Re-pad chunk plan arrays from ELL width L0 to L >= L0, the pad slots
    repeating the last column."""
    bm, bk = blocksize
    if L == L0:
        return block_cols, scatter_idx
    out = np.zeros((block_cols.shape[0], L), dtype=np.int32)
    out[:, :L0] = block_cols
    out[:, L0:] = block_cols[:, L0 - 1:L0]
    si = scatter_idx.astype(np.int64)
    brow, within = si // (L0 * bm * bk), si % (L0 * bm * bk)
    return out, brow * (L * bm * bk) + within


def _local_plan(cache, key, block_cols, nslots, shape, blocksize, ell_width) -> Plan:
    """The Plan of one chunk, built once and kept in `cache` (its index
    arrays go to a device once)."""
    plan = cache.get(key)
    if plan is None:
        plan = Plan(block_cols=np.ascontiguousarray(block_cols),
                    nslots=np.ascontiguousarray(nslots), scatter_idx=_DUMMY,
                    shape=shape, blocksize=blocksize, ell_width=ell_width, nnz=0,
                    nblocks=int(np.asarray(nslots).sum()))
        cache[key] = plan
    return plan


def _pack(cache, scatter_idx, data: torch.Tensor, shape) -> torch.Tensor:
    """Scatter the CSR values into the stacked block buffer of `shape`; the
    scatter map goes to data's device once and stays in `cache`."""
    key = ("scatter_idx", str(data.device))
    idx = cache.get(key)
    if idx is None:
        idx = cache[key] = torch.from_numpy(scatter_idx).to(data.device)
    flat = torch.zeros((int(np.prod(shape)),), dtype=data.dtype, device=data.device)
    flat[idx] = data
    return flat.reshape(shape)


@dataclass(frozen=True)
class RowShardedPlan:
    """A row-partitioned into ndev uniform chunks of rows_per_dev rows."""

    block_cols: np.ndarray  # (ndev, nbr_l, L) int32
    nslots: np.ndarray  # (ndev, nbr_l) int32
    scatter_idx: np.ndarray  # (nnz,) int64 into the full stacked buffer
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    ndev: int
    rows_per_dev: int
    ell_width: int
    # chunk plans and the scatter map's device copies, made on first use
    _cache: Dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def nbr_local(self) -> int:
        return self.rows_per_dev // self.blocksize[0]

    @property
    def slots_local(self) -> int:
        return self.nbr_local * self.ell_width

    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        """(ndev, slots_local, bm, bk) blocks on data's device, differentiable."""
        return _pack(self._cache, self.scatter_idx, data,
                     (self.ndev, self.slots_local) + self.blocksize)

    def local_plan(self, i: int) -> Plan:
        """Chunk i's plan."""
        return _local_plan(self._cache, i, self.block_cols[i], self.nslots[i],
                           (self.rows_per_dev, self.shape[1]), self.blocksize, self.ell_width)


def shard_plan_rows(
    a: CSR, ndev: int, blocksize: Optional[Tuple[int, int]] = None
) -> RowShardedPlan:
    """Inspect A into ndev row-chunk plans with a shared ELL width."""
    cfg = get_config()
    blocksize = tuple(blocksize or (cfg.spmm_block_m, cfg.spmm_block_k))
    bm, bk = blocksize
    m, k = a.shape
    rpd = round_up(cdiv(m, ndev), bm)
    nbr_l = rpd // bm

    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int32)
    rows = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))

    chunks = []
    for i in range(ndev):  # CSR order: chunk i's entries are one run
        sel = slice(indptr[min(i * rpd, m)], indptr[min((i + 1) * rpd, m)])
        bc, ns, si, w, _ = _chunk_plan_arrays(rows[sel] - i * rpd, indices[sel], rpd, k,
                                              blocksize)
        chunks.append((sel, bc, ns, si, w))

    L = max(w for *_, w in chunks)
    block_cols = np.zeros((ndev, nbr_l, L), np.int32)
    nslots = np.zeros((ndev, nbr_l), np.int32)
    gsi = np.zeros((a.nnz,), np.int64)
    slots_l = nbr_l * L
    for i, (sel, bc, ns, si, w) in enumerate(chunks):
        bc, si = _pad_width(bc, si, w, L, blocksize)
        block_cols[i], nslots[i] = bc, ns
        gsi[sel] = i * slots_l * bm * bk + si
    return RowShardedPlan(block_cols=block_cols, nslots=nslots, scatter_idx=gsi, shape=(m, k),
                          blocksize=blocksize, ndev=ndev, rows_per_dev=rpd, ell_width=L)


def _check_axis(plan_ndev: int, mesh, axis: str) -> None:
    if axis_size(mesh, axis) != plan_ndev:
        raise ValueError(f"plan for {plan_ndev} ranks, mesh axis {axis!r} has "
                         f"{axis_size(mesh, axis)}")


def sharded_spmm(
    rsp: RowShardedPlan,
    data: torch.Tensor,
    b: torch.Tensor,
    mesh,
    axis: str = "model",
    *,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C = A @ B with A row-partitioned over `axis`, B replicated; every
    rank returns the global C.

    Pass ``packed=rsp.pack_values(data)`` to skip the per-call value pack
    (the inspect-once/multiply-many callers, e.g.
    `parallel.linalg.make_sharded_matvec`, hold the blocks packed)."""
    _check_axis(rsp.ndev, mesh, axis)
    i = axis_rank(mesh, axis)
    blocks = rsp.pack_values(data) if packed is None else packed
    c = _block_exec(rsp.local_plan(i), blocks[i].contiguous(), b.contiguous())
    return all_gather_rows(c, mesh.get_group(axis))[:rsp.shape[0]]


@dataclass(frozen=True)
class HaloShardedPlan:
    """A partitioned into (row chunk i, column strip j) blocks for the ring."""

    block_cols: np.ndarray  # (ndev, ndev, nbr_l, L) int32 [i, j]
    nslots: np.ndarray  # (ndev, ndev, nbr_l) int32
    scatter_idx: np.ndarray  # (nnz,) int64
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    ndev: int
    rows_per_dev: int
    cols_per_dev: int
    ell_width: int
    # chunk plans and the scatter map's device copies, made on first use
    _cache: Dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def nbr_local(self) -> int:
        return self.rows_per_dev // self.blocksize[0]

    @property
    def slots_local(self) -> int:
        return self.nbr_local * self.ell_width

    def pack_values(self, data: torch.Tensor) -> torch.Tensor:
        """(ndev, ndev, slots_local, bm, bk) blocks on data's device."""
        return _pack(self._cache, self.scatter_idx, data,
                     (self.ndev, self.ndev, self.slots_local) + self.blocksize)

    def local_plan(self, i: int, j: int) -> Plan:
        """The plan of row chunk i's block in column strip j."""
        return _local_plan(self._cache, (i, j), self.block_cols[i, j], self.nslots[i, j],
                           (self.rows_per_dev, self.cols_per_dev), self.blocksize,
                           self.ell_width)


def shard_plan_2d(
    a: CSR, ndev: int, blocksize: Optional[Tuple[int, int]] = None
) -> HaloShardedPlan:
    """Inspect A into ndev x ndev (row chunk, column strip) plans with a
    shared ELL width."""
    cfg = get_config()
    blocksize = tuple(blocksize or (cfg.spmm_block_m, cfg.spmm_block_k))
    bm, bk = blocksize
    m, k = a.shape
    rpd = round_up(cdiv(m, ndev), bm)
    cpd = round_up(cdiv(k, ndev), bk)
    nbr_l = rpd // bm

    # int32 throughout: the passes over the entries run several times faster
    counts = np.diff(np.asarray(a.indptr, dtype=np.int64))
    cols = np.asarray(a.indices, dtype=np.int32)
    rows = np.repeat(np.arange(m, dtype=np.int32), counts)
    # the entries by chunk (i, j), each chunk's in CSR order
    chunk = np.repeat((np.arange(m, dtype=np.int32) // rpd) * ndev, counts) + cols // cpd
    # (a key of 16 bits or less sorts by radix: one pass over the entries)
    order = np.argsort(chunk.astype(np.min_scalar_type(ndev * ndev)), kind="stable")
    bounds = np.zeros(ndev * ndev + 1, np.int64)
    np.cumsum(np.bincount(chunk, minlength=ndev * ndev), out=bounds[1:])

    raw = {}
    for i in range(ndev):
        for j in range(ndev):
            sel = order[bounds[i * ndev + j]:bounds[i * ndev + j + 1]]
            bc, ns, si, w, _ = _chunk_plan_arrays(rows[sel] - i * rpd, cols[sel] - j * cpd,
                                                  rpd, cpd, blocksize)
            raw[(i, j)] = (sel, bc, ns, si, w)

    L = max(w for *_, w in raw.values())
    slots_l = nbr_l * L
    block_cols = np.zeros((ndev, ndev, nbr_l, L), np.int32)
    nslots = np.zeros((ndev, ndev, nbr_l), np.int32)
    gsi = np.zeros((a.nnz,), np.int64)
    for (i, j), (sel, bc, ns, si, w) in raw.items():
        bc, si = _pad_width(bc, si, w, L, blocksize)
        block_cols[i, j], nslots[i, j] = bc, ns
        gsi[sel] = (i * ndev + j) * slots_l * bm * bk + si
    return HaloShardedPlan(block_cols=block_cols, nslots=nslots, scatter_idx=gsi, shape=(m, k),
                           blocksize=blocksize, ndev=ndev, rows_per_dev=rpd, cols_per_dev=cpd,
                           ell_width=L)


def halo_spmm(
    hsp: HaloShardedPlan,
    data: torch.Tensor,
    b: torch.Tensor,
    mesh,
    axis: str = "model",
) -> torch.Tensor:
    """Ring SpMM: A 2-D partitioned over `axis`, B row-sharded over `axis`;
    every rank returns the global C.

    Rank i starts on B strip i (its rows of the global `b`). At step s it
    adds A[i, j] @ B[j] for the strip j = (i + s) % ndev that it holds,
    while it sends that strip to rank i - 1 and receives strip j + 1 from
    rank i + 1 (both only read the strip, so the transfer overlaps the
    product); the last rotation is peeled off. The sum is fp32, in JAX's
    order, and is cast to b's dtype at the end.
    """
    _check_axis(hsp.ndev, mesh, axis)
    m, k = hsp.shape
    n = b.shape[1]
    ndev, cpd = hsp.ndev, hsp.cols_per_dev
    group = mesh.get_group(axis)
    i = axis_rank(mesh, axis)
    kp = ndev * cpd
    if b.shape[0] != kp:
        b = torch.nn.functional.pad(b, (0, 0, 0, kp - k))
    blocks = hsp.pack_values(data)[i]
    b_cur = b[i * cpd:(i + 1) * cpd].contiguous()

    def compute(s, acc, strip):
        j = (i + s) % ndev
        return acc + _block_exec(hsp.local_plan(i, j), blocks[j].contiguous(), strip)

    acc = torch.zeros((hsp.rows_per_dev, n), dtype=torch.float32, device=b.device)
    for s in range(ndev - 1):
        nxt = torch.empty_like(b_cur)
        reqs = exchange([(b_cur, (i - 1) % ndev)], [(nxt, (i + 1) % ndev)], group)
        acc = compute(s, acc, b_cur)
        for req in reqs:
            req.wait()
        b_cur = nxt
    acc = compute(ndev - 1, acc, b_cur)
    return all_gather_rows(acc.to(b.dtype), group)[:m]
