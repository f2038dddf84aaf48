"""Scaling projection of the sharded SpMM paths to more cards.

Counterpart of `tpusparse/parallel/projection.py`. One H100 cannot measure
a multi-card run, so the projection states what one would take:

  * the compute side is the router's cost model (`ops._route_spmm`'s
    max(bytes, per-slot) form, on `ops.get_cost_constants` of A's device:
    the card's fit where `calibrate()` has run on it, JAX's constants
    otherwise), applied to each rank's real plan arrays (real ELL widths and
    padding), so load imbalance shows. The model keeps JAX's resident/ELL
    split at JAX's VMEM budget, so that given the same constants the rows
    equal JAX's;
  * the communication side counts the bytes the ring sends
    (`halo_comm_bytes_per_dev`; `sharded_spmm` sends none) at an
    interconnect rate, by default `NVLINK_BW`. `count_p2p_bytes` reads what
    a real call sends, so a test pins the model to the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from tpusparse_torch import ops
from tpusparse_torch.parallel.spmm import shard_plan_2d, shard_plan_rows
from tpusparse_torch.types import CSR

__all__ = [
    "ScalingProjection",
    "project_sharded_spmm",
    "project_halo_spmm",
    "projection_table",
    "halo_comm_bytes_per_dev",
    "NVLINK_BW",
]

# NVIDIA's specification of the H100 SXM's NVLink 4: 900 GB/s in all,
# 450 GB/s each way. A data-sheet figure, not a measurement: one card
# cannot measure its links.
NVLINK_BW = 450e9


@dataclass(frozen=True)
class ScalingProjection:
    ndev: int
    t_compute_s: float       # critical-path (max-over-ranks) kernel time
    t_comm_s: float          # serialized ring time on the same path
    t_total_s: float         # max(compute, comm) per overlapped step, summed
    comm_bytes_per_dev: int  # bytes each rank sends through the ring
    efficiency: float        # t(1 rank) / (ndev * t_total)

    def row(self) -> str:
        return (
            f"{self.ndev:>4d}  {self.t_compute_s*1e3:9.3f}  "
            f"{self.t_comm_s*1e3:8.3f}  {self.t_total_s*1e3:8.3f}  "
            f"{self.comm_bytes_per_dev/1e6:9.2f}  {self.efficiency*100:6.1f}%"
        )


def _chunk_time(nslots_sum: int, nbr: int, L: int, bm: int, bk: int,
                n: int, c: dict, kp: int = 0) -> float:
    """Projected executor time of one rank's chunk: the router's model on
    the chunk's real slot counts, with JAX's resident-panel traffic where
    the chunk's padded K extent `kp` fits JAX's VMEM budget."""
    ntile = max(n // 512, 1)
    bn = min(512, n)
    resident = (
        kp > 0
        and kp * bn * 4 + 2 * L * bm * bk * 4 + 2 * bm * bn * 4
        <= ops._TPU_VMEM_LIMIT_BYTES
    )
    if resident:
        bytes_moved = (
            kp * bn * 4.0 * ntile            # panel per n-tile
            + nslots_sum * bm * bk * 4.0     # values once
            + 2.0 * nbr * bm * n * 4.0       # C read+write
        )
    else:
        bytes_moved = (
            nslots_sum * (bk * bn + bm * bk) * 4.0
        ) * ntile + 2.0 * nbr * bm * n * 4.0
    return max(
        bytes_moved / c["tiled_bw"],
        nslots_sum * c["tiled_slot_overhead"] * ntile,
    )


def _single_dev_time(a: CSR, n: int, blocksize, c: dict) -> float:
    """Reference point: the whole matrix on one rank, same model."""
    rsp1 = shard_plan_rows(a, 1, blocksize)
    ns = int(rsp1.nslots.sum())
    kp = -(-a.shape[1] // rsp1.blocksize[1]) * rsp1.blocksize[1]
    return _chunk_time(ns, rsp1.nbr_local, rsp1.ell_width, *rsp1.blocksize, n, c, kp=kp)


def project_sharded_spmm(
    a: CSR,
    n: int,
    ndevs: Sequence[int] = (2, 4, 8),
    blocksize: Optional[Tuple[int, int]] = None,
) -> List[ScalingProjection]:
    """Projection of `sharded_spmm` (A row-sharded, B replicated): no ring
    traffic; the efficiency is bounded by the row chunks' load imbalance."""
    c = ops.get_cost_constants(a.data.device)
    t1 = _single_dev_time(a, n, blocksize, c)
    out = []
    for ndev in ndevs:
        rsp = shard_plan_rows(a, ndev, blocksize)
        bm, bk = rsp.blocksize
        kp = -(-a.shape[1] // bk) * bk  # B replicated: full-k panel
        t_max = max(
            _chunk_time(int(rsp.nslots[i].sum()), rsp.nbr_local, rsp.ell_width,
                        bm, bk, n, c, kp=kp)
            for i in range(ndev)
        )
        out.append(ScalingProjection(ndev=ndev, t_compute_s=t_max, t_comm_s=0.0,
                                     t_total_s=t_max, comm_bytes_per_dev=0,
                                     efficiency=t1 / (ndev * t_max)))
    return out


def halo_comm_bytes_per_dev(hsp, n: int, dtype_bytes: int = 4) -> int:
    """Bytes each rank sends through the ring in one `halo_spmm` call:
    (ndev - 1) hops of its (cols_per_dev, n) B strip (the last rotation is
    peeled off)."""
    return (hsp.ndev - 1) * hsp.cols_per_dev * n * dtype_bytes


def project_halo_spmm(
    a: CSR,
    n: int,
    ndevs: Sequence[int] = (2, 4, 8),
    blocksize: Optional[Tuple[int, int]] = None,
    link_bw: float = NVLINK_BW,
) -> List[ScalingProjection]:
    """Projection of `halo_spmm` (A 2-D partitioned, B ring-rotated).

    Each step overlaps one chunk product with one strip rotation, so the
    step takes max(compute, strip / link_bw); the critical path sums the
    slowest rank's steps."""
    c = ops.get_cost_constants(a.data.device)
    t1 = _single_dev_time(a, n, blocksize, c)
    out = []
    for ndev in ndevs:
        hsp = shard_plan_2d(a, ndev, blocksize)
        bm, bk = hsp.blocksize
        strip_t = hsp.cols_per_dev * n * 4.0 / link_bw
        t_total = 0.0
        t_compute = 0.0
        for s in range(ndev):
            # step s: rank i multiplies chunk (i, (i+s) % ndev)
            step_compute = max(
                _chunk_time(int(hsp.nslots[i, (i + s) % ndev].sum()), hsp.nbr_local,
                            hsp.ell_width, bm, bk, n, c, kp=hsp.cols_per_dev)
                for i in range(ndev)
            )
            t_compute += step_compute
            # the last step has no rotation (peeled)
            t_total += max(step_compute, strip_t if s < ndev - 1 else 0.0)
        out.append(ScalingProjection(ndev=ndev, t_compute_s=t_compute,
                                     t_comm_s=(ndev - 1) * strip_t, t_total_s=t_total,
                                     comm_bytes_per_dev=halo_comm_bytes_per_dev(hsp, n),
                                     efficiency=t1 / (ndev * t_total)))
    return out


def projection_table(projs: List[ScalingProjection], title: str) -> str:
    head = f"{title}\nndev  compute_ms   comm_ms  total_ms   MB/dev   eff\n"
    return head + "\n".join(p.row() for p in projs)
