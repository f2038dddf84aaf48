"""Sharded banded (DIA) matvec: the stencil's halo exchange.

Counterpart of `tpusparse/parallel/dia.py:33-110`. A banded operator
row-partitioned over the mesh needs only its neighbours' boundary rows of
x, at most `bandwidth` of them: each rank sends its first `hi` rows to rank
- 1 and its last `lo` rows to rank + 1, in one batch of point-to-point
operations. The ranks at the two ends receive zeros (no wrap-around),
which is the structural-zero boundary of `ops.dia_spmm`'s padding. JAX
runs the per-diagonal multiply-adds outside any Pallas kernel, so they are
plain torch here, in JAX's order; the global product comes back through an
`all_gather`, as JAX's matvec returns a global array.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpusparse_torch import linalg
from tpusparse_torch.parallel.mesh import all_gather_rows, axis_rank, axis_size
from tpusparse_torch.parallel.spmm import exchange
from tpusparse_torch.types import DIA

__all__ = ["make_sharded_dia_matvec", "sharded_dia_cg"]


def make_sharded_dia_matvec(a: DIA, mesh, axis: str = "model") -> Callable:
    """v ↦ A·v with A and v row-partitioned over `axis`.

    Takes and returns global tensors ((n,) or (n, k)); this rank computes
    its rows from its own rows of v and its neighbours' boundary strips.
    Square A with bandwidth at most the rows per rank (one-neighbour
    halo)."""
    m, k = a.shape
    if m != k:
        raise ValueError(f"sharded dia matvec needs square A, got {a.shape}")
    ndev = axis_size(mesh, axis)
    rank = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    rpd = -(-m // ndev)
    n_pad = rpd * ndev
    offsets = a.offsets
    lo = int(max(0, -offsets.min(initial=0)))
    hi = int(max(0, offsets.max(initial=0)))
    if max(lo, hi) > rpd:
        raise ValueError(
            f"bandwidth {max(lo, hi)} exceeds rows-per-device {rpd}; "
            "use fewer devices or the CSR row-sharded matvec")
    # this rank's slab of the diagonals, the rows past m zero
    data = torch.nn.functional.pad(a.data, (0, n_pad - m))[:, rank * rpd:(rank + 1) * rpd]

    def mv(v: torch.Tensor) -> torch.Tensor:
        vv = v if v.ndim == 2 else v[:, None]
        if vv.shape[0] != m:
            raise ValueError(f"matvec expects length-{m} vectors, got {tuple(v.shape)}")
        xl = torch.nn.functional.pad(vv, (0, 0, 0, n_pad - m))[rank * rpd:(rank + 1) * rpd]
        left = xl.new_zeros((lo, vv.shape[1]))
        right = xl.new_zeros((hi, vv.shape[1]))
        sends, recvs = [], []
        if lo and rank + 1 < ndev:
            sends.append((xl[rpd - lo:].contiguous(), rank + 1))
        if lo and rank > 0:
            recvs.append((left, rank - 1))
        if hi and rank > 0:
            sends.append((xl[:hi].contiguous(), rank - 1))
        if hi and rank + 1 < ndev:
            recvs.append((right, rank + 1))
        for req in exchange(sends, recvs, group):
            req.wait()
        xp = torch.cat([left, xl, right])
        acc = torch.zeros_like(xl)
        for d, off in enumerate(offsets):
            s = lo + int(off)
            acc = acc + data[d][:, None] * xp[s:s + rpd]
        out = all_gather_rows(acc, group)[:m]
        return out if v.ndim == 2 else out[:, 0]

    return mv


def sharded_dia_cg(a: DIA, b: torch.Tensor, mesh, *, axis: str = "model", x0=None,
                   tol: float = 1e-5, atol: float = 0.0, maxiter=None, M=None):
    """Conjugate gradient for SPD banded A with the halo-exchange matvec
    sharded over the mesh. Returns (x, info) like `linalg.cg`."""
    mv = make_sharded_dia_matvec(a, mesh, axis)
    return linalg.cg(mv, b, x0=x0, tol=tol, atol=atol, maxiter=maxiter, M=M)
