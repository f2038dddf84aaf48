"""Krylov solvers over a row-sharded matvec.

Counterpart of `tpusparse/parallel/linalg.py:30-104`. The operator is
row-partitioned once (`shard_plan_rows`), its values packed once, and every
matvec is a `sharded_spmm`: each rank multiplies its row chunk on the block
executor and the `all_gather` hands every rank the whole product, so the
Krylov loop's dots and axpys run alike on every rank. The loop is the
port's own `linalg.cg`, and the power iteration draws its start vector as
`linalg.power_iteration` does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpusparse_torch import linalg
from tpusparse_torch.parallel.mesh import axis_size
from tpusparse_torch.parallel.spmm import RowShardedPlan, shard_plan_rows, sharded_spmm
from tpusparse_torch.types import CSR

__all__ = ["make_sharded_matvec", "sharded_cg", "sharded_power_iteration"]


def make_sharded_matvec(rsp: RowShardedPlan, data: torch.Tensor, mesh,
                        axis: str = "model") -> Callable:
    """v ↦ A·v with A row-partitioned over `axis`, v replicated.

    The values are packed into the per-rank slot buffers once, when the
    closure is built; takes (n,) or (n, k) v. Square A only (the Krylov
    use case)."""
    m, k = rsp.shape
    if m != k:
        raise ValueError(f"sharded matvec needs square A, got {rsp.shape}")
    blocks = rsp.pack_values(data)

    def mv(v: torch.Tensor) -> torch.Tensor:
        vv = v if v.ndim == 2 else v[:, None]
        if vv.shape[0] != k:
            raise ValueError(f"matvec expects length-{k} vectors, got {tuple(v.shape)}")
        out = sharded_spmm(rsp, data, vv, mesh, axis, packed=blocks)
        return out if v.ndim == 2 else out[:, 0]

    return mv


def sharded_cg(
    a: CSR,
    b: torch.Tensor,
    mesh,
    *,
    axis: str = "model",
    blocksize: Optional[Tuple[int, int]] = None,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-5,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable] = None,
):
    """Conjugate gradient for SPD A with the matvec sharded over the mesh.
    Returns (x, info) like `linalg.cg`; `M`, if given, is a preconditioner
    that every rank applies whole (e.g. `jacobi_preconditioner`)."""
    rsp = shard_plan_rows(a, axis_size(mesh, axis), blocksize=blocksize)
    mv = make_sharded_matvec(rsp, a.data, mesh, axis)
    return linalg.cg(mv, b, x0=x0, tol=tol, atol=atol, maxiter=maxiter, M=M)


def sharded_power_iteration(
    a: CSR,
    mesh,
    *,
    axis: str = "model",
    blocksize: Optional[Tuple[int, int]] = None,
    iters: int = 100,
    seed: int = 0,
):
    """Dominant eigenpair with the matvec sharded over the mesh. Returns
    (eigenvalue, unit eigenvector), like `linalg.power_iteration`."""
    rsp = shard_plan_rows(a, axis_size(mesh, axis), blocksize=blocksize)
    mv = make_sharded_matvec(rsp, a.data, mesh, axis)
    v = linalg._normal(seed, (a.shape[0],), a.dtype, a.data.device)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = mv(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return linalg._vdot(v, mv(v)), v
