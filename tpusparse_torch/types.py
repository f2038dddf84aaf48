"""Sparse containers (COO / CSR) for the PyTorch port.

Counterpart of `tpusparse/types.py` (`COO` l.44-106, `CSR` l.109-305,
`coo_to_csr`/`csr_to_coo` l.419-455, `random_csr` l.542, `spmm_reference`
l.586-645, `sddmm_reference` l.646-660). Plain dataclasses: the values are a torch tensor on the
caller's device, the index arrays stay host numpy int32, as the JAX plans
keep them, because the inspector (`plan.py`) runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tpusparse_torch.utils.config import resolve_device

Shape2 = Tuple[int, int]


def _static_shape(shape) -> Shape2:
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"sparse containers are 2-D, got shape {shape}")
    return shape


def _host(mat) -> np.ndarray:
    if isinstance(mat, torch.Tensor):
        return mat.detach().cpu().numpy()
    return np.asarray(mat)


@dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix: data (nnz,) tensor, row/col (nnz,)
    host int32 arrays."""

    data: torch.Tensor
    row: np.ndarray
    col: np.ndarray
    shape: Shape2

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @classmethod
    def from_dense(cls, mat, device=None) -> "COO":
        """Host-side conversion in row-major order, values on `device`."""
        mat = _host(mat)
        shape = _static_shape(mat.shape)
        row, col = np.nonzero(mat)
        return cls(
            data=torch.as_tensor(mat[row, col]).to(resolve_device(device)),
            row=row.astype(np.int32),
            col=col.astype(np.int32),
            shape=shape,
        )

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.data.device)
        idx = (
            torch.from_numpy(self.row.astype(np.int64)).to(self.data.device),
            torch.from_numpy(self.col.astype(np.int64)).to(self.data.device),
        )
        return out.index_put_(idx, self.data, accumulate=True)


@dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix: data (nnz,) tensor, indices (nnz,) and
    indptr (nrows+1,) host int32 arrays."""

    data: torch.Tensor
    indices: np.ndarray
    indptr: np.ndarray
    shape: Shape2

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @classmethod
    def from_dense(cls, mat, device=None) -> "CSR":
        return coo_to_csr(COO.from_dense(mat, device=device))

    @classmethod
    def from_scipy(cls, sp, device=None) -> "CSR":
        sp = sp.tocsr()
        return cls(
            data=torch.as_tensor(np.asarray(sp.data)).to(resolve_device(device)),
            indices=np.asarray(sp.indices, dtype=np.int32),
            indptr=np.asarray(sp.indptr, dtype=np.int32),
            shape=_static_shape(sp.shape),
        )

    def to_scipy(self):
        import scipy.sparse as ssp

        return ssp.csr_matrix(
            (_host(self.data), self.indices, self.indptr), shape=self.shape
        )

    def row_ids(self) -> np.ndarray:
        """Per-nonzero row id (host int32)."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr)
        )

    def to_dense(self) -> torch.Tensor:
        return csr_to_coo(self).to_dense()


def coo_to_csr(a: COO) -> CSR:
    """COO -> CSR by a stable host sort on the row ids (the reference's
    counting sort, generalised to unsorted input)."""
    order = np.argsort(a.row, kind="stable")
    counts = np.bincount(a.row, minlength=a.shape[0])
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        data=a.data[torch.from_numpy(order).to(a.data.device)],
        indices=a.col[order].astype(np.int32),
        indptr=indptr,
        shape=a.shape,
    )


def csr_to_coo(a: CSR) -> COO:
    return COO(data=a.data, row=a.row_ids(), col=a.indices, shape=a.shape)


def random_csr(
    seed: int, shape: Shape2, density: float, dtype=torch.float32, device=None
) -> CSR:
    """Uniformly random pattern with exact nnz and U(0, 1) values, both from
    numpy's generator at `seed` (the JAX fixture draws its values from
    jax.random, so the two packages give different values for one seed)."""
    m, n = _static_shape(shape)
    nnz = max(1, int(round(density * m * n)))
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=nnz, replace=False)
    flat.sort()
    rows = flat // n
    indptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    data = torch.from_numpy(rng.random(nnz, dtype=np.float32))
    return CSR(
        data=data.to(device=resolve_device(device), dtype=dtype),
        indices=(flat % n).astype(np.int32),
        indptr=indptr,
        shape=(m, n),
    )


def spmm_reference(a: CSR, b: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Gather/segment-sum SpMM, C[i,:] = sum_{j in row i} A[i,j] * B[j,:].

    The plain oracle of the port, on the device of its inputs. Only
    reduce='sum' is ported; the reducer modes come with the naive-SpMM
    item of ROADMAP queue 1 (item 5).
    """
    if reduce != "sum":
        raise NotImplementedError(
            f"spmm_reference reduce={reduce!r}: only 'sum' is ported; the "
            "reducer modes come with naive_spmm (ROADMAP queue 1, item 5)"
        )
    if b.ndim != 2:
        raise ValueError(f"spmm_reference expects 2-D b, got {tuple(b.shape)}")
    dev = b.device
    rows = torch.from_numpy(a.row_ids().astype(np.int64)).to(dev)
    cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)
    gathered = b[cols] * a.data.to(dev)[:, None]
    out = torch.zeros(
        (a.shape[0], b.shape[1]), dtype=gathered.dtype, device=dev
    )
    return out.index_add_(0, rows, gathered)


def sddmm_reference(a_pattern: CSR, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: out[t] = (X @ Y)[row_t, col_t] for each
    nonzero t of the pattern, in CSR order. The plain oracle of the SDDMM
    kernel, on the device of its inputs; a_pattern's values are not read."""
    dev = x.device
    rows = torch.from_numpy(a_pattern.row_ids().astype(np.int64)).to(dev)
    cols = torch.from_numpy(a_pattern.indices.astype(np.int64)).to(dev)
    return (x[rows] * y[:, cols].transpose(0, 1)).sum(dim=1)
