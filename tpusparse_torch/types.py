"""Sparse containers (COO / CSR / BSR) for the PyTorch port.

Counterpart of `tpusparse/types.py` (`COO` l.44-106, `CSR` l.109-305, `BSR`
l.307-389, `coo_to_csr`/`csr_to_coo` l.419-455, `csr_to_bsr`/`bsr_to_csr`
l.456-513, `random_coo`/`random_csr`/`random_powerlaw_csr` l.516-585,
`spmm_reference` l.586-645, `sddmm_reference` l.646-660, `DIA` l.663-851,
`csr_to_dia`/`dia_to_csr` l.854-906), with CSR's
operators (l.230-281): `@` (`spmm` for a dense operand, `spgemm` for a
CSR), `+`, `-` and `*` (`sp_add`, `sp_sub`, `sp_hadamard` for a CSR; a
scalar scales) and negation. Plain dataclasses: the values are a torch
tensor on the caller's device, the index arrays stay host numpy int32, as the JAX plans
keep them, because the inspector (`plan.py`) runs on the host. DIA keeps
its offsets as host int64, sorted and unique; where JAX branches on traced
values (a device scatter or gather), the port takes the autograd-preserving
torch op (an index-put into the plane, a gather out of it).
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
    """`mat` as a host numpy array for a host pass. numpy has no bf16, so a
    bf16 tensor is widened to fp32, which is exact; `_back` casts a result
    back."""
    if isinstance(mat, torch.Tensor):
        mat = mat.detach().cpu()
        return (mat.float() if mat.dtype == torch.bfloat16 else mat).numpy()
    return np.asarray(mat)


def _back(arr: np.ndarray, like, device) -> torch.Tensor:
    """The host result `arr` as a tensor on `device`, in the dtype of `like`
    where that is a tensor (undoing `_host`'s bf16 widening)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(like, torch.Tensor):
        t = t.to(like.dtype)
    return t.to(device)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of `t`'s values as a numpy array handed to numpy's users
    (scipy, flax trees). A bf16 tensor comes out in `ml_dtypes.bfloat16`,
    the numpy bf16 type that JAX hands out, where that module is
    installed."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        import ml_dtypes
    except ImportError as e:
        raise TypeError("a bf16 tensor as a numpy array needs the ml_dtypes module") from e
    return t.float().numpy().astype(ml_dtypes.bfloat16)


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

    @property
    def density(self) -> float:
        return self.nnz / float(self.shape[0] * self.shape[1])

    @classmethod
    def from_dense(cls, mat, device=None) -> "COO":
        """Host-side conversion in row-major order, values on `device`."""
        src, mat = mat, _host(mat)
        shape = _static_shape(mat.shape)
        row, col = np.nonzero(mat)
        return cls(
            data=_back(mat[row, col], src, resolve_device(device)),
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

    def transpose(self) -> "COO":
        return COO(data=self.data, row=self.col, col=self.row,
                   shape=(self.shape[1], self.shape[0]))

    @property
    def T(self) -> "COO":
        return self.transpose()


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

    @property
    def density(self) -> float:
        return self.nnz / float(self.shape[0] * self.shape[1])

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
            (host_numpy(self.data), self.indices, self.indptr), shape=self.shape
        )

    def row_ids(self) -> np.ndarray:
        """Per-nonzero row id (host int32)."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr)
        )

    def to_dense(self) -> torch.Tensor:
        return csr_to_coo(self).to_dense()

    # -- operator sugar over the op surface (lazy imports: ops imports types);
    # numpy defers mixed expressions to the reflected methods
    __array_priority__ = 1000

    def __matmul__(self, other):
        from tpusparse_torch import ops
        from tpusparse_torch.spgemm import spgemm

        if isinstance(other, CSR):
            return spgemm(self, other)
        return ops.spmm(self, torch.as_tensor(other))

    def __rmatmul__(self, x):
        from tpusparse_torch import ops

        return ops.dsmm(torch.as_tensor(x), self)

    def __add__(self, other):
        from tpusparse_torch.elementwise import sp_add

        if not isinstance(other, CSR):
            return NotImplemented
        return sp_add(self, other)

    def __sub__(self, other):
        from tpusparse_torch.elementwise import sp_sub

        if not isinstance(other, CSR):
            return NotImplemented
        return sp_sub(self, other)

    def _scale_or_raise(self, other):
        from tpusparse_torch.elementwise import sp_scale

        if np.ndim(other) != 0:  # broadcasting would silently densify
            raise TypeError(
                "CSR * array is not supported (would densify); use "
                "sp_hadamard for sparse*sparse or scale by a scalar"
            )
        return sp_scale(self, other)

    def __mul__(self, other):
        from tpusparse_torch.elementwise import sp_hadamard

        if isinstance(other, CSR):
            return sp_hadamard(self, other)
        return self._scale_or_raise(other)

    def __rmul__(self, other):
        return self._scale_or_raise(other)

    def __neg__(self):
        from tpusparse_torch.elementwise import sp_scale

        return sp_scale(self, -1.0)

    def transpose(self) -> "CSR":
        """Aᵀ by a stable host sort on the column ids (`ops.transpose_csr`,
        which caches the permutation per pattern); values gathered on their
        device."""
        from tpusparse_torch import ops

        return ops.transpose_csr(self)

    @property
    def T(self) -> "CSR":
        return self.transpose()


@dataclass(frozen=True)
class BSR:
    """Block-compressed-sparse-row matrix: data (nblocks, bm, bk) tensor of
    dense blocks, indices (nblocks,) host int32 block-column ids, indptr
    (nrow_blocks+1,) host int32; shape is the logical (pre-padding) shape.
    Rows and columns are conceptually zero-padded up to block multiples;
    `to_dense` strips the padding."""

    data: torch.Tensor
    indices: np.ndarray
    indptr: np.ndarray
    shape: Shape2
    blocksize: Shape2

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        """Stored entries (counts the zero fill inside blocks)."""
        bm, bk = self.blocksize
        return self.nblocks * bm * bk

    def row_block_ids(self) -> np.ndarray:
        """Per-block row-block id (host int32)."""
        nbr = self.indptr.shape[0] - 1
        return np.repeat(np.arange(nbr, dtype=np.int32), np.diff(self.indptr))

    def to_dense(self) -> torch.Tensor:
        bm, bk = self.blocksize
        nbr = self.indptr.shape[0] - 1
        nbc = -(-self.shape[1] // bk)
        dev = self.data.device
        padded = torch.zeros((nbr, nbc, bm, bk), dtype=self.dtype, device=dev)
        idx = (torch.from_numpy(self.row_block_ids().astype(np.int64)).to(dev),
               torch.from_numpy(self.indices.astype(np.int64)).to(dev))
        padded.index_put_(idx, self.data, accumulate=True)
        full = padded.permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bk)
        return full[: self.shape[0], : self.shape[1]]

    @classmethod
    def from_dense(cls, mat, blocksize: Shape2, device=None) -> "BSR":
        """Host-side conversion keeping only the blocks with any nonzero."""
        return csr_to_bsr(CSR.from_dense(mat, device=device), blocksize)


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


def csr_to_bsr(a: CSR, blocksize: Shape2) -> BSR:
    """Host-side CSR -> BSR by a direct pass over the pattern (no dense
    round trip); the blocks come out in (row-block, block-column) order,
    values on the CSR's device."""
    bm, bk = blocksize
    m, k = a.shape
    data = _host(a.data)
    nbr, nbc = -(-m // bm), -(-k // bk)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
    indices = np.asarray(a.indices, dtype=np.int64)
    key = (rows // bm) * nbc + (indices // bk)
    ukeys, block_of = np.unique(key, return_inverse=True)
    bdata = np.zeros((ukeys.size, bm, bk), dtype=data.dtype)
    np.add.at(bdata, (block_of, rows % bm, indices % bk), data)
    indptr = np.zeros(nbr + 1, dtype=np.int32)
    np.cumsum(np.bincount(ukeys // nbc, minlength=nbr), out=indptr[1:])
    return BSR(
        data=_back(bdata, a.data, a.data.device),
        indices=(ukeys % nbc).astype(np.int32),
        indptr=indptr,
        shape=a.shape,
        blocksize=(bm, bk),
    )


def bsr_to_csr(a: BSR) -> CSR:
    """Host-side BSR -> CSR by a direct pass over the blocks; explicit zeros
    inside blocks and the block padding are dropped."""
    bm, bk = a.blocksize
    m, k = a.shape
    bdata = _host(a.data)
    bcols = np.asarray(a.indices, dtype=np.int64)
    brows = a.row_block_ids().astype(np.int64)
    nz_blk, nz_r, nz_c = np.nonzero(bdata)
    rows = brows[nz_blk] * bm + nz_r
    cols = bcols[nz_blk] * bk + nz_c
    vals = bdata[nz_blk, nz_r, nz_c]
    keep = (rows < m) & (cols < k)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((cols, rows))
    indptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    return CSR(
        data=_back(vals[order], a.data, a.data.device),
        indices=cols[order].astype(np.int32),
        indptr=indptr,
        shape=a.shape,
    )


def random_coo(
    seed: int, shape: Shape2, density: float, dtype=torch.float32, device=None
) -> COO:
    """Uniformly random pattern with exact nnz (choice without replacement),
    row-major, and U(0, 1) values, both from numpy's generator at `seed`
    (the JAX fixture draws its pattern seed and its values from jax.random,
    so the two packages give different matrices for one seed)."""
    m, n = _static_shape(shape)
    nnz = max(1, int(round(density * m * n)))
    rng = np.random.default_rng(seed)
    flat = rng.choice(m * n, size=nnz, replace=False)
    flat.sort()
    data = torch.from_numpy(rng.random(nnz, dtype=np.float32))
    return COO(
        data=data.to(device=resolve_device(device), dtype=dtype),
        row=(flat // n).astype(np.int32),
        col=(flat % n).astype(np.int32),
        shape=(m, n),
    )


def random_csr(
    seed: int, shape: Shape2, density: float, dtype=torch.float32, device=None
) -> CSR:
    """`random_coo` as a CSR."""
    return coo_to_csr(random_coo(seed, shape, density, dtype=dtype, device=device))


def random_powerlaw_csr(
    seed: int, shape: Shape2, avg_nnz_per_row: float, alpha: float = 1.5,
    dtype=torch.float32, device=None,
) -> CSR:
    """Skewed pattern with Zipf-distributed row degrees: row i's degree is
    proportional to (i+1)^-alpha, shuffled, scaled to the requested mean,
    at least 1 and capped at n; columns uniform without replacement per row;
    U(0, 1) values. All from numpy's generator at `seed`, as in the JAX
    package for an int seed, so the two give the same matrix."""
    m, n = _static_shape(shape)
    rng = np.random.default_rng(int(seed))
    raw = np.arange(1, m + 1, dtype=np.float64) ** (-alpha)
    rng.shuffle(raw)
    deg = np.maximum(1, np.round(raw * (avg_nnz_per_row * m / raw.sum()))).astype(np.int64)
    deg = np.minimum(deg, n)
    indptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(deg, out=indptr[1:])
    indices = np.concatenate(
        [np.sort(rng.choice(n, size=int(d), replace=False)) for d in deg]).astype(np.int32)
    data = torch.from_numpy(rng.random(int(indptr[-1])).astype(np.float32))
    return CSR(data=data.to(device=resolve_device(device), dtype=dtype), indices=indices,
               indptr=indptr, shape=(m, n))


def spmm_reference(
    a: CSR, b: torch.Tensor, reduce: str = "sum", return_arg: bool = False
):
    """Gather/segment SpMM, C[i,:] = reduce_{j in row i} A[i,j] * B[j,:].

    The plain oracle of the port, on the device of its inputs, with every
    reducer of the JAX oracle (types.py:586-642): sum and mean by
    `index_add_`, max and min by `scatter_reduce` with empty rows 0, mul by
    `scatter_reduce('prod')`, and div as 1 / prod (not the naive kernel's
    running division, which rounds otherwise). With return_arg=True
    (min/max only) it also returns the int32 arg matrix: per output element
    the first nnz index whose product equals the extremum, `a.nnz` on empty
    rows.
    """
    if b.ndim != 2:
        raise ValueError(f"spmm_reference expects 2-D b, got {tuple(b.shape)}")
    if return_arg and reduce not in ("min", "max"):
        raise ValueError("return_arg is only meaningful for min/max")
    if reduce not in ("sum", "mean", "max", "min", "mul", "div"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    dev = b.device
    rows = torch.from_numpy(a.row_ids().astype(np.int64)).to(dev)
    cols = torch.from_numpy(a.indices.astype(np.int64)).to(dev)
    gathered = b[cols] * a.data.to(dev)[:, None]
    m, n = a.shape[0], b.shape[1]
    out = torch.zeros((m, n), dtype=gathered.dtype, device=dev)
    if reduce in ("sum", "mean"):
        out = out.index_add_(0, rows, gathered)
        if reduce == "sum":
            return out
        cnt = torch.zeros((m,), dtype=a.data.dtype, device=dev).index_add_(
            0, rows, torch.ones_like(a.data).to(dev))
        return out / cnt.clamp_min(1.0)[:, None]
    idx = rows[:, None].expand(-1, n)
    if reduce in ("mul", "div"):
        prod = torch.ones((m, n), dtype=gathered.dtype, device=dev).scatter_reduce_(
            0, idx, gathered, "prod")
        return prod if reduce == "mul" else 1.0 / prod
    # max / min: the rows' own reduce; empty rows keep the zeros they start from
    ext = out.scatter_reduce_(0, idx, gathered, "amax" if reduce == "max" else "amin",
                              include_self=False)
    if not return_arg:
        return ext
    nnz = a.nnz
    e_idx = torch.arange(nnz, dtype=torch.int32, device=dev)[:, None].expand(-1, n)
    cand = torch.where(gathered == ext[rows], e_idx, nnz)
    arg = torch.full((m, n), nnz, dtype=torch.int32, device=dev).scatter_reduce_(
        0, idx, cand, "amin")
    return ext, arg


def sddmm_reference(a_pattern: CSR, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: out[t] = (X @ Y)[row_t, col_t] for each
    nonzero t of the pattern, in CSR order. The plain oracle of the SDDMM
    kernel, on the device of its inputs; a_pattern's values are not read."""
    dev = x.device
    rows = torch.from_numpy(a_pattern.row_ids().astype(np.int64)).to(dev)
    cols = torch.from_numpy(a_pattern.indices.astype(np.int64)).to(dev)
    return (x[rows] * y[:, cols].transpose(0, 1)).sum(dim=1)


@dataclass(frozen=True)
class DIA:
    """Diagonal-format sparse matrix (banded storage, row-centric).

    ``data[d, i] = A[i, i + offsets[d]]``: data (noffsets, nrows) tensor;
    slots whose column i + offsets[d] falls outside [0, ncols) are
    structural zeros. ``offsets`` is host numpy int64, sorted ascending and
    unique. scipy's dia_matrix stores column-centric
    (``data[d, j] = A[j - offsets[d], j]``); from_scipy/to_scipy convert."""

    data: torch.Tensor
    offsets: np.ndarray
    shape: Shape2

    def __post_init__(self):
        offs = np.asarray(self.offsets, np.int64)
        if offs.ndim != 1 or (np.diff(offs) <= 0).any():
            raise ValueError("DIA offsets must be 1-D, sorted, unique")
        object.__setattr__(self, "offsets", offs)
        object.__setattr__(self, "shape", _static_shape(self.shape))

    @property
    def noffsets(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def bandwidth(self) -> int:
        return int(np.abs(self.offsets).max(initial=0))

    def _valid_mask(self) -> np.ndarray:
        """(noffsets, m) bool: which slots map to in-bounds columns."""
        m, k = self.shape
        j = np.arange(m, dtype=np.int64)[None, :] + self.offsets[:, None]
        return (j >= 0) & (j < k)

    def transpose(self) -> "DIA":
        """Aᵀ as DIA: offsets negate (re-sorted ascending, so the rows come
        in reverse) and each diagonal's values shift, Aᵀ[j, j - off] =
        A[j - off, j] = data[d, j - off]. One gather out of the plane,
        differentiable in `data`; slots past the edge are zero."""
        m, k = self.shape
        nd = self.noffsets
        off = self.offsets[::-1][:, None]  # new row d' is old row nd-1-d'
        j = np.arange(k, dtype=np.int64)[None, :]
        src = j - off
        valid = (src >= 0) & (src < m)
        flat = (np.arange(nd - 1, -1, -1, dtype=np.int64)[:, None] * m
                + np.where(valid, src, 0))
        dev = self.data.device
        vals = self.data.reshape(-1)[torch.from_numpy(flat).to(dev)]
        data = torch.where(torch.from_numpy(valid).to(dev), vals, torch.zeros((), dtype=self.dtype,
                                                                             device=dev))
        return DIA(data=data, offsets=np.sort(-self.offsets[::-1]), shape=(k, m))

    @property
    def T(self) -> "DIA":
        return self.transpose()

    @classmethod
    def from_dense(cls, mat, device=None) -> "DIA":
        src, mat = mat, _host(mat)
        m, k = _static_shape(mat.shape)
        i, j = np.nonzero(mat)
        offs = np.unique(j.astype(np.int64) - i.astype(np.int64))
        data = np.zeros((offs.size, m), mat.dtype)
        data[np.searchsorted(offs, j.astype(np.int64) - i), i] = mat[i, j]
        return cls(data=_back(data, src, resolve_device(device)), offsets=offs,
                   shape=(m, k))

    def to_dense(self) -> torch.Tensor:
        m, k = self.shape
        d_idx, i_idx = np.nonzero(self._valid_mask())
        dev = self.data.device
        rows = torch.from_numpy(i_idx).to(dev)
        cols = torch.from_numpy(i_idx + self.offsets[d_idx]).to(dev)
        vals = self.data[torch.from_numpy(d_idx).to(dev), rows]
        return torch.zeros((m, k), dtype=self.dtype, device=dev).index_put((rows, cols), vals)

    def report(self, n_cols: int = 256, dtype_bytes: int = 4) -> dict:
        """Stats and projected roofline, the contract of `Plan.report`, on
        the port's H100 constants (`plan._ROOFLINE`). The DIA product
        streams: per diagonal it reads the (m,) value row and an (m, n)
        shifted slab of B, and writes the (m, n) output once."""
        from tpusparse_torch.plan import _ROOFLINE

        m, k = self.shape
        stored = self.noffsets * m
        nnz = int(self._valid_mask().sum())
        bytes_moved = float(dtype_bytes * (stored + stored * n_cols + m * n_cols))
        t = bytes_moved / _ROOFLINE["hbm_bandwidth"]
        useful = 2.0 * nnz * n_cols
        return {
            "format": "dia",
            "noffsets": float(self.noffsets),
            "bandwidth": float(self.bandwidth),
            "nnz": float(nnz),
            "density": nnz / float(m * k),
            "pad_overhead": stored / max(nnz, 1) - 1.0,
            "useful_flops": useful,
            "bytes_moved": bytes_moved,
            "arithmetic_intensity": useful / bytes_moved,
            "projected_time_s": t,
            "projected_gflops_effective": useful / t / 1e9,
            "projected_nnz_per_s": nnz * n_cols / t,
            "bound": "memory",
        }

    @classmethod
    def from_scipy(cls, sp, device=None) -> "DIA":
        sp = sp.todia()
        offs = np.asarray(sp.offsets, np.int64)
        order = np.argsort(offs)
        m, k = _static_shape(sp.shape)
        data = np.zeros((offs.size, m), sp.data.dtype)
        # scipy trims its data width to col.max() + 1 when trailing columns
        # are empty: clamp j to what is stored
        width = sp.data.shape[1]
        for out_d, d in enumerate(order):
            off = int(offs[d])
            j = np.arange(max(0, off), min(k, m + off, width), dtype=np.int64)
            data[out_d, j - off] = sp.data[d, j]
        return cls(data=torch.from_numpy(data).to(resolve_device(device)),
                   offsets=offs[order], shape=(m, k))

    def to_scipy(self):
        import scipy.sparse as ssp

        m, k = self.shape
        ours = host_numpy(self.data)
        data = np.zeros((self.noffsets, k), ours.dtype)
        for d, off in enumerate(self.offsets):
            off = int(off)
            j = np.arange(max(0, off), min(k, m + off), dtype=np.int64)
            data[d, j] = ours[d, j - off]
        return ssp.dia_matrix((data, self.offsets), shape=self.shape)


def csr_to_dia(a: CSR, max_offsets: int = 128) -> DIA:
    """CSR -> DIA by a host pattern pass; the values go into the plane by
    one index-put on their device, differentiable in `a.data`. Raises when
    the pattern spreads over more than `max_offsets` distinct diagonals."""
    m, k = a.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
    offs_all = np.asarray(a.indices).astype(np.int64) - rows
    offs = np.unique(offs_all)
    if offs.size > max_offsets:
        raise ValueError(
            f"pattern has {offs.size} distinct diagonals (> {max_offsets}); "
            "not a banded matrix — use CSR executors"
        )
    dev = a.data.device
    idx = (torch.from_numpy(np.searchsorted(offs, offs_all)).to(dev),
           torch.from_numpy(rows).to(dev))
    data = torch.zeros((offs.size, m), dtype=a.dtype, device=dev).index_put(idx, a.data)
    return DIA(data=data, offsets=offs, shape=a.shape)


def dia_to_csr(a: DIA) -> CSR:
    """DIA -> CSR keeping every valid slot as a structural entry; the values
    are one gather out of the plane, differentiable in `a.data`."""
    m, k = a.shape
    d_idx, i_idx = np.nonzero(a._valid_mask())
    cols = i_idx + a.offsets[d_idx]
    order = np.lexsort((cols, i_idx))
    d_idx, i_idx, cols = d_idx[order], i_idx[order], cols[order]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(i_idx, minlength=m), out=indptr[1:])
    dev = a.data.device
    return CSR(
        data=a.data[torch.from_numpy(d_idx).to(dev), torch.from_numpy(i_idx).to(dev)],
        indices=cols.astype(np.int32),
        indptr=indptr.astype(np.int32),
        shape=a.shape,
    )
