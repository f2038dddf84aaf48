"""Sparse elementwise algebra on CSR matrices: add, subtract, Hadamard,
scale, map, prune, stack, reduce, norm, permute, Kronecker and triangles.

Counterpart of `tpusparse/elementwise.py`. As in the JAX package, the
pattern work (the union or intersection of two patterns, a permutation, a
cross product) runs once on the host and is cached by fingerprint where
JAX caches it; the value pass is plain tensor code on the values' device
(gathers and scatter-adds), so autograd flows through it. There is no
kernel here.

Patterns are structural, as in scipy: `sp_add` keeps the union of the two
patterns even where values cancel to 0.0, `sp_hadamard` the intersection
even where a product is 0.0, so a result's pattern never depends on the
values. `prune_csr` is the exception: it defines a new pattern from the
values, on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpusparse_torch.plan import _fingerprint
from tpusparse_torch.types import CSR, DIA, _host

_INT = np.int32


def _host_pattern(a: CSR, opname: str):
    if isinstance(a, DIA):
        raise TypeError(
            f"{opname} takes CSR operands; convert with "
            "tpusparse_torch.dia_to_csr(a) (interop.from_scipy returns DIA "
            "for scipy dia_matrix inputs)")
    return np.asarray(a.indptr), np.asarray(a.indices)


def _flat(indptr: np.ndarray, indices: np.ndarray, shape) -> np.ndarray:
    m, n = shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    return rows * np.int64(n) + indices.astype(np.int64)


def _positions_of(flat: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Index in `flat` of each (unique) entry of `targets`."""
    order = np.argsort(flat, kind="stable")
    where = np.searchsorted(flat[order], targets)
    return order[where].astype(np.int64)


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(device)


def _indptr_of(rows: np.ndarray, m: int) -> np.ndarray:
    indptr = np.zeros(m + 1, dtype=_INT)
    indptr[1:] = np.cumsum(np.bincount(rows.astype(np.int64), minlength=m))
    return indptr


_UNION_CACHE: dict = {}
_INTERSECT_CACHE: dict = {}


def _pair_key(a: CSR, b: CSR, opname: str):
    return tuple(_fingerprint(x.shape, (1, 1), *_host_pattern(x, opname)) for x in (a, b))


def _union_plan(a: CSR, b: CSR, opname: str):
    """(slot of each a entry, slot of each b entry, indices, indptr, nnz) of
    the union pattern, in CSR order."""
    key = _pair_key(a, b, opname)
    hit = _UNION_CACHE.get(key)
    if hit is not None:
        return hit
    m, n = a.shape
    fa, fb = _flat(*_host_pattern(a, opname), a.shape), _flat(*_host_pattern(b, opname), b.shape)
    uniq = np.union1d(fa, fb)  # sorted == CSR order
    hit = (np.searchsorted(uniq, fa), np.searchsorted(uniq, fb),
           (uniq % n).astype(_INT), _indptr_of(uniq // n, m), int(uniq.size))
    _UNION_CACHE[key] = hit
    return hit


def _intersect_plan(a: CSR, b: CSR, opname: str):
    """(position in a, position in b, indices, indptr) of each entry of the
    intersection pattern, in CSR order."""
    key = _pair_key(a, b, opname)
    hit = _INTERSECT_CACHE.get(key)
    if hit is not None:
        return hit
    m, n = a.shape
    fa, fb = _flat(*_host_pattern(a, opname), a.shape), _flat(*_host_pattern(b, opname), b.shape)
    common = np.intersect1d(fa, fb)  # sorted == CSR order
    hit = (_positions_of(fa, common), _positions_of(fb, common),
           (common % n).astype(_INT), _indptr_of(common // n, m))
    _INTERSECT_CACHE[key] = hit
    return hit


def _check_same_shape(a: CSR, b: CSR, opname: str):
    if a.shape != b.shape:
        raise ValueError(f"{opname}: shape mismatch {a.shape} vs {b.shape}")


def sp_add(a: CSR, b: CSR, alpha: float = 1.0, beta: float = 1.0) -> CSR:
    """alpha·A + beta·B on the union pattern, differentiable in both value
    vectors; the pattern is structural (an entry that cancels to 0 stays)."""
    _check_same_shape(a, b, "sp_add")
    slot_a, slot_b, c_indices, c_indptr, c_nnz = _union_plan(a, b, "sp_add")
    dtype = torch.promote_types(a.dtype, b.dtype)
    dev = a.data.device
    data = (torch.zeros((c_nnz,), dtype=dtype, device=dev)
            .index_add(0, _index(slot_a, dev), alpha * a.data.to(dtype))
            .index_add(0, _index(slot_b, dev), beta * b.data.to(dev, dtype)))
    return CSR(data=data, indices=c_indices, indptr=c_indptr, shape=a.shape)


def sp_sub(a: CSR, b: CSR) -> CSR:
    """A - B on the union pattern."""
    return sp_add(a, b, 1.0, -1.0)


def sp_hadamard(a: CSR, b: CSR) -> CSR:
    """Elementwise product A ∘ B on the intersection pattern."""
    _check_same_shape(a, b, "sp_hadamard")
    pa, pb, c_indices, c_indptr = _intersect_plan(a, b, "sp_hadamard")
    dev = a.data.device
    data = a.data[_index(pa, dev)] * b.data.to(dev)[_index(pb, dev)]
    return CSR(data=data, indices=c_indices, indptr=c_indptr, shape=a.shape)


def sp_scale(a: CSR, s) -> CSR:
    """Scaling by a scalar, or by a per-nonzero array; pattern unchanged."""
    if not isinstance(s, torch.Tensor) and np.ndim(s):
        s = torch.as_tensor(np.asarray(s), device=a.data.device)
    return CSR(a.data * s, a.indices, a.indptr, a.shape)


def sp_map(a: CSR, fn) -> CSR:
    """fn applied to the stored values only, pattern unchanged: not fn of
    the dense matrix unless fn(0) == 0."""
    return CSR(fn(a.data), a.indices, a.indptr, a.shape)


def prune_csr(
    a: CSR,
    threshold: Optional[float] = None,
    density: Optional[float] = None,
) -> CSR:
    """Magnitude-prune stored values: keep |v| > threshold, or the top
    `density` fraction, ties at the threshold broken by position (first
    come first kept). Host-side: the surviving pattern depends on the
    values, so it is a new pattern; the kept values are gathered on their
    device, differentiably."""
    if (threshold is None) == (density is None):
        raise ValueError("specify exactly one of threshold / density")
    data = _host(a.data)
    if density is not None:
        keep_n = max(1, int(round(density * data.size)))
        thr = np.partition(np.abs(data), data.size - keep_n)[data.size - keep_n]
        mask = np.abs(data) >= thr
        if mask.sum() > keep_n:
            extra = np.flatnonzero(np.abs(data) == thr)
            mask[extra[keep_n - mask.sum():]] = False
    else:
        mask = np.abs(data) > threshold
    keep = np.flatnonzero(mask)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(np.asarray(a.indptr)))
    return CSR(
        data=a.data[_index(keep, a.data.device)],
        indices=np.asarray(a.indices)[keep].astype(_INT),
        indptr=_indptr_of(rows[keep], a.shape[0]),
        shape=a.shape,
    )


# ---------------------------------------------------------------------------
# Structural composition: vstack / hstack / block_diag. block_diag turns a
# batch of operands with different patterns into one CSR, so that one SpMM
# against the stacked dense operand computes every product.
# ---------------------------------------------------------------------------


def _nonempty(mats, opname):
    mats = list(mats)
    if not mats:
        raise ValueError(f"{opname} needs at least one matrix")
    return mats


def _stacked_indptr(pats):
    parts, offset = [pats[0][0].astype(np.int64)], int(pats[0][0][-1])
    for indptr, _ in pats[1:]:
        parts.append(indptr[1:].astype(np.int64) + offset)
        offset += int(indptr[-1])
    return np.concatenate(parts).astype(_INT)


def _cat_data(mats):
    dev = mats[0].data.device
    return torch.cat([m.data.to(dev) for m in mats])


def vstack(mats) -> CSR:
    """Stack CSRs vertically (same column count): [[A1], [A2], ...]."""
    mats = _nonempty(mats, "vstack")
    n = mats[0].shape[1]
    if any(m.shape[1] != n for m in mats):
        raise ValueError(f"vstack: column counts differ: {[m.shape for m in mats]}")
    pats = [_host_pattern(m, "vstack") for m in mats]
    return CSR(
        data=_cat_data(mats),
        indices=np.concatenate([idx for _, idx in pats]).astype(_INT),
        indptr=_stacked_indptr(pats),
        shape=(sum(m.shape[0] for m in mats), n),
    )


def hstack(mats) -> CSR:
    """Stack CSRs horizontally (same row count): [A1 | A2 | ...]."""
    mats = _nonempty(mats, "hstack")
    m_rows = mats[0].shape[0]
    if any(m.shape[0] != m_rows for m in mats):
        raise ValueError(f"hstack: row counts differ: {[m.shape for m in mats]}")
    pats = [_host_pattern(m, "hstack") for m in mats]
    # interleave per row: a stable sort of all entries by (row, matrix),
    # which is also the permutation of the concatenated values
    k = len(mats)
    col_off = np.cumsum([0] + [m.shape[1] for m in mats[:-1]])
    rows_all = np.concatenate([
        np.repeat(np.arange(m_rows, dtype=np.int64), np.diff(p[0].astype(np.int64)))
        for p in pats])
    j_all = np.concatenate([np.full(p[1].size, j, dtype=np.int64) for j, p in enumerate(pats)])
    order = np.argsort(rows_all * k + j_all, kind="stable")
    cols_all = np.concatenate([p[1].astype(np.int64) + off for p, off in zip(pats, col_off)])
    data = _cat_data(mats)
    return CSR(
        data=data[_index(order, data.device)],
        indices=cols_all[order].astype(_INT),
        indptr=_indptr_of(rows_all, m_rows),
        shape=(m_rows, int(sum(m.shape[1] for m in mats))),
    )


def block_diag(mats) -> CSR:
    """Block-diagonal CSR diag(A1, A2, ...): one matrix whose SpMM against
    a stacked dense operand computes every per-pattern product in one plan
    and one kernel."""
    mats = _nonempty(mats, "block_diag")
    pats = [_host_pattern(m, "block_diag") for m in mats]
    col_off = np.cumsum([0] + [m.shape[1] for m in mats[:-1]])
    indices = np.concatenate([idx.astype(np.int64) + off for (_, idx), off in zip(pats, col_off)])
    return CSR(
        data=_cat_data(mats),
        indices=indices.astype(_INT),
        indptr=_stacked_indptr(pats),
        shape=(int(sum(m.shape[0] for m in mats)), int(sum(m.shape[1] for m in mats))),
    )


# ---------------------------------------------------------------------------
# Reductions and norms
# ---------------------------------------------------------------------------


def row_reduce(a: CSR, reduce: str = "sum") -> torch.Tensor:
    """Per-row reduction over the stored values -> (m,): 'sum', 'mean',
    'min', 'max' or 'nnz' (int32). An empty row gives 0."""
    if reduce not in ("sum", "mean", "min", "max", "nnz"):
        raise ValueError(f"unknown reduce mode {reduce!r}")
    m = a.shape[0]
    dev = a.data.device
    rows = _index(a.row_ids(), dev)
    counts = torch.bincount(rows, minlength=m)
    if reduce == "nnz":
        return counts.to(torch.int32)
    if reduce in ("sum", "mean"):
        s = torch.zeros((m,), dtype=a.dtype, device=dev).index_add(0, rows, a.data)
        return s if reduce == "sum" else s / counts.clamp_min(1)
    # min / max: the rows' own extremum; empty rows keep the zeros they start from
    return torch.zeros((m,), dtype=a.dtype, device=dev).scatter_reduce(
        0, rows, a.data, "amax" if reduce == "max" else "amin", include_self=False)


def row_softmax(a: CSR, temperature: float = 1.0) -> CSR:
    """Softmax over each row's stored values, same pattern out: absent
    entries count as -inf, so each stored row sums to 1. Differentiable in
    `a.data`; empty rows stay empty. The row max is taken without a
    gradient: softmax does not change under a shift, so its gradient
    through the max is zero."""
    m = a.shape[0]
    dev = a.data.device
    rows = _index(a.row_ids(), dev)
    e = a.data / temperature
    mx = torch.full((m,), -float("inf"), dtype=e.dtype, device=dev).scatter_reduce(
        0, rows, e.detach(), "amax", include_self=False)
    p = torch.exp(e - mx[rows])
    s = torch.zeros((m,), dtype=p.dtype, device=dev).index_add(0, rows, p)
    return CSR(data=p / s[rows], indices=a.indices, indptr=a.indptr, shape=a.shape)


def col_reduce(a: CSR, reduce: str = "sum") -> torch.Tensor:
    """Per-column reduction over the stored values -> (n,)."""
    from tpusparse_torch.ops import transpose_csr

    return row_reduce(transpose_csr(a), reduce)


def sp_norm(a: CSR, ord="fro") -> torch.Tensor:
    """Matrix norm over the stored values: 'fro', 1 (largest column
    abs-sum) or 'inf' (largest row abs-sum)."""
    if ord == "fro":
        return torch.sqrt(torch.sum(a.data.float() ** 2))
    absd = sp_map(a, torch.abs)
    if ord in (1, "1"):
        return torch.max(col_reduce(absd, "sum"))
    if ord in ("inf", np.inf):
        return torch.max(row_reduce(absd, "sum"))
    raise ValueError(f"unsupported norm ord {ord!r}")


# ---------------------------------------------------------------------------
# Permutation, Kronecker product, triangles: host pattern passes and one
# differentiable value gather each
# ---------------------------------------------------------------------------


def _check_perm(perm, size: int, name: str) -> np.ndarray:
    perm = np.asarray(perm, np.int64)
    if perm.shape != (size,) or np.bincount(perm, minlength=size).max() != 1:
        raise ValueError(f"{name} must be a permutation of range({size})")
    return perm


def permute_csr(a: CSR, row_perm=None, col_perm=None) -> CSR:
    """P·A·Qᵀ as a pattern pass: `row_perm[i]` is the OLD index of NEW row
    i (scipy's convention: the result equals dense[row_perm][:, col_perm]).
    Rows stay sorted by column."""
    indptr, indices = _host_pattern(a, "permute_csr")
    m, n = a.shape
    counts = np.diff(indptr)
    row_perm = (np.arange(m, dtype=np.int64) if row_perm is None
                else _check_perm(row_perm, m, "row_perm"))
    new_counts = counts[row_perm]
    new_indptr = np.concatenate([[0], np.cumsum(new_counts)]).astype(_INT)
    nnz = int(indptr[-1])
    # each new row's old entry positions, without a python loop
    order = (
        np.repeat(indptr[row_perm].astype(np.int64), new_counts)
        + np.arange(nnz, dtype=np.int64)
        - np.repeat(new_indptr[:-1].astype(np.int64), new_counts)
    )
    new_cols = indices[order].astype(np.int64)
    if col_perm is not None:
        col_perm = _check_perm(col_perm, n, "col_perm")
        inv = np.empty(n, np.int64)
        inv[col_perm] = np.arange(n, dtype=np.int64)
        new_cols = inv[new_cols]
    # sorted columns within each new row
    new_rows = np.repeat(np.arange(m, dtype=np.int64), new_counts)
    resort = np.lexsort((new_cols, new_rows))
    order = order[resort]
    return CSR(
        data=a.data[_index(order, a.data.device)],
        indices=new_cols[resort].astype(_INT),
        indptr=new_indptr,
        shape=a.shape,
    )


def sp_kron(a: CSR, b: CSR) -> CSR:
    """Kronecker product A ⊗ B as a CSR (scipy.sparse.kron's pattern and
    order). The pattern cross product runs on the host; the values are one
    gather-multiply, differentiable in both operands."""
    a_indptr, a_indices = _host_pattern(a, "sp_kron")
    b_indptr, b_indices = _host_pattern(b, "sp_kron")
    ma, na = a.shape
    mb, nb = b.shape
    nnza, nnzb = int(a_indptr[-1]), int(b_indptr[-1])
    if nnza * nnzb > 200_000_000:
        raise ValueError(
            f"sp_kron pattern would have {nnza * nnzb} entries; "
            "build the operator blockwise instead"
        )
    a_rows = np.repeat(np.arange(ma, dtype=np.int64), np.diff(a_indptr))
    b_rows = np.repeat(np.arange(mb, dtype=np.int64), np.diff(b_indptr))
    ka = np.repeat(np.arange(nnza, dtype=np.int64), nnzb)
    kb = np.tile(np.arange(nnzb, dtype=np.int64), nnza)
    rows = a_rows[ka] * mb + b_rows[kb]
    cols = a_indices[ka].astype(np.int64) * nb + b_indices[kb].astype(np.int64)
    order = np.lexsort((cols, rows))
    ka, kb, rows, cols = ka[order], kb[order], rows[order], cols[order]
    dev = a.data.device
    return CSR(
        data=a.data[_index(ka, dev)] * b.data.to(dev)[_index(kb, dev)],
        indices=cols.astype(_INT),
        indptr=_indptr_of(rows, ma * mb),
        shape=(ma * mb, na * nb),
    )


def _tri_select(a: CSR, keep_mask: np.ndarray, rows: np.ndarray) -> CSR:
    pos = np.flatnonzero(keep_mask)
    return CSR(
        data=a.data[_index(pos, a.data.device)],
        indices=np.asarray(a.indices)[pos].astype(_INT),
        indptr=_indptr_of(rows[pos], a.shape[0]),
        shape=a.shape,
    )


def _rows_cols(a: CSR, opname: str):
    indptr, indices = _host_pattern(a, opname)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    return rows, indices.astype(np.int64)


def sp_tril(a: CSR, k: int = 0) -> CSR:
    """Lower triangle (entries with j - i <= k), scipy.sparse.tril's
    semantics."""
    rows, cols = _rows_cols(a, "sp_tril")
    return _tri_select(a, cols - rows <= k, rows)


def sp_triu(a: CSR, k: int = 0) -> CSR:
    """Upper triangle (entries with j - i >= k), scipy.sparse.triu's
    semantics."""
    rows, cols = _rows_cols(a, "sp_triu")
    return _tri_select(a, cols - rows >= k, rows)
