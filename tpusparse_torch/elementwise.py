"""Sparse elementwise algebra on CSR matrices: the part the graph models use.

Counterpart of `tpusparse/elementwise.py:50-138` (`sp_add` with its
union-plan cache) and l.341-362 (`row_softmax`). As in the JAX package, the
pattern work (the union of two patterns) runs once on the host and is
cached by fingerprint; the value pass is plain tensor code (gather and
scatter-add), so autograd flows through it. The rest of the module
(`sp_hadamard`, `sp_scale`, the reductions, `prune`) comes with ROADMAP
queue 1, item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.plan import _fingerprint
from tpusparse_torch.types import CSR

_UNION_CACHE: dict = {}


def _flat(a: CSR) -> np.ndarray:
    m, n = a.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
    return rows * np.int64(n) + np.asarray(a.indices, dtype=np.int64)


def _union_plan(a: CSR, b: CSR):
    """(slot of each a entry, slot of each b entry, indices, indptr, nnz) of
    the union pattern, in CSR order."""
    key = tuple(_fingerprint(x.shape, (1, 1), np.asarray(x.indptr), np.asarray(x.indices))
                for x in (a, b))
    hit = _UNION_CACHE.get(key)
    if hit is not None:
        return hit
    m, n = a.shape
    fa, fb = _flat(a), _flat(b)
    uniq = np.union1d(fa, fb)  # sorted == CSR order
    c_indptr = np.zeros(m + 1, dtype=np.int32)
    c_indptr[1:] = np.cumsum(np.bincount(uniq // n, minlength=m))
    hit = (np.searchsorted(uniq, fa), np.searchsorted(uniq, fb),
           (uniq % n).astype(np.int32), c_indptr, int(uniq.size))
    _UNION_CACHE[key] = hit
    return hit


def sp_add(a: CSR, b: CSR, alpha: float = 1.0, beta: float = 1.0) -> CSR:
    """alpha·A + beta·B on the union pattern, differentiable in both value
    vectors; the pattern is structural (an entry that cancels to 0 stays)."""
    if a.shape != b.shape:
        raise ValueError(f"sp_add: shape mismatch {a.shape} vs {b.shape}")
    slot_a, slot_b, c_indices, c_indptr, c_nnz = _union_plan(a, b)
    dtype = torch.promote_types(a.dtype, b.dtype)
    dev = a.data.device
    data = (torch.zeros((c_nnz,), dtype=dtype, device=dev)
            .index_add(0, torch.from_numpy(slot_a).to(dev), alpha * a.data.to(dtype))
            .index_add(0, torch.from_numpy(slot_b).to(dev), beta * b.data.to(dev, dtype)))
    return CSR(data=data, indices=c_indices, indptr=c_indptr, shape=a.shape)


def row_softmax(a: CSR, temperature: float = 1.0) -> CSR:
    """Softmax over each row's stored values, same pattern out: absent
    entries count as -inf, so each stored row sums to 1. Differentiable in
    `a.data`; empty rows stay empty. The row max is taken without a
    gradient: softmax does not change under a shift, so its gradient
    through the max is zero."""
    m = a.shape[0]
    dev = a.data.device
    rows = torch.from_numpy(a.row_ids().astype(np.int64)).to(dev)
    e = a.data / temperature
    mx = torch.full((m,), -float("inf"), dtype=e.dtype, device=dev).scatter_reduce(
        0, rows, e.detach(), "amax", include_self=False)
    p = torch.exp(e - mx[rows])
    s = torch.zeros((m,), dtype=p.dtype, device=dev).index_add(0, rows, p)
    return CSR(data=p / s[rows], indices=a.indices, indptr=a.indptr, shape=a.shape)
