"""Test and benchmark matrices for the port (numpy generators)."""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.types import CSR, Shape2
from tpusparse_torch.utils.config import resolve_device


def block_sparse_csr(
    seed: int, shape: Shape2, bshape: Shape2, occupancy: float, device=None
) -> CSR:
    """CSR whose nonzeros fill whole (bm, bk) blocks, each block occupied
    with probability `occupancy`; values U(0, 1). The pattern and values
    come from numpy's generator at `seed` and are built straight from the
    block mask, never through a dense matrix (the headline workload of the
    JAX package's bench.py:108-149). Values are placed on `device`.
    """
    rng = np.random.default_rng(seed)
    m, k = shape
    bm, bk = bshape
    nbr = m // bm
    mask = rng.random((nbr, k // bk)) < occupancy
    _brows, bcols = np.nonzero(mask)  # block-row-major
    blocks_per_row = mask.sum(axis=1).astype(np.int64)  # (nbr,)
    bstart = np.zeros(nbr + 1, dtype=np.int64)
    np.cumsum(blocks_per_row, out=bstart[1:])
    col_base = (bcols * bk).astype(np.int64)

    # run = one bk-wide column segment of one dense row
    runs_per_dense_row = np.repeat(blocks_per_row, bm)  # (m,)
    total_runs = int(runs_per_dense_row.sum())
    run_row = np.repeat(np.arange(m, dtype=np.int64), runs_per_dense_row)
    row_first_run = np.cumsum(runs_per_dense_row) - runs_per_dense_row
    pos_in_row = np.arange(total_runs, dtype=np.int64) - np.repeat(
        row_first_run, runs_per_dense_row
    )
    slot = bstart[run_row // bm] + pos_in_row
    indices = (
        col_base[slot][:, None] + np.arange(bk, dtype=np.int64)[None, :]
    ).reshape(-1)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(runs_per_dense_row * bk, out=indptr[1:])
    data = rng.random(total_runs * bk, dtype=np.float32)
    return CSR(
        data=torch.from_numpy(data).to(resolve_device(device)),
        indices=indices.astype(np.int32),
        indptr=indptr.astype(np.int32),
        shape=(m, k),
    )
