"""Test and benchmark matrices for the port (numpy/scipy generators).

Counterpart of `tpusparse/utils/matrices.py`: the Matrix Market reader and
writer (`load_mtx`, `save_mtx`), the stand-in generators of the catalog's
SuiteSparse pattern classes (`_laplace2d`, `_laplace3d`, `_powerlaw_graph`,
`_circuit`, `block_structured_csr`; copied, since the JAX module is numpy
and scipy only but imports the JAX package), `MATRIX_CATALOG`, `generate`,
`find_mtx`, `get_matrix` and `describe`, all giving JAX's matrices exactly;
and `block_sparse_csr`, the headline workload. Nothing is downloaded. The
search for `<name>.mtx` looks only where the caller says, or in
`$TPUSPARSE_MATRIX_DIR`; the JAX module also looks in two home
directories. Values land on `device` (None: the card).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sp
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


def _host_csr(sp_csr, device=None) -> CSR:
    """CSR with host int32 pattern arrays and the values on `device`."""
    return CSR(
        data=torch.from_numpy(np.asarray(sp_csr.data)).to(resolve_device(device)),
        indices=np.ascontiguousarray(sp_csr.indices.astype(np.int32)),
        indptr=np.ascontiguousarray(sp_csr.indptr.astype(np.int32)),
        shape=(int(sp_csr.shape[0]), int(sp_csr.shape[1])),
    )


def load_mtx(path: str, dtype=np.float32, device=None) -> CSR:
    """Read a Matrix Market file (.mtx or .mtx.gz) into a CSR with sorted,
    summed indices (scipy.io.mmread expands symmetric storage; complex
    matrices are refused)."""
    from scipy.io import mmread

    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            mat = mmread(f)
    else:
        mat = mmread(path)
    if np.iscomplexobj(mat):
        raise ValueError(f"{path}: complex matrices are not supported")
    csr = sp.csr_matrix(mat)
    csr.sort_indices()
    csr.sum_duplicates()
    return _host_csr(csr.astype(dtype), device)


def save_mtx(path: str, a: CSR, comment: str = "") -> None:
    """Write a CSR to Matrix Market (general real coordinate)."""
    from scipy.io import mmwrite

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            mmwrite(f, a.to_scipy(), comment=comment)
    else:
        mmwrite(path, a.to_scipy(), comment=comment)


# ----------------------------------------------------------------------------
# Stand-in generators, one per SuiteSparse pattern class (the JAX module's)
# ----------------------------------------------------------------------------


def _laplace2d(n_side: int) -> sp.csr_matrix:
    """5-point Poisson stencil on an n_side × n_side grid — the banded
    FEM/finite-difference class (SuiteSparse analogs: HB/nos*, the
    `apache`/`thermal` families). Pentadiagonal, bandwidth n_side;
    symmetric positive definite. Exercises the DIA path and AMG."""
    n = n_side * n_side
    main = 4.0 * np.ones(n)
    side = -np.ones(n - 1)
    side[np.arange(1, n) % n_side == 0] = 0  # no wrap across grid rows
    updown = -np.ones(n - n_side)
    return sp.diags(
        [main, side, side, updown, updown],
        [0, 1, -1, n_side, -n_side],
        format="csr",
    ).astype(np.float32)


def _laplace3d(n_side: int) -> sp.csr_matrix:
    """7-point stencil on an n_side³ grid (SuiteSparse analogs:
    `atmosmodd`, `Hamrle3`-like band structure at scale). Heptadiagonal
    with bandwidth n_side² — stresses DIA offset capacity."""
    n = n_side**3
    main = 6.0 * np.ones(n)
    dx = -np.ones(n - 1)
    dx[np.arange(1, n) % n_side == 0] = 0
    dy = -np.ones(n - n_side)
    yblock = np.arange(n_side, n) % (n_side * n_side)
    dy[yblock < n_side] = 0
    dz = -np.ones(n - n_side * n_side)
    return sp.diags(
        [main, dx, dx, dy, dy, dz, dz],
        [0, 1, -1, n_side, -n_side, n_side**2, -(n_side**2)],
        format="csr",
    ).astype(np.float32)


def _powerlaw_graph(n: int, avg_deg: float, alpha: float, seed: int) -> sp.csr_matrix:
    """Symmetric power-law graph adjacency + I (SuiteSparse analogs:
    SNAP/ca-*, web-*; the degree-skew class). A few heavy hub rows and
    a long tail of degree-1 rows — the pattern that breaks fixed-width
    ELL padding and drives the router to gather (SURVEY.md §7.3)."""
    rng = np.random.default_rng(seed)
    raw = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    rng.shuffle(raw)
    deg = np.maximum(1, np.round(raw * (avg_deg * n / raw.sum()))).astype(np.int64)
    deg = np.minimum(deg, n - 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.size)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    # canonicalize each edge to its upper triangle, dedup, then mirror —
    # EXACT symmetry (summing adj + adj.T instead leaves last-ulp fp32
    # asymmetry when duplicate edges accumulate in different orders)
    lo = np.minimum(rows, cols)
    hi = np.maximum(rows, cols)
    edge = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = (edge // n).astype(np.int64), (edge % n).astype(np.int64)
    vals = rng.random(lo.size).astype(np.float32) + 0.5
    adj = sp.coo_matrix(
        (np.concatenate([vals, vals]),
         (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
        shape=(n, n),
    ).tocsr()
    return (adj + sp.eye(n, format="csr", dtype=np.float32)).tocsr()


def _circuit(n: int, seed: int) -> sp.csr_matrix:
    """Circuit-simulation class (SuiteSparse analogs: Freescale/circuit*,
    rajat*): strongly diagonal matrix from sparse random 2-terminal
    device stamps, plus a handful of near-dense rows/columns (power and
    ground rails) — the dense-row pathology that defeats uniform
    per-row strategies and forces hybrid routing."""
    rng = np.random.default_rng(seed)
    nnz_off = int(2.5 * n)
    r = rng.integers(0, n, nnz_off)
    c = rng.integers(0, n, nnz_off)
    keep = r != c
    r, c = r[keep], c[keep]
    v = -(rng.random(r.size).astype(np.float32) * 0.9 + 0.1)
    # rails: ~5 rows/cols touching ~10% of nodes each
    nrails = max(1, n // 2000 + 4)
    rail_ids = rng.choice(n, nrails, replace=False)
    for rail in rail_ids:
        touch = rng.choice(n, max(1, n // 10), replace=False)
        touch = touch[touch != rail]
        rv = -(rng.random(touch.size).astype(np.float32) * 0.09 + 0.01)
        r = np.concatenate([r, np.full(touch.size, rail), touch])
        c = np.concatenate([c, touch, np.full(touch.size, rail)])
        v = np.concatenate([v, rv, rv])
    a = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    # diagonal dominance (sum of |off-diag| + 1) — SPD-ish like a
    # conductance matrix
    rowsum = np.abs(a).sum(axis=1).A1
    return (a + sp.diags(rowsum + 1.0, format="csr")).tocsr().astype(np.float32)


def block_structured_csr(
    m: int,
    k: int,
    bm: int,
    bk: int,
    fill: float,
    seed: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    diagonal: bool = False,
) -> sp.csr_matrix:
    """Random block-structured CSR: dense (bm, bk) blocks occupying a
    sparse block mask at the given fill — the headline regime of the
    tiled/resident executors. Every block row gets at least one block;
    `diagonal=True` additionally occupies the block diagonal (square
    masks). The single builder behind the catalog's block class, the
    quant benchmark, and the router calibration workload."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    nbr, nbc = m // bm, k // bk
    mask = rng.random((nbr, nbc)) < fill
    if diagonal:
        np.fill_diagonal(mask, True)
    for i in range(nbr):
        if not mask[i].any():
            mask[i, rng.integers(0, nbc)] = True
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal((rows.size, bm, bk)).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=nbr))])
    return sp.bsr_matrix((vals, cols, indptr), shape=(m, k)).tocsr()


def _block_structured(n: int, bs: int, fill: float, seed: int) -> sp.csr_matrix:
    """Block-structured class (SuiteSparse analogs: the BSR-friendly
    multiphysics families, e.g. `bmw*`/`pwtk` with natural node blocks)."""
    return block_structured_csr(n, n, bs, bs, fill, seed=seed, diagonal=True)


@dataclass(frozen=True)
class CatalogEntry:
    build: Callable[[], sp.csr_matrix]
    pattern_class: str
    suitesparse_analog: str
    description: str


MATRIX_CATALOG: Dict[str, CatalogEntry] = {
    "laplace2d_1024": CatalogEntry(
        lambda: _laplace2d(1024),
        "banded FEM",
        "HB/nos*, apache2, thermal2",
        "5-point Poisson on 1024x1024 grid: 1.05M rows, 5.2M nnz, "
        "pentadiagonal bandwidth 1024 (DIA/AMG workload)",
    ),
    "laplace2d_256": CatalogEntry(
        lambda: _laplace2d(256),
        "banded FEM",
        "HB/nos5, gridgena",
        "5-point Poisson on 256x256 grid: 65K rows, 327K nnz",
    ),
    "laplace3d_64": CatalogEntry(
        lambda: _laplace3d(64),
        "banded FEM (3-D)",
        "atmosmodd, Hamrle3",
        "7-point stencil on 64^3 grid: 262K rows, 1.8M nnz, "
        "bandwidth 4096 (stresses DIA offset capacity)",
    ),
    "powerlaw_100k": CatalogEntry(
        lambda: _powerlaw_graph(100_000, 16.0, 1.5, seed=7),
        "power-law graph",
        "SNAP/ca-HepPh, web-Stanford",
        "symmetric Zipf(1.5) graph + I: 100K rows, ~2.7M nnz, hub rows "
        "with >10K nnz next to degree-1 tails (router: gather regime)",
    ),
    "powerlaw_16k": CatalogEntry(
        lambda: _powerlaw_graph(16_384, 24.0, 1.6, seed=11),
        "power-law graph",
        "SNAP/ca-GrQc scaled up",
        "16K-row Zipf(1.6) graph + I (~500K nnz)",
    ),
    "circuit_50k": CatalogEntry(
        lambda: _circuit(50_000, seed=13),
        "circuit",
        "Freescale/circuit_4, rajat21",
        "diagonally dominant conductance matrix, 50K rows, ~360K nnz, "
        "with ~9 near-dense rail rows/cols (hybrid-routing pathology)",
    ),
    "blocked_16k": CatalogEntry(
        lambda: _block_structured(16_384, 128, 0.10, seed=17),
        "block-structured",
        "bmw3_2, pwtk (natural node blocks)",
        "10% dense 128x128 blocks on 16K rows (~268M nnz dense-equiv; "
        "the tiled/resident executor headline class)",
    ),
    "blocked_4k": CatalogEntry(
        lambda: _block_structured(4_096, 32, 0.08, seed=19),
        "block-structured",
        "bcsstk* family",
        "8% dense 32x32 blocks on 4K rows",
    ),
}


def generate(name: str, device=None) -> CSR:
    """Build a catalog stand-in deterministically (no I/O)."""
    if name not in MATRIX_CATALOG:
        raise KeyError(f"unknown matrix {name!r}; catalog: {sorted(MATRIX_CATALOG)}")
    return _host_csr(MATRIX_CATALOG[name].build(), device)


def find_mtx(name: str, search_dirs: Optional[Sequence[str]] = None) -> Optional[str]:
    """Locate `<name>.mtx[.gz]` in the search directories (also the
    SuiteSparse layout `<dir>/<name>/<name>.mtx`); by default only
    `$TPUSPARSE_MATRIX_DIR`."""
    dirs = [d for d in (search_dirs or (os.environ.get("TPUSPARSE_MATRIX_DIR", ""),)) if d]
    for d in dirs:
        for cand in (
            os.path.join(d, f"{name}.mtx"),
            os.path.join(d, f"{name}.mtx.gz"),
            os.path.join(d, name, f"{name}.mtx"),
            os.path.join(d, name, f"{name}.mtx.gz"),
        ):
            if os.path.isfile(cand):
                return cand
    return None


def get_matrix(name: str, search_dirs: Optional[Sequence[str]] = None,
               cache_dir: Optional[str] = None, device=None) -> CSR:
    """A real file if one is found, else the catalog stand-in. `name` may be
    a `.mtx`/`.mtx.gz` path, a basename to look up, or a catalog key; with
    `cache_dir` a generated stand-in is saved there."""
    if name.endswith((".mtx", ".mtx.gz")) and os.path.isfile(name):
        return load_mtx(name, device=device)
    path = find_mtx(name, search_dirs)
    if path is not None:
        return load_mtx(path, device=device)
    a = generate(name, device)
    if cache_dir:
        entry = MATRIX_CATALOG[name]
        save_mtx(
            os.path.join(cache_dir, f"{name}.mtx.gz"), a,
            comment=(f"tpusparse stand-in: {entry.pattern_class} "
                     f"(analog of {entry.suitesparse_analog}). {entry.description}"),
        )
    return a


def describe(name: str) -> str:
    e = MATRIX_CATALOG[name]
    return f"{name} [{e.pattern_class}; analog: {e.suitesparse_analog}] — {e.description}"
