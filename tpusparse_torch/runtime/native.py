"""ctypes binding to the port's native C++/OpenMP inspector.

Counterpart of `tpusparse/runtime/native.py` (l.140-277), with the same
entry points and results: `available`, `num_threads`, `inspect` (the
block-ELL plan inspector, a drop-in for `plan._inspect_numpy`),
`spgemm_symbolic` (C's pattern and the multiplication schedule of
`spgemm.spgemm_plan`), `factorize_inplace` (ILU(0)/IC(0)), `coo_to_csr`
and `aggregate` (AMG's greedy aggregation).

The library is the port's own copy of the source,
`tpusparse_torch/csrc/inspector.cpp`. It is built at first use into
`build/tpusparse_torch/`, keyed by the hash of the source and the flags,
and loaded with ctypes; nothing is built next to the sources. The build
takes the first compiler that succeeds of `$CXX` and `g++` (a `$CXX`
without OpenMP's runtime cannot build it). Where none works, `available()`
is False, `unavailable_reason` says why, and the callers take their numpy
passes, which give the same arrays: this is host code, not a device
fallback. As in JAX, setting `TPUSPARSE_NO_NATIVE` turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpusparse_torch.kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "csrc" / "inspector.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is not available, once a load has failed (the compiler's
# message, or the loader's)
unavailable_reason: Optional[str] = None


def compilers() -> list:
    """The C++ compilers a build tries, in order: `$CXX`, then `g++`."""
    return list(dict.fromkeys(c for c in (os.environ.get("CXX"), "g++") if c))


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    key = SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD_DIR / f"libtsinspector_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_command(cxx: str, out: Path) -> list:
    """The command line with which `cxx` builds the library into `out`."""
    return [cxx, *CXX_FLAGS, str(SRC), "-o", str(out)]


def _build(so: Path) -> Optional[str]:
    """Compile the library into `so` with the first compiler that succeeds;
    None on success, else every compiler's failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    failures = []
    for cxx in compilers():
        try:
            subprocess.run(build_command(cxx, tmp), check=True, capture_output=True, text=True,
                           timeout=120)
        except subprocess.CalledProcessError as e:
            failures.append(f"{cxx} exited {e.returncode}: {e.stderr.strip()[-1000:]}")
            continue
        except (subprocess.SubprocessError, OSError) as e:
            failures.append(f"{cxx} did not run: {e}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        return None
    tmp.unlink(missing_ok=True)
    return "; ".join(failures)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, unavailable_reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists():
            unavailable_reason = _build(so)
            if unavailable_reason is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            unavailable_reason = f"loading {so.name} failed: {e}"
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        sig = {
            "ts_inspect_count": (i64, [i32p, i64, i32p, i64, i64, i64, i32p]),
            "ts_inspect_fill": (None, [i32p, i64, i32p, i64, i64, i64, i64, i32p, i64p]),
            "ts_coo_to_csr": (None, [i32p, i64, i64, i32p, i64p]),
            "ts_spgemm_count": (i64, [i32p, i64, i32p, i32p, i32p, i64, i32p]),
            "ts_spgemm_fill": (None, [i32p, i64, i32p, i32p, i32p, i64] + [i32p] * 5),
            "ts_ilu0": (i64, [i32p, i32p, i64, f64p]),
            "ts_ic0": (i64, [i32p, i32p, i64, f64p]),
            "ts_aggregate": (i64, [i32p, i32p, u8p, i64, i64p]),
            "ts_num_threads": (ctypes.c_int, []),
        }
        for name, (restype, argtypes) in sig.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def _loaded() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native inspector is not available (no working C++ compiler)")
    return lib


def available() -> bool:
    if os.environ.get("TPUSPARSE_NO_NATIVE"):
        return False
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.ts_num_threads() if lib else 0


def inspect(
    indptr: np.ndarray,
    indices: np.ndarray,
    shape: Tuple[int, int],
    blocksize: Tuple[int, int],
):
    """Drop-in replacement for plan._inspect_numpy (same return contract)."""
    lib = _loaded()
    m, k = shape
    bm, bk = blocksize
    nbr = -(-m // bm)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    nnz = int(indices.shape[0])

    nslots = np.zeros((nbr,), dtype=np.int32)
    ell_width = int(lib.ts_inspect_count(indptr, m, indices, k, bm, bk, nslots))
    block_cols = np.zeros((nbr, ell_width), dtype=np.int32)
    scatter_idx = np.zeros((nnz,), dtype=np.int64)
    lib.ts_inspect_fill(indptr, m, indices, k, bm, bk, ell_width, block_cols, scatter_idx)
    if scatter_idx.size and scatter_idx.max(initial=0) < np.iinfo(np.int32).max:
        scatter_idx = scatter_idx.astype(np.int32)
    nblocks = int(nslots.sum())
    return block_cols, nslots, scatter_idx, ell_width, nblocks


def spgemm_symbolic(
    a_indptr: np.ndarray,
    a_indices: np.ndarray,
    b_indptr: np.ndarray,
    b_indices: np.ndarray,
    m: int,
    n: int,
):
    """Native SpGEMM symbolic pass: C's CSR pattern and the multiplication
    schedule (a_pos, b_pos, c_pos) sorted by c_pos.

    Returns (c_indptr, c_indices, a_pos, b_pos, c_pos), all int32, or None
    if the schedule would overflow int32 indexing (the caller raises).
    """
    lib = _loaded()
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int32)
    a_indices = np.ascontiguousarray(a_indices, dtype=np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, dtype=np.int32)
    b_indices = np.ascontiguousarray(b_indices, dtype=np.int32)
    c_indptr = np.zeros((m + 1,), dtype=np.int32)
    c_nnz = int(lib.ts_spgemm_count(a_indptr, m, a_indices, b_indptr, b_indices, n, c_indptr))
    if c_nnz < 0:
        return None
    nmul = int(np.diff(b_indptr.astype(np.int64))[a_indices].sum())
    c_indices = np.zeros((c_nnz,), dtype=np.int32)
    a_pos = np.zeros((nmul,), dtype=np.int32)
    b_pos = np.zeros((nmul,), dtype=np.int32)
    c_pos = np.zeros((nmul,), dtype=np.int32)
    lib.ts_spgemm_fill(a_indptr, m, a_indices, b_indptr, b_indices, n, c_indptr, c_indices,
                       a_pos, b_pos, c_pos)
    return c_indptr, c_indices, a_pos, b_pos, c_pos


def factorize_inplace(
    kind: str, indptr: np.ndarray, indices: np.ndarray, vals64: np.ndarray
) -> int:
    """Native ILU(0)/IC(0) value pass on fp64 values IN PLACE.

    kind: 'ilu0' (full square pattern, sorted, diagonal present) or 'ic0'
    (lower-triangular pattern, diagonal last per row). Returns 0 on
    success, -(i+1) for a structural/pivot failure at row i.
    """
    lib = _loaded()
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    if vals64.dtype != np.float64 or not vals64.flags.c_contiguous:
        raise ValueError("factorize_inplace takes a C-contiguous float64 value array")
    if kind not in ("ilu0", "ic0"):
        raise ValueError(f"unknown factorization {kind!r}; options 'ilu0', 'ic0'")
    fn = lib.ts_ilu0 if kind == "ilu0" else lib.ts_ic0
    return int(fn(indptr, indices, indptr.shape[0] - 1, vals64))


def coo_to_csr(rows: np.ndarray, m: int):
    """Native counting sort: (indptr (m+1,) int32, order (nnz,) int64)
    with csr_entry[i] = coo_entry[order[i]] (stable within rows)."""
    lib = _loaded()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    nnz = int(rows.shape[0])
    indptr = np.zeros((m + 1,), dtype=np.int32)
    order = np.zeros((nnz,), dtype=np.int64)
    lib.ts_coo_to_csr(rows, nnz, m, indptr, order)
    return indptr, order


def aggregate(
    indptr: np.ndarray, indices: np.ndarray, strong: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Native greedy strength-graph aggregation: (agg (n,) int64, n_agg),
    equal to the JAX package's Python pass (tpusparse/amg.py `_aggregate`)."""
    lib = _loaded()
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    strong = np.ascontiguousarray(strong, dtype=np.uint8)
    n = indptr.shape[0] - 1
    agg = np.empty(n, np.int64)
    n_agg = int(lib.ts_aggregate(indptr, indices, strong, n, agg))
    return agg, n_agg
