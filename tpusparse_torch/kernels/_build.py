"""Build and load the port's CUDA kernels.

Each source under `tpusparse_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface and loaded with
ctypes. The build runs at first use, into `build/tpusparse_torch/` at the
repo root (listed in `.gitignore`), and is redone when the hash of the
source or of a shared header (`csrc/*.cuh`) changes. Several sources are
compiled by parallel `nvcc` processes.
Nothing here runs at import time: the CPU tests import every module and
have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpusparse_torch"
# every CUDA source of the port, by name (csrc/<name>.cu)
SOURCES = ("block_ell_spmm", "sddmm", "gemm", "flash_attention", "block_flash_attention",
           "block_ell_spmm_int8", "gemm_s8", "flash_attention_q8", "naive_spmm",
           "block_ell_spmm_batched", "block_ell_spmm_compact", "block_ell_spmm_grouped",
           "block_ell_spmm_footprint", "windowed", "dia_spmv")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of tpusparse_torch are built at first use on the card"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the sources that are missing or stale, all `nvcc`s at once.

    Returns {name: ptxas report} for the sources compiled now (registers,
    shared memory and spills per kernel). Raises on any compile error.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for name, (so, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        reports[name] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LOADED[name] = lib
        return lib


def bind(name: str, argtypes: Dict[str, list]) -> Dict[str, Callable]:
    """The C entry points of csrc/<name>.cu, by name, with their ctypes
    argument types; each returns an int (0 = launched)."""
    lib = load(name)
    fns = {}
    for fn_name, types in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = ctypes.c_int, types
        fns[fn_name] = fn
    return fns
