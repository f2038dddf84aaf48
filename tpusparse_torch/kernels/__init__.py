from tpusparse_torch.kernels import gemm, sddmm, tiled_spmm
from tpusparse_torch.kernels.gemm import gemm_kernel
from tpusparse_torch.kernels.sddmm import sddmm_kernel
from tpusparse_torch.kernels.tiled_spmm import resident_spmm_kernel, tiled_spmm_kernel

_MODULES = (tiled_spmm, sddmm, gemm)


def launch_counts() -> dict:
    """Kernel launches per entry point of every kernel since the last reset:
    'tiled_spmm' and 'resident_spmm' (both csrc/block_ell_spmm.cu), 'sddmm'
    and 'gemm'."""
    out = {}
    for mod in _MODULES:
        out.update(mod.launch_counts())
    return out


def launches_by_kernel() -> dict:
    """`launch_counts()` summed per CUDA kernel: 'block_ell_spmm' (both
    executor entry points), 'sddmm' and 'gemm'."""
    c = launch_counts()
    return {"block_ell_spmm": c["tiled_spmm"] + c["resident_spmm"],
            "sddmm": c["sddmm"], "gemm": c["gemm"]}


def reset_launch_counts() -> None:
    for mod in _MODULES:
        mod.reset_launch_counts()


__all__ = [
    "gemm",
    "gemm_kernel",
    "launch_counts",
    "launches_by_kernel",
    "reset_launch_counts",
    "resident_spmm_kernel",
    "sddmm",
    "sddmm_kernel",
    "tiled_spmm",
    "tiled_spmm_kernel",
]
