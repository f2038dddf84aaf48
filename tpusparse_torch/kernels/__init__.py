from tpusparse_torch.kernels.tiled_spmm import (
    launch_counts,
    reset_launch_counts,
    resident_spmm_kernel,
    tiled_spmm_kernel,
)

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "resident_spmm_kernel",
    "tiled_spmm_kernel",
]
