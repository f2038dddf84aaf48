from tpusparse_torch.kernels import (
    block_flash_attention,
    dia,
    flash_attention,
    gemm,
    naive_spmm,
    sddmm,
    tiled_spmm,
    windowed,
)
from tpusparse_torch.kernels.block_flash_attention import (
    BlockAttnPlan,
    blk_flash_dkv_kernel,
    blk_flash_dq_kernel,
    blk_flash_fwd_kernel,
    block_flash_attention_diff,
)
from tpusparse_torch.kernels.dia import PackedDIA, dia_spmv, dia_spmv_kernel, pack_dia_operator
from tpusparse_torch.kernels.flash_attention import (
    flash_attention_diff,
    flash_attention_q8,
    flash_dkv_kernel,
    flash_dq_kernel,
    flash_fwd_kernel,
    flash_q8_kernel,
    quantize_kv,
)
from tpusparse_torch.kernels.gemm import gemm_int8_kernel, gemm_kernel
from tpusparse_torch.kernels.naive_spmm import ell_pack, naive_spmm_kernel
from tpusparse_torch.kernels.sddmm import sddmm_kernel
from tpusparse_torch.kernels.tiled_spmm import (
    compact_spmm_kernel,
    footprint_spmm_kernel,
    grouped_spmm_kernel,
    resident_spmm_batched_kernel,
    resident_spmm_int8_kernel,
    resident_spmm_kernel,
    tiled_spmm_int8_kernel,
    tiled_spmm_kernel,
)
from tpusparse_torch.kernels.windowed import (
    WindowedGatherPlan,
    WindowedSegmentPlan,
    windowed_gather,
    windowed_gather_kernel,
    windowed_gather_plan,
    windowed_segment_plan,
    windowed_segment_sum,
    windowed_segsum_kernel,
)

_MODULES = (tiled_spmm, sddmm, gemm, flash_attention, block_flash_attention, naive_spmm,
            windowed, dia)


def launch_counts() -> dict:
    """Kernel launches per entry point of every kernel since the last reset:
    'tiled_spmm' and 'resident_spmm' (both csrc/block_ell_spmm.cu),
    'tiled_spmm_int8' and 'resident_spmm_int8' (both
    csrc/block_ell_spmm_int8.cu), 'resident_spmm_batched'
    (csrc/block_ell_spmm_batched.cu), 'compact_spmm', 'grouped_spmm' and
    'footprint_spmm' (csrc/block_ell_spmm_{compact,grouped,footprint}.cu),
    'int8_kmajor' (csrc/block_ell_spmm_int8.cu: b_q made K-major for the
    int8 executor),
    'sddmm', 'gemm', 'gemm_s8', 'flash_fwd', 'flash_dq', 'flash_dkv'
    (csrc/flash_attention.cu), 'flash_q8', 'blk_flash_fwd', 'blk_flash_dq',
    'blk_flash_dkv' (csrc/block_flash_attention.cu), 'naive_spmm',
    'windowed_gather' and 'windowed_segsum' (both csrc/windowed.cu), and
    'dia_spmv' and 'dia_nonfinite' (both csrc/dia_spmv.cu)."""
    out = {}
    for mod in _MODULES:
        out.update(mod.launch_counts())
    return out


def launches_by_kernel() -> dict:
    """`launch_counts()` summed per CUDA kernel: 'block_ell_spmm' (both
    executor entry points), 'spmm_int8' (both int8 entry points),
    'resident_spmm_batched', 'compact_spmm', 'grouped_spmm',
    'footprint_spmm', 'sddmm', 'gemm', 'gemm_s8', 'flash_fwd', 'flash_dq',
    'flash_dkv', 'flash_q8', 'blk_flash_fwd', 'blk_flash_dq',
    'blk_flash_dkv', 'naive_spmm', 'windowed_gather', 'windowed_segsum',
    'dia_spmv', 'dia_nonfinite' and 'int8_kmajor'."""
    c = launch_counts()
    return {"block_ell_spmm": c.pop("tiled_spmm") + c.pop("resident_spmm"),
            "spmm_int8": c.pop("tiled_spmm_int8") + c.pop("resident_spmm_int8"), **c}


def reset_launch_counts() -> None:
    for mod in _MODULES:
        mod.reset_launch_counts()


__all__ = [
    "BlockAttnPlan",
    "PackedDIA",
    "WindowedGatherPlan",
    "WindowedSegmentPlan",
    "blk_flash_dkv_kernel",
    "blk_flash_dq_kernel",
    "blk_flash_fwd_kernel",
    "block_flash_attention",
    "block_flash_attention_diff",
    "compact_spmm_kernel",
    "dia",
    "dia_spmv",
    "dia_spmv_kernel",
    "ell_pack",
    "flash_attention",
    "flash_attention_diff",
    "flash_attention_q8",
    "flash_dkv_kernel",
    "flash_dq_kernel",
    "flash_fwd_kernel",
    "flash_q8_kernel",
    "footprint_spmm_kernel",
    "gemm",
    "gemm_int8_kernel",
    "gemm_kernel",
    "grouped_spmm_kernel",
    "launch_counts",
    "launches_by_kernel",
    "naive_spmm",
    "naive_spmm_kernel",
    "pack_dia_operator",
    "quantize_kv",
    "reset_launch_counts",
    "resident_spmm_batched_kernel",
    "resident_spmm_int8_kernel",
    "resident_spmm_kernel",
    "sddmm",
    "sddmm_kernel",
    "tiled_spmm",
    "tiled_spmm_int8_kernel",
    "tiled_spmm_kernel",
    "windowed",
    "windowed_gather",
    "windowed_gather_kernel",
    "windowed_gather_plan",
    "windowed_segment_plan",
    "windowed_segment_sum",
    "windowed_segsum_kernel",
]
