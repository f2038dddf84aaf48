"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

The sparse MNIST MLP trains and serves on three hand-written CUDA kernels:
the block-ELL SpMM executor (`csrc/block_ell_spmm.cu`, the forward and the
dB of the backward through the transpose plan), the block-pattern SDDMM
(`csrc/sddmm.cu`, the dA) and the dense GEMM (`csrc/gemm.cu`, the dense
ops when `use_gemm_kernel` is set). Tensors on the CPU take the plain
PyTorch version of each kernel; `device=None` everywhere means the CUDA
card. The JAX package `tpusparse` is the reference the port is held
against; nothing here imports it.
"""

from tpusparse_torch import dense, kernels, ops
from tpusparse_torch.convert import load_flax_params, to_flax_params
from tpusparse_torch.models import (
    MnistNet,
    make_train_state,
    nll_loss,
    train_epoch,
    train_step,
)
from tpusparse_torch.nn import BlockSparseLinear, DenseLinear, Pattern, SparseLinear
from tpusparse_torch.ops import (
    mm,
    resident_spmm,
    sddmm,
    spmm,
    spmm_blocks,
    tiled_spmm,
    transa_mm,
    transab_mm,
    transb_mm,
)
from tpusparse_torch.plan import (
    Plan,
    block_transpose_plan,
    build_plan,
    build_plan_pair,
    clear_plan_cache,
    plan_cache_info,
)
from tpusparse_torch.types import (
    COO,
    CSR,
    coo_to_csr,
    csr_to_coo,
    random_csr,
    sddmm_reference,
    spmm_reference,
)
from tpusparse_torch.utils.config import get_config, resolve_device, set_config

__all__ = [
    "BlockSparseLinear",
    "COO",
    "CSR",
    "DenseLinear",
    "MnistNet",
    "Pattern",
    "Plan",
    "SparseLinear",
    "block_transpose_plan",
    "build_plan",
    "build_plan_pair",
    "clear_plan_cache",
    "coo_to_csr",
    "csr_to_coo",
    "dense",
    "get_config",
    "kernels",
    "load_flax_params",
    "make_train_state",
    "mm",
    "nll_loss",
    "ops",
    "plan_cache_info",
    "random_csr",
    "resident_spmm",
    "resolve_device",
    "sddmm",
    "sddmm_reference",
    "set_config",
    "spmm",
    "spmm_blocks",
    "spmm_reference",
    "tiled_spmm",
    "to_flax_params",
    "train_epoch",
    "train_step",
    "transa_mm",
    "transab_mm",
    "transb_mm",
]
