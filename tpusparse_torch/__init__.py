"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

This slice runs the forward of the sparse MNIST MLP and the block-ELL
SpMM on one hand-written CUDA kernel (`csrc/block_ell_spmm.cu`). Tensors
on the CPU take the plain PyTorch versions of each kernel; `device=None`
everywhere means the CUDA card. The JAX package `tpusparse` is the
reference the port is held against; nothing here imports it.
"""

from tpusparse_torch import dense, kernels, ops
from tpusparse_torch.convert import load_flax_params
from tpusparse_torch.models import MnistNet, nll_loss
from tpusparse_torch.nn import BlockSparseLinear, DenseLinear, Pattern, SparseLinear
from tpusparse_torch.ops import resident_spmm, spmm, spmm_blocks, tiled_spmm
from tpusparse_torch.plan import (
    Plan,
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
    "build_plan",
    "build_plan_pair",
    "clear_plan_cache",
    "coo_to_csr",
    "csr_to_coo",
    "dense",
    "get_config",
    "kernels",
    "load_flax_params",
    "nll_loss",
    "ops",
    "plan_cache_info",
    "random_csr",
    "resident_spmm",
    "resolve_device",
    "set_config",
    "spmm",
    "spmm_blocks",
    "spmm_reference",
    "tiled_spmm",
]
