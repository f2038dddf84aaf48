"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

The sparse MNIST MLP trains and serves on three hand-written CUDA kernels:
the block-ELL SpMM executor (`csrc/block_ell_spmm.cu`, the forward and the
dB of the backward through the transpose plan), the block-pattern SDDMM
(`csrc/sddmm.cu`, the dA) and the dense GEMM (`csrc/gemm.cu`, the dense
ops when `use_gemm_kernel` is set). The BERT-base attention layer and
encoder train and serve with attention='flash' on the fused attention
kernels (`csrc/flash_attention.cu`: forward, dq, dk/dv), with
attention='dense' on the dense ops, and with the pattern variants 'bigbird'
and 'sparse' on the block-pattern attention kernels
(`csrc/block_flash_attention.cu`: forward, dq, dk/dv) where their pattern
routes there, or 'local' on the dense einsums. The int8 serving tier runs on
three more: `QuantizedMatrix` on the int8 block-ELL executor
(`csrc/block_ell_spmm_int8.cu`), `quantized_matmul` and `QuantizedDense` on
the s8·s8→s32 GEMM (`csrc/gemm_s8.cu`), and `flash_attention_q8` over an
int8 K/V cache (`csrc/flash_attention_q8.cu`). The GPT decoder
(`GPTDecoder`, `generate`) and its int8 serving twin (`QuantizedGPT`,
`quantize_gpt`) decode on dense products, as in JAX; `GPTDecoder(fused=True)`
runs its forward on the flash kernels. The graph models (`GCN`, `GAT`,
`APPNP`) train with Adam on `ops.spmm`: with spmm_method='naive' on the
naive SpMM kernel (`csrc/naive_spmm.cu`, every reducer of `spmm` and
`naive_spmm`), APPNP on the block SpMM executor. A 3-D B under one
sparse pattern (`spmm`, `tiled_spmm`, `resident_spmm`; 4-D through
`spmm`) runs on the batched block executor (`csrc/block_ell_spmm_batched.cu`),
`spmm(method='footprint')` and `footprint_spmm` on the footprint executor
(`csrc/block_ell_spmm_footprint.cu`), and the compact and grouped plans on
theirs (`kernels.compact_spmm_kernel`, `kernels.grouped_spmm_kernel`).
The product of two sparse matrices (`spgemm`, `CSR @ CSR`), forward and
backward, runs its host-planned schedule on the windowed gather and
segment-sum kernels (`csrc/windowed.cu`) wherever JAX's rule adopts a
window plan; its symbolic pass and the block inspector take the native
C++ inspector (`runtime/native.py`, built from `csrc/inspector.cpp`) where
a host compiler exists. The rest of the sparse algebra (`elementwise`:
`sp_hadamard`, `sp_scale`, the stacks, reductions, `permute_csr`,
`sp_kron`, the triangles, `prune_csr`; CSR's `+ - * -x`) and the torch and
scipy converters (`interop`) are host pattern passes and plain tensor
code. The banded algebra: the `DIA` container (`csr_to_dia`,
`dia_to_csr`), `dia_spmm` and `spmm(method='dia')`, the cost-model router
of `spmm(method='auto')` with JAX's TPU-fitted constants, the `linalg`
solvers (cg, bicgstab, gmres, the eigensolvers, the incomplete
factorisations) and smoothed-aggregation AMG (`amg`), whose wide levels
run on the wide-DIA SpMV kernel (`csrc/dia_spmv.cu`) and whose factored
prolongators run on the windowed kernels. Tensors on the CPU take the plain
PyTorch version of each kernel; `device=None` everywhere means the CUDA
card. The JAX package `tpusparse` is the reference the port is held
against; nothing here imports it.
"""

from tpusparse_torch import amg, dense, elementwise, interop, kernels, linalg, ops, quant
from tpusparse_torch.amg import amg_preconditioner, smoothed_aggregation_setup
from tpusparse_torch.convert import load_flax_params, to_flax_params
from tpusparse_torch.dense import bmm, einsum, matmul
from tpusparse_torch.elementwise import (
    block_diag,
    col_reduce,
    hstack,
    permute_csr,
    prune_csr,
    row_reduce,
    row_softmax,
    sp_add,
    sp_hadamard,
    sp_kron,
    sp_map,
    sp_norm,
    sp_scale,
    sp_sub,
    sp_tril,
    sp_triu,
    vstack,
)
from tpusparse_torch.linalg import speye
from tpusparse_torch.models import (
    APPNP,
    GAT,
    GCN,
    BertAttentionLayer,
    BertEncoder,
    GATLayer,
    GCNLayer,
    GPTBlock,
    GPTDecoder,
    MnistNet,
    QuantizedGPT,
    add_self_loops,
    appnp_propagate,
    bert_loss,
    bert_train_step,
    generate,
    make_train_state,
    nll_loss,
    normalized_adjacency,
    quantize_gpt,
    random_graph,
    train_epoch,
    train_step,
    two_cluster_graph,
)
from tpusparse_torch.kernels.flash_attention import flash_attention_q8, quantize_kv
from tpusparse_torch.kernels.block_flash_attention import (
    BlockAttnPlan,
    block_flash_attention,
    block_flash_attention_bwd,
    block_flash_attention_diff,
)
from tpusparse_torch.nn import (
    BigBirdAttention,
    BlockSparseLinear,
    DenseLinear,
    Embed,
    LayerNorm,
    LocalAttention,
    Pattern,
    SelfAttention,
    SparseLinear,
    SparseSelfAttention,
    bigbird_block_mask,
    bigbird_pattern,
    local_global_pattern,
    route_sparse_attention,
)
from tpusparse_torch.ops import (
    dia_spmm,
    dsmm,
    footprint_spmm,
    gather_spmm,
    mm,
    naive_spmm,
    resident_spmm,
    sddmm,
    spmm,
    spmm_blocks,
    tiled_spmm,
    transa_mm,
    transab_mm,
    transb_mm,
    transpose_csr,
)
from tpusparse_torch.plan import (
    CompactPlan,
    FootprintPlan,
    GroupedPlan,
    Plan,
    block_transpose_plan,
    build_plan,
    build_plan_pair,
    clear_plan_cache,
    compact_plan,
    footprint_plan,
    group_plan,
    load_plan,
    plan_cache_info,
    save_plan,
    set_roofline_constants,
)
from tpusparse_torch.quant import QuantizedDense, QuantizedMatrix, quantized_matmul
from tpusparse_torch.spgemm import SpGEMMPlan, spgemm, spgemm_plan
from tpusparse_torch.types import (
    BSR,
    COO,
    CSR,
    DIA,
    bsr_to_csr,
    coo_to_csr,
    csr_to_bsr,
    csr_to_coo,
    csr_to_dia,
    dia_to_csr,
    random_coo,
    random_csr,
    random_powerlaw_csr,
    sddmm_reference,
    spmm_reference,
)
from tpusparse_torch.utils.config import get_config, resolve_device, set_config

__all__ = [
    "APPNP",
    "BertAttentionLayer",
    "BertEncoder",
    "BigBirdAttention",
    "BlockAttnPlan",
    "BlockSparseLinear",
    "BSR",
    "COO",
    "CSR",
    "CompactPlan",
    "DIA",
    "DenseLinear",
    "Embed",
    "FootprintPlan",
    "GAT",
    "GATLayer",
    "GCN",
    "GCNLayer",
    "GPTBlock",
    "GPTDecoder",
    "GroupedPlan",
    "LayerNorm",
    "LocalAttention",
    "MnistNet",
    "Pattern",
    "Plan",
    "QuantizedDense",
    "QuantizedGPT",
    "QuantizedMatrix",
    "SelfAttention",
    "SparseLinear",
    "SparseSelfAttention",
    "SpGEMMPlan",
    "add_self_loops",
    "amg",
    "amg_preconditioner",
    "appnp_propagate",
    "bert_loss",
    "bert_train_step",
    "bigbird_block_mask",
    "bigbird_pattern",
    "block_diag",
    "block_flash_attention",
    "block_flash_attention_bwd",
    "block_flash_attention_diff",
    "block_transpose_plan",
    "bmm",
    "bsr_to_csr",
    "build_plan",
    "build_plan_pair",
    "clear_plan_cache",
    "col_reduce",
    "compact_plan",
    "coo_to_csr",
    "csr_to_bsr",
    "csr_to_coo",
    "csr_to_dia",
    "dense",
    "dia_spmm",
    "dia_to_csr",
    "dsmm",
    "einsum",
    "elementwise",
    "flash_attention_q8",
    "footprint_plan",
    "footprint_spmm",
    "gather_spmm",
    "generate",
    "get_config",
    "group_plan",
    "hstack",
    "interop",
    "kernels",
    "linalg",
    "load_flax_params",
    "load_plan",
    "local_global_pattern",
    "make_train_state",
    "matmul",
    "mm",
    "naive_spmm",
    "nll_loss",
    "normalized_adjacency",
    "ops",
    "permute_csr",
    "plan_cache_info",
    "prune_csr",
    "quant",
    "quantize_gpt",
    "quantize_kv",
    "quantized_matmul",
    "random_coo",
    "random_csr",
    "random_graph",
    "random_powerlaw_csr",
    "resident_spmm",
    "resolve_device",
    "route_sparse_attention",
    "row_reduce",
    "row_softmax",
    "save_plan",
    "sddmm",
    "sddmm_reference",
    "set_config",
    "set_roofline_constants",
    "smoothed_aggregation_setup",
    "sp_hadamard",
    "sp_kron",
    "sp_map",
    "sp_norm",
    "sp_scale",
    "sp_sub",
    "sp_tril",
    "sp_triu",
    "spgemm",
    "spgemm_plan",
    "spmm",
    "spmm_blocks",
    "sp_add",
    "speye",
    "spmm_reference",
    "tiled_spmm",
    "to_flax_params",
    "train_epoch",
    "train_step",
    "transa_mm",
    "transab_mm",
    "transb_mm",
    "transpose_csr",
    "two_cluster_graph",
    "vstack",
]
