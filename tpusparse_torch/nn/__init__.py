from tpusparse_torch.nn.attention import (
    BigBirdAttention,
    LocalAttention,
    SelfAttention,
    SparseSelfAttention,
    banded_blocks,
    bigbird_block_mask,
    bigbird_pattern,
    local_global_pattern,
    route_sparse_attention,
)
from tpusparse_torch.nn.layers import (
    BlockSparseLinear,
    DenseLinear,
    Embed,
    LayerNorm,
    Pattern,
    SparseLinear,
)

__all__ = [
    "BigBirdAttention",
    "BlockSparseLinear",
    "DenseLinear",
    "Embed",
    "LayerNorm",
    "LocalAttention",
    "Pattern",
    "SelfAttention",
    "SparseLinear",
    "SparseSelfAttention",
    "banded_blocks",
    "bigbird_block_mask",
    "bigbird_pattern",
    "local_global_pattern",
    "route_sparse_attention",
]
