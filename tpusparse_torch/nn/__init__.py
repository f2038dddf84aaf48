from tpusparse_torch.nn.attention import SelfAttention
from tpusparse_torch.nn.layers import (
    BlockSparseLinear,
    DenseLinear,
    Embed,
    LayerNorm,
    Pattern,
    SparseLinear,
)

__all__ = [
    "BlockSparseLinear",
    "DenseLinear",
    "Embed",
    "LayerNorm",
    "Pattern",
    "SelfAttention",
    "SparseLinear",
]
