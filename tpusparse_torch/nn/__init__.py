from tpusparse_torch.nn.layers import (
    BlockSparseLinear,
    DenseLinear,
    Pattern,
    SparseLinear,
)

__all__ = ["BlockSparseLinear", "DenseLinear", "Pattern", "SparseLinear"]
