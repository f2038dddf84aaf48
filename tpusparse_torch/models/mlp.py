"""MNIST MLP (forward) for the port.

Counterpart of `tpusparse/models/mlp.py:26-66`: one model class with a
backend variant, an optional hidden layer, log_softmax output, and the NLL
loss. The training step (`make_train_state`, `train_step`, `train_epoch`)
comes with the training slice (ROADMAP.md, "Next slice").
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpusparse_torch.nn.layers import (
    BlockSparseLinear,
    DenseLinear,
    Pattern,
    SparseLinear,
    _uniform,
)
from tpusparse_torch.utils.config import resolve_device

VARIANTS = ("xla", "dense", "sparse", "blocksparse")


class MnistNet(nn.Module):
    """variant: 'xla' (plain `nn.Linear`, the control), 'dense' (the port's
    dense matmul), 'sparse' (block-ELL SpMM on the nnz value vector),
    'blocksparse' (packed-block weights). Layers are `fc1`, `fc2`, ...;
    the patterns of layer i come from `Pattern.random(pattern_seed + i)`,
    as in the JAX model, so both packages hold the same patterns."""

    def __init__(
        self,
        variant: str = "dense",
        hidden: Optional[int] = None,
        num_classes: int = 10,
        in_features: int = 784,
        sparse_density: float = 0.1,
        pattern_seed: int = 0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        device = resolve_device(device)
        self.variant = variant
        dims = ([hidden] if hidden else []) + [num_classes]
        d_in = in_features
        for i, d in enumerate(dims):
            kw = dict(device=device, generator=generator)
            if variant == "xla":
                layer = nn.utils.skip_init(nn.Linear, d_in, d, device=device)
                with torch.no_grad():  # U(±1/√fan_in), from `generator`
                    layer.weight.copy_(_uniform((d, d_in), d_in, generator))
                    layer.bias.copy_(_uniform((d,), d_in, generator))
            elif variant == "dense":
                layer = DenseLinear(d_in, d, **kw)
            else:
                pat = Pattern.random(pattern_seed + i, (d, d_in), sparse_density)
                cls = SparseLinear if variant == "sparse" else BlockSparseLinear
                layer = cls(pattern=pat, **kw)
            self.add_module(f"fc{i + 1}", layer)
            d_in = d
        self.num_layers = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i + 1}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return torch.log_softmax(x, dim=-1)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLLLoss on log_softmax outputs (mean over the batch)."""
    return -torch.gather(log_probs, 1, labels.long()[:, None]).mean()

