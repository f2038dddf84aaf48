"""APPNP: Approximate Personalized Propagation of Neural Predictions.

Counterpart of `tpusparse/models/appnp.py` (Klicpera et al. 2019). An MLP
gives per-node logits H, then K personalised-PageRank steps Z⁰ = H,
Zˡ⁺¹ = (1−α)·Â·Zˡ + α·H diffuse them over the graph: K `ops.spmm` calls on
one cached plan, a Python loop in place of `lax.fori_loop`. They take
`ops.spmm`'s default method, 'tiled' in the port (JAX's 'auto' router is not
ported yet, ROADMAP queue 1, item 7): a forward is K launches of the block
SpMM kernel and its backward K more, the dB of each step through the
transpose plan (Â's values need no gradient, so no SDDMM). The child
modules carry flax's names (`mlp{i}`, `head`); the train step is
`models.gcn.train_step`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpusparse_torch import ops
from tpusparse_torch.models.gcn import train_step  # noqa: F401  (the same step)
from tpusparse_torch.nn.layers import DenseLinear
from tpusparse_torch.types import CSR
from tpusparse_torch.utils.config import resolve_device

__all__ = ["APPNP", "appnp_propagate", "train_step"]


def appnp_propagate(a_hat: CSR, h: torch.Tensor, alpha: float = 0.1, k: int = 10
                    ) -> torch.Tensor:
    """K personalised-PageRank steps: Zˡ⁺¹ = (1−α)·Â·Zˡ + α·H."""
    z = h
    for _ in range(k):
        z = (1.0 - alpha) * ops.spmm(a_hat, z) + alpha * h
    return z


class APPNP(nn.Module):
    """MLP prediction and PPR propagation; returns log-probs like `GCN`."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (64,), num_classes: int = 2,
                 alpha: float = 0.1, k: int = 10, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.alpha, self.k = alpha, k
        width = in_features
        for i, w in enumerate(hidden):
            setattr(self, f"mlp{i + 1}", DenseLinear(width, w, device=device, generator=generator))
            width = w
        self.num_hidden = len(hidden)
        self.head = DenseLinear(width, num_classes, device=device, generator=generator)

    def forward(self, a_hat: CSR, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.num_hidden):
            h = torch.relu(getattr(self, f"mlp{i + 1}")(h))
        z = appnp_propagate(a_hat, self.head(h), self.alpha, self.k)
        return torch.log_softmax(z, dim=-1)
