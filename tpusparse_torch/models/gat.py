"""Graph Attention Network: separable edge scores, sparse row softmax, SpMM.

Counterpart of `tpusparse/models/gat.py`. Per head (Veličković et al.
2018): e_ij = LeakyReLU(a_src · W h_i + a_dst · W h_j) on the edge pattern,
α = row_softmax(e), h'_i = Σ_j α_ij W h_j through `ops.spmm`. With
spmm_method='naive' each head of each layer is one launch of the naive SpMM
kernel; its backward (α's values need a gradient here) is the gather and
scatter-add of `ops._gather_grads`, as in JAX.

The constructor takes the input width, the default `spmm_method` is
'tiled' (the router is not ported yet), and the parameter names are
flax's: `DenseLinear_0/kernel`, `att_src`, `att_dst`, `bias`. The train
step is `models.gcn.train_step` (Adam, the masked NLL).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpusparse_torch import dense, ops
from tpusparse_torch.elementwise import row_softmax, sp_add
from tpusparse_torch.linalg import speye
from tpusparse_torch.models.gcn import train_step  # noqa: F401  (the same step)
from tpusparse_torch.nn.layers import DenseLinear
from tpusparse_torch.types import CSR
from tpusparse_torch.utils.config import resolve_device


def add_self_loops(adj: CSR) -> CSR:
    """A + I: GAT attends over N(i) ∪ {i}. Host pattern work; call it once
    outside the step."""
    return sp_add(adj, speye(adj.shape[0], adj.dtype, device=adj.data.device))


def _glorot_uniform(shape, generator) -> torch.Tensor:
    """flax's glorot_uniform for a 2-D shape: U(±√(6 / (fan_in + fan_out)))."""
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.rand(shape, generator=generator) * (2 * limit) - limit


class GATLayer(nn.Module):
    """One multi-head graph attention layer over a CSR adjacency;
    `features` per head, heads concatenated (`concat`) or averaged."""

    def __init__(self, in_features: int, features: int, num_heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, use_bias: bool = True,
                 spmm_method: str = "tiled", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.features, self.num_heads, self.concat = features, num_heads, concat
        self.negative_slope, self.spmm_method = negative_slope, spmm_method
        self.DenseLinear_0 = DenseLinear(in_features, features * num_heads, use_bias=False,
                                         device=device, generator=generator)
        self.att_src = nn.Parameter(_glorot_uniform((num_heads, features), generator).to(device))
        self.att_dst = nn.Parameter(_glorot_uniform((num_heads, features), generator).to(device))
        out = features * num_heads if concat else features
        self.bias = nn.Parameter(torch.zeros(out, device=device)) if use_bias else None

    def forward(self, adj: CSR, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        h = self.DenseLinear_0(x).reshape(n, self.num_heads, self.features)
        src = dense.einsum("nhf,hf->nh", h, self.att_src)
        dst = dense.einsum("nhf,hf->nh", h, self.att_dst)
        dev = x.device
        rows = torch.from_numpy(adj.row_ids().astype(np.int64)).to(dev)
        cols = torch.from_numpy(np.asarray(adj.indices, dtype=np.int64)).to(dev)
        e = F.leaky_relu(src[rows] + dst[cols], self.negative_slope)  # (nnz, heads)
        outs = []
        for hd in range(self.num_heads):
            alpha = row_softmax(CSR(e[:, hd], adj.indices, adj.indptr, adj.shape))
            outs.append(ops.spmm(alpha, h[:, hd, :].contiguous(), method=self.spmm_method))
        out = torch.cat(outs, dim=-1) if self.concat else sum(outs) / self.num_heads
        return out + self.bias if self.bias is not None else out


class GAT(nn.Module):
    """Node-classification GAT: multi-head hidden layers with ELU, then a
    heads-averaged attention head to log-probabilities."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (8,), num_heads: int = 4,
                 num_classes: int = 7, negative_slope: float = 0.2,
                 spmm_method: str = "tiled", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(num_heads=num_heads, negative_slope=negative_slope, spmm_method=spmm_method,
                  device=device, generator=generator)
        width = in_features
        for i, f in enumerate(hidden):
            setattr(self, f"gat{i + 1}", GATLayer(width, f, concat=True, **kw))
            width = f * num_heads
        self.num_hidden = len(hidden)
        self.head = GATLayer(width, num_classes, concat=False, **kw)

    def forward(self, adj: CSR, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = F.elu(getattr(self, f"gat{i + 1}")(adj, x))
        return torch.log_softmax(self.head(adj, x), dim=-1)


def make_train_state(model: nn.Module, learning_rate: float = 5e-3) -> torch.optim.Adam:
    """Adam over the model's parameters with optax's defaults."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
