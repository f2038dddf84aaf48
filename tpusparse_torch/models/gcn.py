"""Graph Convolutional Network: sparse message passing as SpMM.

Counterpart of `tpusparse/models/gcn.py`. Each layer is H' = Â (H W) + b
(Kipf & Welling 2017), Â the symmetrically normalised adjacency with self
loops; the dense projection runs first and the aggregation rides
`ops.spmm` with the layer's `spmm_method`. With 'naive' every layer's
forward is one launch of the naive SpMM kernel (csrc/naive_spmm.cu) and its
backward none: Â's values need no gradient, and dB is a scatter-add, as in
JAX.

Differences from the flax modules: the input width is given to the
constructor (flax infers it), weights come from the reference init on the
CPU from `generator` (`nn/layers.py`), and the default `spmm_method` is
'tiled', since the JAX default 'auto' (the router) is not ported yet
(ROADMAP queue 1, item 7). The child modules carry flax's names
(`conv{i}`, `head`, and each layer's `DenseLinear_0`), so
`convert.load_flax_params` maps a flax tree one to one. optax's `adam`
becomes `torch.optim.Adam` with the same arguments (b1 0.9, b2 0.999, eps
1e-8): the same update, m̂ / (√v̂ + eps), rounded otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as ssp
import torch
import torch.nn.functional as F
from torch import nn

from tpusparse_torch import ops
from tpusparse_torch.elementwise import sp_add
from tpusparse_torch.linalg import speye
from tpusparse_torch.nn.layers import DenseLinear
from tpusparse_torch.types import CSR
from tpusparse_torch.utils.config import resolve_device


def normalized_adjacency(adj: CSR, add_self_loops: bool = True) -> CSR:
    """Â = D^(-1/2) (A + I) D^(-1/2), the GCN propagation operator. The
    pattern work is on the host; the value pass is tensor code on the
    device of `adj.data`, differentiable in its values."""
    dev = adj.data.device
    a1 = sp_add(adj, speye(adj.shape[0], adj.dtype, device=dev)) if add_self_loops else adj
    rows = torch.from_numpy(a1.row_ids().astype(np.int64)).to(dev)
    cols = torch.from_numpy(np.asarray(a1.indices, dtype=np.int64)).to(dev)
    deg = torch.zeros((a1.shape[0],), dtype=a1.dtype, device=dev).index_add(0, rows, a1.data)
    d_is = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
    return CSR(data=a1.data * d_is[rows] * d_is[cols], indices=a1.indices,
               indptr=a1.indptr, shape=a1.shape)


class GCNLayer(nn.Module):
    """One graph convolution: Â @ (X W) + b's aggregation, X (n, f_in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 spmm_method: str = "tiled", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spmm_method = spmm_method
        self.DenseLinear_0 = DenseLinear(in_features, features, use_bias=use_bias,
                                         device=device, generator=generator)

    def forward(self, a_hat: CSR, x: torch.Tensor) -> torch.Tensor:
        return ops.spmm(a_hat, self.DenseLinear_0(x), method=self.spmm_method)


class GCN(nn.Module):
    """Node-classification GCN: hidden graph convolutions with ReLU (and
    dropout when `dropout` > 0 and not `deterministic`), then a graph-conv
    head to log-probabilities."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (64,),
                 num_classes: int = 7, dropout: float = 0.0, spmm_method: str = "tiled",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        widths = [in_features, *hidden]
        for i, h in enumerate(hidden):
            setattr(self, f"conv{i + 1}", GCNLayer(widths[i], h, spmm_method=spmm_method,
                                                   device=device, generator=generator))
        self.num_hidden = len(hidden)
        self.head = GCNLayer(widths[-1], num_classes, spmm_method=spmm_method, device=device,
                             generator=generator)

    def forward(self, a_hat: CSR, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"conv{i + 1}")(a_hat, x))
            if self.dropout > 0.0:
                x = F.dropout(x, self.dropout, training=not deterministic)
        return torch.log_softmax(self.head(a_hat, x), dim=-1)


def random_graph(seed: int, num_nodes: int, avg_degree: float = 8.0,
                 dtype=torch.float32, device=None) -> CSR:
    """Random undirected graph as a symmetric binary CSR adjacency: the JAX
    package's numpy and scipy draws, so the arrays equal JAX's for a seed."""
    rng = np.random.default_rng(seed)
    ne = int(num_nodes * avg_degree / 2)
    src = rng.integers(0, num_nodes, ne)
    dst = rng.integers(0, num_nodes, ne)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    a = ssp.coo_matrix((np.ones(src.size, np.float32), (src, dst)),
                       shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float32).tocsr()
    a.sort_indices()
    out = CSR.from_scipy(a, device=device)
    return CSR(out.data.to(dtype), out.indices, out.indptr, out.shape)


def two_cluster_graph(seed: int, nodes_per_cluster: int = 64, p_in: float = 0.2,
                      p_out: float = 0.01, device=None) -> Tuple[CSR, np.ndarray]:
    """Planted-partition graph and its labels, the JAX package's draws."""
    rng = np.random.default_rng(seed)
    n = 2 * nodes_per_cluster
    labels = np.repeat(np.arange(2), nodes_per_cluster)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((n, n)) < prob, k=1)
    dense = (upper | upper.T).astype(np.float32)
    return CSR.from_dense(dense, device=device), labels


def make_train_state(model: nn.Module, learning_rate: float = 1e-2) -> torch.optim.Adam:
    """Adam over the model's parameters with optax's defaults."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the nodes where `mask` is set (gcn.py:166-168)."""
    nll = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, a_hat: CSR,
               x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One full-batch node-classification step on the masked NLL; returns
    the loss (detached, on the model's device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = masked_nll(model(a_hat, x), labels, mask)
    loss.backward()
    optimizer.step()
    return loss.detach()
