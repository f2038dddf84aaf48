"""BERT-style multi-head self-attention as a `torch.nn.Module`.

Counterpart of `tpusparse/nn/attention.py:370-418` (`SelfAttention`). The
query, key, value and output projections are the port's `DenseLinear`s,
named as the flax submodules. Q, K and V are kept in the JAX layout
(batch, heads, seq, head_dim) at every function they reach, so the tests
compare like with like.

  fused=False  the reference workload: scores = transb_mm(q, k) / sqrt(hd)
               on the dense ops, causal and user masks fill with -1e9, then
               softmax and mm(probs, v);
  fused=True   `flash_attention_diff`: the flash forward, dq and dk/dv
               kernels (csrc/flash_attention.cu); causal masking only.

The pattern variants of the JAX module file (`LocalAttention`,
`SparseSelfAttention`, `BigBirdAttention`) come with ROADMAP queue 1,
item 12.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpusparse_torch import ops
from tpusparse_torch.kernels.flash_attention import flash_attention_diff
from tpusparse_torch.nn.layers import DenseLinear


class SelfAttention(nn.Module):
    """Multi-head self-attention over (batch, seq, hidden) inputs.

    hidden is the input width (flax infers it at init); the projections map
    it to num_heads * head_dim and back.
    """

    def __init__(self, num_heads: int, head_dim: int, fused: bool = False,
                 causal: bool = False, *, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.fused, self.causal = fused, causal
        d = num_heads * head_dim
        kw = dict(device=device, generator=generator)
        self.query = DenseLinear(hidden, d, **kw)
        self.key = DenseLinear(hidden, d, **kw)
        self.value = DenseLinear(hidden, d, **kw)
        self.out = DenseLinear(d, hidden, **kw)

    def forward(self, hidden: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = hidden.shape
        d = self.num_heads * self.head_dim

        def split(x):  # (b, s, d) -> (b, heads, s, head_dim)
            return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        if self.fused:
            if mask is not None:
                raise ValueError(
                    "fused attention supports causal masking only; pass "
                    "causal=True or use the unfused path for custom masks"
                )
            ctx = flash_attention_diff(q, k, v, self.causal, None)
        else:
            scores = ops.transb_mm(q, k) / math.sqrt(self.head_dim)
            if self.causal:
                tril = torch.ones((s, s), dtype=torch.bool, device=scores.device).tril()
                scores = torch.where(tril, scores, -1e9)
            if mask is not None:
                scores = torch.where(mask, scores, -1e9)
            ctx = ops.mm(torch.softmax(scores, dim=-1), v)
        return self.out(ctx.transpose(1, 2).reshape(b, s, d))
