"""BERT-base attention layer and encoder, and their training step.

Counterpart of `tpusparse/models/bert.py:20-124` as `torch.nn.Module`s, at
the same defaults (BERT-base: hidden 768, 12 heads of 64, intermediate
3072, vocab 30522, 512 positions) and with the flax submodule names, so
`convert.load_flax_params` carries a flax tree across. Both take an
explicit device (None = the CUDA card) and an explicit `torch.Generator`
for their seeded init.

attention='dense' is the reference workload (the score product on the
dense ops), 'flash' runs the fused attention kernels. The pattern variants
carry their masking in their pattern and refuse a user mask, as in JAX:
'local' is `LocalAttention` with the band `window`; 'sparse' is
`SparseSelfAttention` over `local_global_pattern(seq, window, num_global)`,
routed to its engine by `route_sparse_attention`; 'bigbird' is
`BigBirdAttention` with `block=window` (tpusparse/models/bert.py:62-70), on
the block-pattern kernels.

The training step is the JAX benchmark's (benchmarks/bert_attention_
benchmark.py:42-51): loss = mean(out²), SGD with lr 0.01 and momentum 0.9
(`models.mlp.make_train_state`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpusparse_torch.nn.attention import (
    BigBirdAttention,
    LocalAttention,
    SelfAttention,
    SparseSelfAttention,
)
from tpusparse_torch.nn.layers import DenseLinear, Embed, LayerNorm

PATTERN_VARIANTS = ("local", "sparse", "bigbird")


def _check_variant(attention: str) -> None:
    if attention not in ("dense", "flash") + PATTERN_VARIANTS:
        raise ValueError(
            f"unknown attention {attention!r}; options: "
            "'dense', 'flash', 'local', 'sparse', 'bigbird'"
        )


class BertAttentionLayer(nn.Module):
    """Attention block: MHSA + residual/LN + FFN (tanh GELU) + residual/LN."""

    def __init__(self, hidden: int = 768, num_heads: int = 12,
                 intermediate: int = 3072, attention: str = "dense", window: int = 64,
                 num_global: int = 0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_variant(attention)
        self.attention_kind = attention
        head_dim = hidden // num_heads
        kw = dict(device=device, generator=generator)
        if attention == "local":
            self.attention = LocalAttention(num_heads, head_dim, window=window, hidden=hidden,
                                            **kw)
        elif attention == "sparse":
            self.attention = SparseSelfAttention(num_heads, head_dim, window=window,
                                                 num_global=num_global, hidden=hidden, **kw)
        elif attention == "bigbird":
            self.attention = BigBirdAttention(num_heads, head_dim, block=window, hidden=hidden,
                                              **kw)
        else:
            self.attention = SelfAttention(num_heads, head_dim, fused=attention == "flash",
                                           hidden=hidden, **kw)
        self.ln1 = LayerNorm(hidden, device=device)
        self.ffn_in = DenseLinear(hidden, intermediate, **kw)
        self.ffn_out = DenseLinear(intermediate, hidden, **kw)
        self.ln2 = LayerNorm(hidden, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.attention_kind in PATTERN_VARIANTS:
            if mask is not None:
                raise ValueError(
                    f"attention={self.attention_kind!r} does not accept a mask "
                    "(its sparsity pattern IS the mask); use 'dense'"
                )
            attn = self.attention(x)
        else:
            attn = self.attention(x, mask)
        x = self.ln1(x + attn)
        h = F.gelu(self.ffn_in(x), approximate="tanh")  # flax nn.gelu is the tanh form
        return self.ln2(x + self.ffn_out(h))


class BertEncoder(nn.Module):
    """Token and position embeddings, LayerNorm, then `num_layers` attention
    blocks named layer0, layer1, ..."""

    def __init__(self, num_layers: int = 12, hidden: int = 768, num_heads: int = 12,
                 intermediate: int = 3072, vocab_size: int = 30522,
                 max_position: int = 512, attention: str = "dense", window: int = 64,
                 num_global: int = 0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_variant(attention)
        kw = dict(device=device, generator=generator)
        self.num_layers = num_layers
        self.tok_emb = Embed(vocab_size, hidden, **kw)
        self.pos_emb = Embed(max_position, hidden, **kw)
        self.emb_ln = LayerNorm(hidden, device=device)
        for i in range(num_layers):
            self.add_module(f"layer{i}", BertAttentionLayer(
                hidden, num_heads, intermediate, attention, window, num_global, **kw))

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.emb_ln(self.tok_emb(input_ids) + self.pos_emb(pos)[None])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        return x


def bert_loss(out: torch.Tensor) -> torch.Tensor:
    """The benchmark's loss: mean(out²)."""
    return out.square().mean()


def bert_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    inputs: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step on mean(model(inputs)²); returns the loss (detached, on
    the model's device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = bert_loss(model(inputs, mask))
    loss.backward()
    optimizer.step()
    return loss.detach()
