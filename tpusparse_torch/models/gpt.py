"""GPT-style causal decoder with a KV-cache decode loop.

Counterpart of `tpusparse/models/gpt.py:29-227` as `torch.nn.Module`s, with
the flax submodule names (`block{i}` with `ln1`, `q_proj`, `k_proj`,
`v_proj`, `o_proj`, `ln2`, `fc1`, `fc2`; `tok_emb`, `pos_emb`, `final_ln`,
`lm_head`), so `convert.load_flax_params` carries a flax `GPTDecoder` tree
across. The blocks are pre-LN: causal multi-head self-attention and a tanh
GELU MLP, each with its residual. The linears are the port's `DenseLinear`,
the norms flax's `LayerNorm` (eps 1e-6), the embeddings `Embed`.

Three entry points share one set of weights:
  * `forward(ids)`: full causal logits. With `fused=True` the attention runs
    on the causal flash kernels (`flash_attention_diff`), otherwise as dense
    products with a -1e9 causal mask;
  * `prefill(ids)`: logits and a KV cache seeded with the prompt, static
    (b, h, max_position, d) buffers as in JAX;
  * `decode_step(tok, cache, pos)`: one token against the cache, attending
    over the whole max_position buffer with a `<= pos` mask. The port writes
    the new token's k and v into the cache buffers in place (JAX returns
    updated copies) and returns the same buffers.
`generate` drives them greedily; JAX's `lax.scan` becomes a Python loop.
No kernel runs on `prefill`, `decode_step` or `generate`, as in JAX, where
they are einsums: their products go to `torch.matmul` with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpusparse_torch import dense
from tpusparse_torch.kernels.flash_attention import flash_attention_diff
from tpusparse_torch.nn.layers import DenseLinear, Embed, LayerNorm

MASKED = -1e9  # the JAX model's masked score


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, s, hidden) -> (b, heads, s, head_dim)."""
    b, s, hidden = x.shape
    return x.reshape(b, s, num_heads, hidden // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, heads, s, head_dim) -> (b, s, hidden)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _attend(q, k, v, visible):
    """softmax(q·kᵀ/√d, masked to `visible`)·v on the dense products."""
    scores = dense.matmul(q, k, transb=True) / q.shape[-1] ** 0.5
    probs = torch.softmax(torch.where(visible, scores, MASKED), dim=-1)
    return dense.matmul(probs, v)


class GPTBlock(nn.Module):
    """Pre-LN decoder block: causal MHSA + MLP, residual both."""

    def __init__(self, hidden: int, num_heads: int, intermediate: int, fused: bool = False,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads, self.fused = num_heads, fused
        self.ln1 = LayerNorm(hidden, device=device)
        self.q_proj = DenseLinear(hidden, hidden, **kw)
        self.k_proj = DenseLinear(hidden, hidden, **kw)
        self.v_proj = DenseLinear(hidden, hidden, **kw)
        self.o_proj = DenseLinear(hidden, hidden, **kw)
        self.ln2 = LayerNorm(hidden, device=device)
        self.fc1 = DenseLinear(hidden, intermediate, **kw)
        self.fc2 = DenseLinear(intermediate, hidden, **kw)

    def _qkv(self, x):
        h = self.ln1(x)
        return tuple(split_heads(p(h), self.num_heads) for p in (self.q_proj, self.k_proj,
                                                                   self.v_proj))

    def _finish(self, x, ctx):
        x = x + self.o_proj(merge_heads(ctx))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))

    def _causal(self, q, k, v, fused: bool):
        if fused:
            return flash_attention_diff(q, k, v, True, None)
        s = q.shape[2]
        return _attend(q, k, v, torch.ones((s, s), dtype=torch.bool, device=q.device).tril())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal pass (training, scoring): on the flash
        kernels when `fused`."""
        q, k, v = self._qkv(x)
        return self._finish(x, self._causal(q, k, v, self.fused))

    def prefill(self, x: torch.Tensor):
        """(out, k, v): the causal pass on the dense products, as in JAX
        whatever `fused` says, and this block's full K/V, (b, h, s, d)."""
        q, k, v = self._qkv(x)
        return self._finish(x, self._causal(q, k, v, False)), k, v

    def decode(self, x1: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int):
        """One-token step. x1 (b, 1, hidden); cache_k/v (b, h, L, d), written
        at slot `pos` in place. Returns (out (b, 1, hidden), cache_k, cache_v)."""
        q, k, v = self._qkv(x1)  # (b, h, 1, d) each
        cache_k[:, :, pos] = k[:, :, 0]
        cache_v[:, :, pos] = v[:, :, 0]
        visible = torch.arange(cache_k.shape[2], device=x1.device) <= pos
        return self._finish(x1, _attend(q, cache_k, cache_v, visible)), cache_k, cache_v


class GPTDecoder(nn.Module):
    """Causal LM: token and position embeddings, `num_layers` GPTBlocks
    named block0, block1, ..., a final LayerNorm and the LM head."""

    def __init__(self, num_layers: int = 4, hidden: int = 256, num_heads: int = 4,
                 intermediate: int = 1024, vocab_size: int = 1000, max_position: int = 512,
                 fused: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_layers, self.num_heads, self.max_position = num_layers, num_heads, max_position
        self.tok_emb = Embed(vocab_size, hidden, **kw)
        self.pos_emb = Embed(max_position, hidden, **kw)
        for i in range(num_layers):
            self.add_module(f"block{i}", GPTBlock(hidden, num_heads, intermediate, fused, **kw))
        self.final_ln = LayerNorm(hidden, device=device)
        self.lm_head = DenseLinear(hidden, vocab_size, **kw)

    @property
    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.tok_emb(ids) + self.pos_emb(pos)[None]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self._embed(ids)
        for blk in self.blocks:
            x = blk(x)
        return self.lm_head(self.final_ln(x))

    def prefill(self, ids: torch.Tensor):
        """(logits (b, s, vocab), (cache_k, cache_v)): one (b, h,
        max_position, d) buffer per layer in each tuple, seeded with the
        prompt's K/V and zero past it."""
        x = self._embed(ids)
        pad = (0, 0, 0, self.max_position - ids.shape[1])
        ck, cv = [], []
        for blk in self.blocks:
            x, k, v = blk.prefill(x)
            ck.append(F.pad(k, pad))
            cv.append(F.pad(v, pad))
        return self.lm_head(self.final_ln(x)), (tuple(ck), tuple(cv))

    def decode_step(self, tok: torch.Tensor, cache, pos: int):
        """tok (b,) ids at position `pos`; cache from `prefill`, updated in
        place. Returns (logits (b, vocab), cache)."""
        x = self.tok_emb(tok[:, None]) + self.pos_emb.embedding[pos][None, None]
        ck, cv = cache
        for blk, k, v in zip(self.blocks, ck, cv):
            x, _, _ = blk.decode(x, k, v, pos)
        return self.lm_head(self.final_ln(x))[:, 0, :], cache


def check_fits(prompt_len: int, steps: int, max_position: int) -> None:
    """prompt_len + steps must fit max_position: past it the cache and the
    position table have no slot for the token."""
    if prompt_len + steps > max_position:
        raise ValueError(
            f"prompt ({prompt_len}) + steps ({steps}) exceeds max_position ({max_position})"
        )


@torch.no_grad()
def generate(model: GPTDecoder, prompt_ids: torch.Tensor, steps: int) -> torch.Tensor:
    """Greedy autoregressive generation: prefill once, then `steps` decode
    steps. Returns (b, steps) generated ids in prompt_ids' type."""
    check_fits(prompt_ids.shape[1], steps, model.max_position)
    logits, cache = model.prefill(prompt_ids)
    return _greedy(model.decode_step, logits, cache, prompt_ids, steps)


def _greedy(decode_step, logits, cache, prompt_ids, steps):
    """The decode loop of `generate`, shared with `QuantizedGPT.generate`:
    each step emits its input token and decodes the next, as JAX's scan."""
    tok = logits[:, -1, :].argmax(-1).to(prompt_ids.dtype)
    p0, out = prompt_ids.shape[1], []
    for i in range(steps):
        out.append(tok)
        logits, cache = decode_step(tok, cache, p0 + i)
        tok = logits.argmax(-1).to(prompt_ids.dtype)
    if not out:
        return prompt_ids.new_empty((prompt_ids.shape[0], 0))
    return torch.stack(out, dim=1)
