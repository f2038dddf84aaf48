"""Serving-tier GPT decode: int8 weights and an int8 KV cache.

Counterpart of `tpusparse/models/serving.py:49-378`. `quantize_gpt(model)`
turns a `GPTDecoder` (the training artifact) into a `QuantizedGPT` (the
deployment artifact):
  * every linear weight int8 per output channel (`_qrow`: scale
    max|row| / 127, an all-zero row scale 1), stored transposed (in, out);
    the q, k and v projections fused into one [q|k|v] weight, whose
    per-channel scales concatenate exactly;
  * the embeddings bf16 (a row gather, not a product), the LayerNorms fp32;
  * the KV cache int8 with per-(layer, batch, head) scales fixed at prefill
    (`quantize_kv`); each decoded token is quantized into those scales,
    clipped to ±127: the serving contract takes the prompt's range as the
    cache's.

Products. A linear is a bf16 product with fp32 sums and an fp32 result
(JAX's `preferred_element_type=float32`): the activations and the int8
weights (exact in bf16) are rounded to bf16, each product is exact and the
sums are fp32; the decode attention's two products likewise, over the int8
cache. On the card these are `torch.mm`/`torch.bmm` with `out_dtype=float32`
on bf16 operands (cuBLAS, fp32 accumulation); the int8 → bf16 convert is a
separate pass before each product, not fused into it. On the CPU they are
fp32 products of the bf16-rounded operands, which sum the same exact
products in another order. No kernel of the port runs here: the JAX
package runs these as XLA dots, not Pallas kernels (a Pallas int8-stream
kernel was tried there and rejected).

Cache layout: one layout for every batch, head-major (b, h, max_position,
d) int8. The JAX package switches to a flat (b, max_position, h·d) buffer at
batch ≤ 2 to dodge a TPU relayout on each append (`_FLAT_BATCH_MAX`); that
is a TPU workaround and is not carried.

`prefill` runs its attention in fp32 (a one-off per prompt), as JAX does.
`generate` is a Python loop of `decode_step`s (JAX: one `lax.scan`) and
keeps the `max_position` check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from tpusparse_torch import dense
from tpusparse_torch.kernels.flash_attention import quantize_kv
from tpusparse_torch.models.gpt import (
    MASKED,
    GPTDecoder,
    _greedy,
    check_fits,
    merge_heads,
    split_heads,
)
from tpusparse_torch.quant import quantize_rows
from tpusparse_torch.utils.config import fp32_matmul

__all__ = ["QuantizedGPT", "quantize_gpt"]


def _dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16, fp32 sums, fp32 result.
    a (..., m, k), b (k, n) or (..., k, n) with a's batch dims."""
    if a.device.type == "cuda":
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if b.ndim == 2:
            out = torch.mm(a16.reshape(-1, a.shape[-1]), b16, out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        out = torch.bmm(a16.reshape(-1, *a.shape[-2:]), b16.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    with fp32_matmul():
        return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def _qrow(w: torch.Tensor):
    """Per-output-channel symmetric int8 of a DenseLinear kernel (out, in),
    `quantize_rows`' contract: (the int8 weight transposed to (in, out), the
    (out,) fp32 scales)."""
    q, s = quantize_rows(w)
    return q.t().contiguous(), s


@dataclass(eq=False)
class _QLinear:
    qw: torch.Tensor  # (in, out) int8
    sw: torch.Tensor  # (out,) fp32
    b: torch.Tensor   # (out,) fp32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _dot_bf16(x, self.qw) * self.sw + self.b


@dataclass(eq=False)
class _QBlock:
    ln1: Tuple[torch.Tensor, torch.Tensor]  # (scale, bias)
    ln2: Tuple[torch.Tensor, torch.Tensor]
    qkv: _QLinear  # fused [q|k|v]: (hidden, 3·hidden)
    o: _QLinear
    fc1: _QLinear
    fc2: _QLinear


def _ln(x, p, eps=1e-6):
    """JAX's `_ln`: two-pass variance, then the affine map."""
    scale, bias = p
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


@dataclass(eq=False)
class QuantizedGPT:
    """int8-weight + int8-KV serving twin of a GPTDecoder, built by
    `quantize_gpt(model)`.

    `prefill(ids)` -> (logits, cache) with an int8 KV cache: per layer
    (kq, ks, vq, vs), kq/vq (b, h, max_position, d) int8, ks/vs (b, h) fp32;
    `decode_step(tok, cache, pos)` -> (logits, cache), writing the token's
    k and v into the cache in place; `generate(prompt_ids, steps)`.
    """

    blocks: Tuple[_QBlock, ...]
    tok_emb: torch.Tensor  # (vocab, hidden) bf16
    pos_emb: torch.Tensor  # (max_position, hidden) bf16
    final_ln: Tuple[torch.Tensor, torch.Tensor]
    lm_head: _QLinear
    num_heads: int
    max_position: int

    @property
    def hidden(self) -> int:
        return self.tok_emb.shape[1]

    @property
    def head_dim(self) -> int:
        # from the width of q, not the hidden width: a tensor-parallel rank's
        # model holds num_heads of the whole model's heads
        if not self.blocks:
            return self.hidden // self.num_heads
        return self.blocks[0].qkv.sw.shape[0] // (3 * self.num_heads)

    def _qkv(self, blk: _QBlock, h):
        return tuple(split_heads(p, self.num_heads) for p in blk.qkv(h).chunk(3, -1))

    def _embed(self, ids, pos):
        # the bf16 rows are added in bf16, then widened, as in JAX
        return (self.tok_emb[ids] + self.pos_emb[pos][None]).float()

    def _mlp(self, blk: _QBlock, x):
        return x + blk.fc2(_gelu(blk.fc1(_ln(x, blk.ln2))))

    def prefill(self, ids: torch.Tensor):
        """Prompt pass: fp32 attention over the prompt; the cache written
        int8 with per-(b, h) scales that decode appends reuse."""
        b, s = ids.shape
        x = self._embed(ids, torch.arange(s, device=ids.device))
        visible = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()
        pad = (0, 0, 0, self.max_position - s)
        cache = []
        for blk in self.blocks:
            q, k, v = self._qkv(blk, _ln(x, blk.ln1))
            kq, ks, vq, vs = quantize_kv(k, v)
            cache.append((F.pad(kq, pad), ks, F.pad(vq, pad), vs))
            sc = dense.matmul(q, k, transb=True) / self.head_dim ** 0.5
            p = torch.softmax(torch.where(visible, sc, MASKED), dim=-1)
            x = x + blk.o(merge_heads(dense.matmul(p, v)))
            x = self._mlp(blk, x)
        return self.lm_head(_ln(x, self.final_ln)), tuple(cache)

    def decode_step(self, tok: torch.Tensor, cache, pos: int):
        """One token at position `pos`: int8 weight streams and attention
        over the int8 cache. tok (b,). Returns (logits (b, vocab), cache)."""
        x = self._embed(tok[:, None], pos)
        visible = torch.arange(self.max_position, device=tok.device) <= pos
        for blk, (kq, ks, vq, vs) in zip(self.blocks, cache):
            q, k, v = self._qkv(blk, _ln(x, blk.ln1))  # (b, h, 1, d) each
            # the new token into the prefill scales, clipped
            kq[:, :, pos] = torch.clamp(torch.round(k[:, :, 0] / ks[..., None]), -127, 127).to(
                torch.int8)
            vq[:, :, pos] = torch.clamp(torch.round(v[:, :, 0] / vs[..., None]), -127, 127).to(
                torch.int8)
            sc = _dot_bf16(q, kq.transpose(-1, -2)) * (ks[:, :, None, None] / self.head_dim ** 0.5)
            p = torch.softmax(torch.where(visible, sc, MASKED), dim=-1)
            ctx = _dot_bf16(p, vq) * vs[:, :, None, None]
            x = x + blk.o(merge_heads(ctx))
            x = self._mlp(blk, x)
        return self.lm_head(_ln(x, self.final_ln))[:, 0, :], cache

    @torch.no_grad()
    def generate(self, prompt_ids: torch.Tensor, steps: int) -> torch.Tensor:
        """Greedy generation: prefill, then `steps` decode steps. Returns
        (b, steps) ids; prompt_len + steps must fit max_position."""
        check_fits(prompt_ids.shape[1], steps, self.max_position)
        logits, cache = self.prefill(prompt_ids)
        return _greedy(self.decode_step, logits, cache, prompt_ids, steps)


def _q_linear(lin) -> _QLinear:
    qw, sw = _qrow(lin.kernel.detach().float())
    return _QLinear(qw=qw, sw=sw, b=lin.bias.detach().float().clone())


def _ln_params(ln):
    return (ln.scale.detach().clone(), ln.bias.detach().clone())


def quantize_gpt(model: GPTDecoder) -> QuantizedGPT:
    """Quantize a GPTDecoder's weights into a QuantizedGPT on the model's
    device: linear weights int8 per output channel, embeddings bf16,
    LayerNorms fp32. Every tensor is a copy: training the model on does not
    change the QuantizedGPT."""
    blocks = []
    with torch.no_grad():
        for blk in model.blocks:
            q, k, v = (_q_linear(p) for p in (blk.q_proj, blk.k_proj, blk.v_proj))
            qkv = _QLinear(qw=torch.cat([q.qw, k.qw, v.qw], dim=1),
                           sw=torch.cat([q.sw, k.sw, v.sw]), b=torch.cat([q.b, k.b, v.b]))
            blocks.append(_QBlock(ln1=_ln_params(blk.ln1), ln2=_ln_params(blk.ln2), qkv=qkv,
                                  o=_q_linear(blk.o_proj), fc1=_q_linear(blk.fc1),
                                  fc2=_q_linear(blk.fc2)))
        return QuantizedGPT(
            blocks=tuple(blocks),
            tok_emb=model.tok_emb.embedding.detach().to(torch.bfloat16),
            pos_emb=model.pos_emb.embedding.detach().to(torch.bfloat16),
            final_ln=_ln_params(model.final_ln),
            lm_head=_q_linear(model.lm_head),
            num_heads=model.num_heads,
            max_position=model.max_position,
        )
