"""Tensor-parallel int8 GPT decode: Megatron sharding of `QuantizedGPT`.

Counterpart of `tpusparse/parallel/serving.py`:

  * q/k/v column-parallel (their out features, whole heads, split over
    'model'), so a rank's attention and its part of the int8 KV cache hold
    its heads and need no communication;
  * attention out and fc2 row-parallel (in features split): the fp32
    partial sums are summed over 'model' before the per-channel scale and
    the bias;
  * fc1 column-parallel; lm_head column-parallel (the vocabulary split)
    where the vocabulary divides over 'model', whole otherwise; the logits
    are gathered, so every rank returns the global (batch, vocab) logits;
  * embeddings and LayerNorms whole, the batch split over 'data'.

The single-card block keeps only the fused [q|k|v] weight; `_split_qkv`
cuts it back into q, k and v by exact slices, the form the specs name. The
step itself is `QuantizedGPT.decode_step`, unchanged, on a rank-local model
of num_heads / tp heads whose row-parallel linears all-reduce and whose
lm_head gathers the vocabulary. The cache is head-major (b, h,
max_position, d) in the port at every batch, so a rank's cache is a block of heads (and of the batch); `flat_cache`, JAX's
switch between its flat and head-major layouts, is accepted and has
nothing to choose.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch
import torch.distributed as dist

from tpusparse_torch.models.serving import QuantizedGPT, _dot_bf16, _QBlock, _QLinear
from tpusparse_torch.parallel.mesh import _gather_dim, axis_rank, axis_size, local_slice

__all__ = ["qgpt_param_specs", "shard_qgpt", "make_tp_decode_step"]


@dataclass(eq=False)
class _SplitBlock:
    """A `_QBlock` with its fused [q|k|v] cut back into q, k and v."""

    ln1: Tuple
    ln2: Tuple
    q: _QLinear
    k: _QLinear
    v: _QLinear
    o: _QLinear
    fc1: _QLinear
    fc2: _QLinear


def _split_qkv(qm: QuantizedGPT) -> QuantizedGPT:
    """`qm` with each block's fused [q|k|v] weight cut into q, k and v: the
    fused weight is their exact concatenation, so the slices are the
    quantized weights bit for bit."""
    blocks = []
    for blk in qm.blocks:
        if isinstance(blk, _SplitBlock):
            blocks.append(blk)
            continue
        H = blk.qkv.qw.shape[1] // 3
        q, k, v = (_QLinear(qw=blk.qkv.qw[:, i * H:(i + 1) * H], sw=blk.qkv.sw[i * H:(i + 1) * H],
                            b=blk.qkv.b[i * H:(i + 1) * H]) for i in range(3))
        blocks.append(_SplitBlock(ln1=blk.ln1, ln2=blk.ln2, q=q, k=k, v=v, o=blk.o,
                                  fc1=blk.fc1, fc2=blk.fc2))
    return replace(qm, blocks=tuple(blocks))


def _qlin_spec(lin: _QLinear, col: bool, model_axis: str, tp: int) -> _QLinear:
    """Placements of a _QLinear (qw (in, out)): column-parallel splits the out
    features (scales and bias follow), row-parallel the in features (scales
    and bias whole); a layer whose split dim does not divide stays whole."""
    if col and lin.qw.shape[1] % tp == 0:
        return _QLinear(qw=(None, model_axis), sw=(model_axis,), b=(model_axis,))
    if not col and lin.qw.shape[0] % tp == 0:
        return _QLinear(qw=(model_axis, None), sw=(), b=())
    return _QLinear(qw=(), sw=(), b=())


def qgpt_param_specs(qm: QuantizedGPT, model_axis: str = "model", tp: int = 1) -> QuantizedGPT:
    """A QuantizedGPT of placements (JAX's PartitionSpecs as tuples), in the
    split form of `_split_qkv`; `tp` is the model axis's size."""
    qm = _split_qkv(qm)
    rep2 = ((), ())
    blocks = tuple(
        _SplitBlock(ln1=rep2, ln2=rep2,
                    q=_qlin_spec(blk.q, True, model_axis, tp),
                    k=_qlin_spec(blk.k, True, model_axis, tp),
                    v=_qlin_spec(blk.v, True, model_axis, tp),
                    o=_qlin_spec(blk.o, False, model_axis, tp),
                    fc1=_qlin_spec(blk.fc1, True, model_axis, tp),
                    fc2=_qlin_spec(blk.fc2, False, model_axis, tp))
        for blk in qm.blocks)
    return replace(qm, blocks=blocks, tok_emb=(), pos_emb=(), final_ln=rep2,
                   lm_head=_qlin_spec(qm.lm_head, True, model_axis, tp))


@dataclass(eq=False)
class ShardedQGPT:
    """This rank's slices of a QuantizedGPT (`shard_qgpt`)."""

    model: QuantizedGPT  # split form, the tensors this rank's blocks
    specs: QuantizedGPT
    model_axis: str
    tp: int
    rank: int


def shard_qgpt(qm: QuantizedGPT, mesh, model_axis: str = "model"):
    """(this rank's ShardedQGPT, the specs): the split model sliced by
    `qgpt_param_specs` for this rank of `model_axis`. num_heads must divide
    over the axis (head-parallel attention)."""
    tp, rank = axis_size(mesh, model_axis), axis_rank(mesh, model_axis)
    if qm.num_heads % tp != 0:
        raise ValueError(f"num_heads {qm.num_heads} must divide over model axis {tp}")
    split = _split_qkv(qm)
    specs = qgpt_param_specs(split, model_axis, tp)

    def lin(x: _QLinear, s: _QLinear) -> _QLinear:
        return _QLinear(*(local_slice(getattr(x, f), getattr(s, f), model_axis, rank, tp, f)
                          .contiguous() for f in ("qw", "sw", "b")))

    blocks = tuple(
        _SplitBlock(ln1=blk.ln1, ln2=blk.ln2,
                    **{f: lin(getattr(blk, f), getattr(sb, f))
                       for f in ("q", "k", "v", "o", "fc1", "fc2")})
        for blk, sb in zip(split.blocks, specs.blocks))
    local = replace(split, blocks=blocks, lm_head=lin(split.lm_head, specs.lm_head))
    return ShardedQGPT(model=local, specs=specs, model_axis=model_axis, tp=tp, rank=rank), specs


@dataclass(eq=False)
class _RowQLinear(_QLinear):
    """A row-parallel _QLinear: its in features split over `group`, the fp32
    partial sums summed over it before the scale and the bias."""

    group: object

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = _dot_bf16(x, self.qw)
        dist.all_reduce(y, group=self.group)
        return y * self.sw + self.b


@dataclass(eq=False)
class _VocabQLinear(_QLinear):
    """A column-parallel lm_head: this rank's slice of the vocabulary, the
    logits gathered over `group`."""

    group: object

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _gather_dim(super().__call__(x).contiguous(), self.group, x.ndim - 1)


def _rank_model(qs: ShardedQGPT, group) -> QuantizedGPT:
    """This rank's QuantizedGPT over num_heads / tp heads: its q, k and v
    slices fused again as the single card fuses them, o and fc2
    row-parallel and lm_head gathered where their specs split them."""

    def split(spec: _QLinear) -> bool:
        return qs.tp > 1 and spec.qw != ()

    def row(lin: _QLinear, spec: _QLinear) -> _QLinear:
        return _RowQLinear(lin.qw, lin.sw, lin.b, group) if split(spec) else lin

    blocks = tuple(
        _QBlock(ln1=b.ln1, ln2=b.ln2,
                qkv=_QLinear(qw=torch.cat([b.q.qw, b.k.qw, b.v.qw], 1),
                             sw=torch.cat([b.q.sw, b.k.sw, b.v.sw]),
                             b=torch.cat([b.q.b, b.k.b, b.v.b])),
                o=row(b.o, s.o), fc1=b.fc1, fc2=row(b.fc2, s.fc2))
        for b, s in zip(qs.model.blocks, qs.specs.blocks))
    head = qs.model.lm_head
    if split(qs.specs.lm_head):
        head = _VocabQLinear(head.qw, head.sw, head.b, group)
    return replace(qs.model, blocks=blocks, lm_head=head,
                   num_heads=qs.model.num_heads // qs.tp)


class TPDecodeStep:
    """(tok, cache, pos) -> (global logits, this rank's cache).

    Each rank runs `QuantizedGPT.decode_step` of its rank-local model
    (`_rank_model`) on its block of the batch. `cache` is this rank's block,
    (b / dp, h / tp, max_position, d) per buffer, or the global cache of a
    `QuantizedGPT.prefill`, which is cut to this rank's block (a copy) at
    the call; the block is written in place and returned. `gather_cache`
    gives back the global cache."""

    def __init__(self, qs: ShardedQGPT, mesh, data_axis: str, model_axis: str):
        if model_axis != qs.model_axis or axis_size(mesh, model_axis) != qs.tp:
            raise ValueError("the model was sharded over another model axis")
        self.dp = axis_size(mesh, data_axis)
        self.mrank, self.drank = qs.rank, axis_rank(mesh, data_axis)
        self.mgroup, self.dgroup = mesh.get_group(model_axis), mesh.get_group(data_axis)
        self.heads = qs.model.num_heads // qs.tp
        self.local = _rank_model(qs, self.mgroup)

    def shard_cache(self, cache) -> tuple:
        """This rank's block of a global cache (contiguous copies)."""
        b_l = cache[0][0].shape[0] // self.dp

        def cut(t):
            return t[self.drank * b_l:(self.drank + 1) * b_l,
                     self.mrank * self.heads:(self.mrank + 1) * self.heads].contiguous()

        return tuple(tuple(cut(t) for t in layer) for layer in cache)

    def gather_cache(self, cache) -> tuple:
        """The global cache of the ranks' blocks."""
        return tuple(tuple(_gather_dim(_gather_dim(t, self.mgroup, 1), self.dgroup, 0)
                           for t in layer) for layer in cache)

    @torch.no_grad()
    def __call__(self, tok: torch.Tensor, cache, pos: int):
        if tok.shape[0] % self.dp:
            raise ValueError(f"batch {tok.shape[0]} must divide over the data axis ({self.dp})")
        b_l = tok.shape[0] // self.dp
        if cache[0][0].shape[:2] != (b_l, self.heads):
            cache = self.shard_cache(cache)
        logits, cache = self.local.decode_step(
            tok[self.drank * b_l:(self.drank + 1) * b_l], cache, pos)
        return _gather_dim(logits.contiguous(), self.dgroup, 0), cache


def make_tp_decode_step(qm_sharded: ShardedQGPT, mesh, data_axis: str = "data",
                        model_axis: str = "model", flat_cache: bool = True) -> TPDecodeStep:
    """The decode step of a `shard_qgpt` model on `mesh`: the batch over
    `data_axis`, heads, the int8 cache and the Megatron pairs over
    `model_axis`. `flat_cache` is JAX's layout switch; the port's cache is
    head-major at every batch, so it changes nothing."""
    del flat_cache
    return TPDecodeStep(qm_sharded, mesh, data_axis, model_axis)
