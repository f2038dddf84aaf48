"""Tensor-parallel BERT: Megatron sharding of the attention layer and encoder.

Counterpart of `tpusparse/parallel/bert.py`. JAX annotates the parameters
with PartitionSpecs and lets XLA place the collectives; here each rank holds
its slices and runs a rank-local layer over `num_heads / tp` heads:

  * query/key/value and ffn_in column-parallel: kernel (out, in) split on
    dim 0 over 'model', their biases too; their input passes Megatron's f
    (`mesh.replicated`: identity forward, its gradient summed over 'model');
  * attention out and ffn_out row-parallel: kernel split on dim 1, bias
    whole; the partial products are summed over 'model' by Megatron's g
    (`mesh.megatron_sum`) before the bias and the LayerNorm;
  * LayerNorms and embeddings whole on every rank;
  * the batch split over 'data'; each parameter's gradient is summed over
    'data' (`mesh.replicated` on the parameter), and every rank returns the
    global output (`mesh.gather`).

So the gradient that reaches each rank's slices is the global loss's, with
no factor of an axis size. Head parallelism holds for every attention
variant: the rank-local layer is the module itself with its head count cut.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping

import torch
from torch import nn

from tpusparse_torch import ops
from tpusparse_torch.models.bert import BertAttentionLayer, BertEncoder
from tpusparse_torch.nn.layers import DenseLinear, _flat_batch
from tpusparse_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    gather,
    local_slice,
    megatron_sum,
    mesh_device,
    replicated,
    shard,
)

__all__ = ["bert_param_specs", "shard_bert_params", "make_tp_forward", "validate_tp_heads"]

COLUMN = ("query", "key", "value", "ffn_in")
ROW = ("out", "ffn_out")


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def bert_param_specs(params, model_axis: str = "model") -> Dict[str, tuple]:
    """{state-dict name: placement} for a BertAttentionLayer/BertEncoder (or
    its parameters by name), a placement being JAX's PartitionSpec as a
    tuple: column-parallel q/k/v and ffn_in kernels `(model_axis, None)`
    and biases `(model_axis,)`; row-parallel out and ffn_out kernels
    `(None, model_axis)`; everything else `()`, replicated."""

    def spec(name, t):
        parts = name.split(".")
        col = any(p in COLUMN for p in parts)
        row = any(p in ROW for p in parts)
        if parts[-1] == "kernel" and t.ndim == 2:
            if col:
                return (model_axis, None)
            if row:
                return (None, model_axis)
        if parts[-1] == "bias" and t.ndim == 1 and col:
            return (model_axis,)
        return ()

    return {name: spec(name, t) for name, t in _named(params).items()}


def shard_bert_params(params, mesh, model_axis: str = "model"):
    """(this rank's parameters, the specs): each parameter of the layer or
    encoder (a module or its named parameters) sliced by
    `bert_param_specs`, copied to the mesh's device as a leaf that requires
    grad."""
    specs = bert_param_specs(params, model_axis)
    tp, rank = axis_size(mesh, model_axis), axis_rank(mesh, model_axis)
    dev = mesh_device(mesh)
    local = {}
    for name, t in _named(params).items():
        s = local_slice(t.detach(), specs[name], model_axis, rank, tp, name)
        local[name] = s.to(dev).clone().requires_grad_()
    return local, specs


def validate_tp_heads(num_heads: int, mesh, model_axis: str = "model") -> None:
    tp = axis_size(mesh, model_axis)
    if num_heads % tp != 0:
        raise ValueError(f"num_heads {num_heads} must divide over model axis size {tp}")


class _RowParallel(nn.Module):
    """A DenseLinear whose input features are split over the group: the
    partial products are summed before the bias."""

    def __init__(self, lin: DenseLinear, tp: int, group):
        super().__init__()
        self.in_features, self.features = lin.in_features // tp, lin.features
        self.use_kernel, self.group = lin.use_kernel, group
        self.kernel = nn.Parameter(torch.empty((self.features, self.in_features),
                                               device="meta"))
        self.bias = nn.Parameter(torch.empty((self.features,), device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.transb_mm(_flat_batch(x, self.in_features), self.kernel,
                          use_kernel=True if self.use_kernel else None)
        y = megatron_sum(y, self.group).reshape(*x.shape[:-1], self.features)
        return y + self.bias


def _to_model(module: nn.Module, group) -> None:
    """Megatron's f on the module's first input."""
    module.register_forward_pre_hook(lambda m, args: (replicated(args[0], group), *args[1:]))


def _local_layer(layer: BertAttentionLayer, tp: int, group) -> BertAttentionLayer:
    """The rank-local layer of `layer`: its own code over num_heads / tp
    heads and intermediate / tp FFN features, parameters on 'meta' (each
    call passes the rank's slices)."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta")) for p in layer.parameters()}
    local = copy.deepcopy(layer, memo)
    attn = local.attention
    attn.num_heads //= tp
    for lin in (attn.query, attn.key, attn.value, local.ffn_in):
        lin.features //= tp
    attn.out = _RowParallel(attn.out, tp, group)
    local.ffn_out = _RowParallel(local.ffn_out, tp, group)
    _to_model(attn, group)
    _to_model(local.ffn_in, group)
    return local


def make_tp_forward(layer, mesh, shardings, data_axis: str = "data",
                    model_axis: str = "model"):
    """forward(params, x) -> the global output of `layer` (a
    BertAttentionLayer on (batch, seq, hidden) x, or a BertEncoder on
    (batch, seq) ids), `params` this rank's slices from `shard_bert_params`
    and x the global batch, split over `data_axis`. `shardings` are the
    specs `shard_bert_params` returned; each rank's slices receive the
    global loss's gradient."""
    tp = axis_size(mesh, model_axis)
    dp = axis_size(mesh, data_axis)
    mgroup, dgroup = mesh.get_group(model_axis), mesh.get_group(data_axis)
    if isinstance(layer, BertAttentionLayer):
        validate_tp_heads(layer.attention.num_heads, mesh, model_axis)
        local = _local_layer(layer, tp, mgroup)
    elif isinstance(layer, BertEncoder):
        validate_tp_heads(layer.layer0.attention.num_heads, mesh, model_axis)
        memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"))
                for p in layer.parameters()}
        local = copy.deepcopy(layer, memo)
        for i in range(layer.num_layers):
            setattr(local, f"layer{i}", _local_layer(getattr(layer, f"layer{i}"), tp, mgroup))
    else:
        raise TypeError(f"expected a BertAttentionLayer or BertEncoder, got {type(layer)}")
    names = set(dict(local.named_parameters()))

    def forward(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        if set(params) != names or set(shardings) != names:
            raise KeyError(f"parameters {sorted(set(params) ^ names)} do not match the layer's")
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} must divide over the data axis ({dp})")
        xs = shard(x, dgroup, 0)
        p = {k: replicated(t, dgroup) for k, t in params.items()}
        return gather(torch.func.functional_call(local, p, (xs,)), dgroup, 0)

    return forward

