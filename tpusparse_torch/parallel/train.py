"""Data × model parallel training step of the sparse MLP.

Counterpart of `tpusparse/parallel/train.py`. One SGD step over a
('data', 'model') mesh:

  * the batch split over 'data' (every rank is given the global batch and
    takes its slice);
  * the sparse layer-1 weight row-partitioned (output neurons) over
    'model', held as this rank's packed ELL blocks times the static 0/1
    block mask, so SGD stays inside the pattern; its product is
    `ops.spmm_blocks` on this rank's chunk plan: 1 block_ell_spmm forward
    and 1 sddmm (dblocks) backward, no dB since x needs no gradient;
  * the hidden activations gathered over 'model' by an autograd function
    whose backward is a `reduce_scatter`, the `psum_scatter` that JAX's AD
    makes of the `all_gather`;
  * the loss, the NLL summed over the batch and divided by the global
    batch, summed over 'data' by an `all_reduce` whose backward is an
    `all_reduce` too (JAX's `psum` transposes to a `psum`); the gradients
    then summed over 'data'.

JAX differentiates each rank's copy of the loss inside `shard_map`, so its
gradients are those of the global loss times the 'data' size (b1, w2, b2)
and times the 'data' × 'model' size (w1). The port keeps that algebra, so
the two packages' steps agree; at world size 1 both factors are 1.

SGD with momentum 0.9 is optax's `sgd(lr, momentum)`:
`torch.optim.SGD(momentum=0.9, dampening=0)` keeps the same trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpusparse_torch import ops
from tpusparse_torch.nn.layers import Pattern
from tpusparse_torch.parallel.mesh import (
    all_gather_rows,
    axis_rank,
    axis_size,
    mesh_device,
    reduce_scatter_rows,
)
from tpusparse_torch.parallel.spmm import RowShardedPlan, shard_plan_rows

__all__ = ["ShardedMLPConfig", "make_sharded_train_state", "make_sharded_train_step"]


@dataclass(frozen=True)
class ShardedMLPConfig:
    in_features: int = 784
    hidden: int = 256
    num_classes: int = 10
    density: float = 0.1
    pattern_seed: int = 0
    learning_rate: float = 0.01
    momentum: float = 0.9
    blocksize: Tuple[int, int] = (8, 128)


def sharded_plan(cfg: ShardedMLPConfig, tp: int) -> RowShardedPlan:
    """The layer-1 pattern's row-sharded plan over `tp` model ranks."""
    pat = Pattern.random(cfg.pattern_seed, (cfg.hidden, cfg.in_features), cfg.density)
    return shard_plan_rows(pat.to_csr(torch.zeros((pat.nnz,))), tp, cfg.blocksize)


def make_optimizer(cfg: ShardedMLPConfig, params: dict) -> torch.optim.SGD:
    return torch.optim.SGD(list(params.values()), lr=cfg.learning_rate,
                           momentum=cfg.momentum, dampening=0.0)


def make_sharded_train_state(cfg: ShardedMLPConfig, mesh, generator=None):
    """(params, plan, mask, optimizer) of this rank.

    params: `w1_blocks` (this model rank's (slots, bm, bk) blocks), `b1`,
    `w2` (classes, hidden) and `b2`, leaf tensors on the mesh's device;
    mask: the 0/1 blocks of the pattern, alike in shape to `w1_blocks`.
    Values are drawn on the CPU from `generator` (default seed 0), the
    global weight whole on every rank, with JAX's ranges: U(±1/√in) for
    layer 1, U(±1/√hidden) for layer 2."""
    tp = axis_size(mesh, "model")
    rank = axis_rank(mesh, "model")
    dev = mesh_device(mesh)
    rsp = sharded_plan(cfg, tp)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    nnz = rsp.scatter_idx.shape[0]
    bound1, bound2 = 1.0 / np.sqrt(cfg.in_features), 1.0 / np.sqrt(cfg.hidden)
    w1 = rsp.pack_values(uniform((nnz,), bound1))[rank]
    params = {"w1_blocks": w1, "b1": uniform((cfg.hidden,), bound1),
              "w2": uniform((cfg.num_classes, cfg.hidden), bound2),
              "b2": uniform((cfg.num_classes,), bound2)}
    params = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    mask = rsp.pack_values(torch.ones((nnz,)))[rank].to(dev)
    return params, rsp, mask, make_optimizer(cfg, params)


class _GatherScatter(torch.autograd.Function):
    """all_gather forward, reduce_scatter backward (JAX's transpose of
    `all_gather` under `shard_map`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


class _Psum(torch.autograd.Function):
    """all_reduce forward and backward (JAX's `psum` and its transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def make_sharded_train_step(cfg: ShardedMLPConfig, mesh, rsp: RowShardedPlan):
    """Returns step(params, optimizer, mask, x, y) -> loss: one SGD step in
    place. x (batch, in_features) and y (batch,) are the global batch,
    alike on every rank; the batch divides by the 'data' size."""
    dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
    if tp != rsp.ndev:
        raise ValueError(f"plan for {rsp.ndev} model ranks, mesh has {tp}")
    d_rank = axis_rank(mesh, "data")
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")
    plan = rsp.local_plan(axis_rank(mesh, "model"))

    def step(params, optimizer, mask, x, y):
        global_batch = x.shape[0]
        if global_batch % dp:
            raise ValueError(f"batch {global_batch} does not divide over {dp} data ranks")
        bl = global_batch // dp
        x_l, y_l = x[d_rank * bl:(d_rank + 1) * bl], y[d_rank * bl:(d_rank + 1) * bl]
        optimizer.zero_grad(set_to_none=True)
        w1_eff = params["w1_blocks"] * mask
        # (rows_per_dev, batch_l): this rank's output neurons
        h_part = ops.spmm_blocks(plan, w1_eff, x_l.transpose(0, 1).contiguous())
        h = _GatherScatter.apply(h_part, g_model)[:cfg.hidden] + params["b1"][:, None]
        h = torch.relu(h)
        logits = params["w2"] @ h + params["b2"][:, None]  # (classes, batch_l)
        logp = torch.log_softmax(logits, dim=0)
        picked = torch.gather(logp, 0, y_l.long()[None, :])
        loss = -_Psum.apply(picked.sum(), g_data) / global_batch
        loss.backward()
        for p in params.values():
            dist.all_reduce(p.grad, group=g_data)
        optimizer.step()
        return loss.detach()

    return step
