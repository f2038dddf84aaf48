"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Counterpart of `tpusparse/parallel/pipeline.py`. Stage s of S lives on rank
s of the 'stage' axis. Every rank runs the same M + S - 1 ticks, as JAX's
`fori_loop` does: stage 0 takes microbatch t, stage s > 0 takes what its
left neighbour made at tick t - 1, every stage applies its `stage_fn`, and
the outputs go one rank on round the ring (`mesh.ring_permute`). The last
stage keeps the outputs of ticks S - 1 ... M + S - 2, and the sum over the
axis of what each stage kept, zeros but on the last, gives every rank the
result (`mesh.megatron_sum`). Utilisation is M / (M + S - 1).

Every rank builds the same graph: the choices by stage are `torch.where` on
this rank's index, not Python branches, so each rank runs the same ordered
sends and receives in the backward too, and NCCL cannot deadlock on a hop
one rank skipped. The gradient is the sequential one: `stage_params` is
held whole by every rank with a leading stage dim, each rank takes its row
(`mesh.shard`), whose gradient is gathered back into the whole.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils._pytree as pytree

from tpusparse_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    megatron_sum,
    replicated,
    ring_permute,
    shard,
)

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "stage", num_microbatches: int = 4) -> torch.Tensor:
    """`stage_fn(params_s, h) -> h` run as an S-stage pipeline.

    stage_params: a tensor or a tuple/list/dict of tensors, each with a
    leading stage dim of size S. x: (batch, d), batch divisible by
    num_microbatches; every stage keeps the width d. Returns (batch, d) on
    every rank."""
    S, M = axis_size(mesh, axis), num_microbatches
    batch, d = x.shape
    if batch % M != 0:
        raise ValueError(f"batch {batch} must divide microbatches {M}")
    mb = batch // M
    group = mesh.get_group(axis)
    s = axis_rank(mesh, axis)
    params_s = pytree.tree_map(lambda p: shard(p, group, 0)[0], stage_params)
    xs = replicated(x, group).reshape(M, mb, d)
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == S - 1, device=x.device)
    state = x.new_zeros((mb, d))
    outs = []
    for t in range(M + S - 1):
        h_out = stage_fn(params_s, torch.where(first, xs[min(t, M - 1)], state))
        if t >= S - 1:
            outs.append(torch.where(last, h_out, torch.zeros_like(h_out)))
        if t + 1 < M + S - 1:  # the last tick's hop would feed no tick
            (state,) = ring_permute((h_out,), group, 1)
    return megatron_sum(torch.stack(outs), group).reshape(batch, d)
