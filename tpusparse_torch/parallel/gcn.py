"""Node-sharded GCN: full-batch graph training over the mesh.

Counterpart of `tpusparse/parallel/gcn.py`. The normalised adjacency is
row-partitioned with `shard_plan_rows`: each rank owns a contiguous block
of output nodes and that block's plan, while the dense projections stay
whole on every rank. Per layer the aggregation H' = Â (H W) is
`ops.spmm_blocks` on this rank's chunk (the block executor forward; its dB
on the transpose plan backward, since H W needs a gradient and Â's values
do not), and the node blocks come back to every rank through an
`all_gather`. The gradient is that of the global loss: the projection's
gradient is summed over the ranks (`mesh.replicated`) and each rank's
rows take their slice of the gathered gradient (`mesh.gather`), as
JAX's global arrays make it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpusparse_torch import ops
from tpusparse_torch.models.gcn import masked_nll
from tpusparse_torch.parallel.mesh import axis_rank, gather, replicated
from tpusparse_torch.parallel.spmm import RowShardedPlan, shard_plan_rows

__all__ = ["shard_plan_rows", "make_sharded_gcn_forward", "make_sharded_gcn_train_step"]


def _layer_names(model) -> Sequence[str]:
    return [f"conv{i + 1}" for i in range(model.num_hidden)] + ["head"]


def make_sharded_gcn_forward(model, rsp: RowShardedPlan, mesh, axis: str = "model"):
    """(params, a_blocks, x) -> log-probs, every layer's aggregation sharded
    by output-node block.

    `a_blocks = rsp.pack_values(a_hat.data)` packs the normalised adjacency
    once; `params` is a `models.gcn.GCN` of `model`'s layout, whose layer
    algebra is replayed: `transb_mm`, the bias, the aggregation, relu, and
    log-softmax at the end."""
    names = _layer_names(model)
    m = rsp.shape[0]
    group = mesh.get_group(axis)
    i = axis_rank(mesh, axis)
    plan = rsp.local_plan(i)

    def aggregate(a_blocks, z):
        z = replicated(z, group).contiguous()
        return gather(ops.spmm_blocks(plan, a_blocks[i].contiguous(), z), group, 0)[:m]

    def forward(params, a_blocks, x):
        h = x
        for name in names:
            dl = getattr(params, name).DenseLinear_0
            z = ops.transb_mm(h, dl.kernel)
            if dl.bias is not None:
                z = z + dl.bias
            h = aggregate(a_blocks, z)
            if name != "head":
                h = torch.relu(h)
        return torch.log_softmax(h, dim=-1)

    return forward


def make_sharded_gcn_train_step(model, rsp: RowShardedPlan, mesh, axis: str = "model"):
    """step(params, optimizer, a_blocks, x, labels, mask) -> loss: one
    full-batch node-classification step in place, on the masked NLL of
    `models.gcn.train_step` (Adam as `models.gcn.make_train_state` makes
    it)."""
    forward = make_sharded_gcn_forward(model, rsp, mesh, axis)

    def step(params, optimizer, a_blocks, x, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = masked_nll(forward(params, a_blocks, x), labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
