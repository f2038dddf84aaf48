"""Expert parallelism: switch-style top-1 MoE with the experts over an axis.

Counterpart of `tpusparse/parallel/moe.py`. E expert FFNs, relu(x W_in)
W_out, are spread over the 'expert' axis, E / n a rank. A router sends each
token to its top-1 expert (ties to the first maximum) and scales the
expert's output by the gate probability, the switch-transformer estimator,
through which the router learns.

  * `moe_forward`: the tokens on every rank; a rank runs its experts on the
    tokens routed to them and the partial outputs are summed over the axis
    (`mesh.megatron_sum`). No all-to-all.
  * `moe_forward_a2a`: the tokens split over the axis; each rank packs its
    tokens into an (E, C, d) buffer, C = ceil(capacity_factor · T_local /
    E) slots an expert, by their running count; a token past capacity goes
    nowhere (its zeros are added at slot C - 1) and comes out 0. One
    all-to-all ships each expert's slots to its owner, the owner runs its
    experts, the reverse all-to-all brings the outputs home.

The parameters are held whole by every rank and each rank takes its
experts (`mesh.shard`); the gradients that come back are the global loss's
on every rank, the router's and the tokens' summed over the axis where the
ranks hold parts of the work (`mesh.replicated`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusparse_torch import ops
from tpusparse_torch.parallel.mesh import (
    all_to_all,
    axis_rank,
    axis_size,
    gather,
    megatron_sum,
    replicated,
    shard,
)
from tpusparse_torch.utils.config import resolve_device

__all__ = ["init_moe_params", "moe_forward_reference", "moe_forward", "moe_forward_a2a",
           "load_balance_loss"]


def init_moe_params(generator: torch.Generator, num_experts: int, d_model: int,
                    d_hidden: int, device=None) -> dict:
    """{'router' (d, E), 'w_in' (E, d, dh), 'w_out' (E, dh, d)}: uniform in
    ±1/sqrt(fan-in), drawn on the CPU from `generator` in that order."""
    dev = resolve_device(device)
    s_in, s_hid = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(d_hidden)

    def uniform(shape, s):
        return ((torch.rand(shape, generator=generator) * 2 - 1) * s).to(dev)

    return {"router": uniform((d_model, num_experts), s_in),
            "w_in": uniform((num_experts, d_model, d_hidden), s_in),
            "w_out": uniform((num_experts, d_hidden, d_model), s_hid)}


def _route(router: torch.Tensor, x: torch.Tensor):
    """(softmax probabilities, top-1 expert, its gate) of each token."""
    probs = torch.softmax(ops.mm(x, router), dim=-1)
    assign = torch.argmax(probs, dim=-1)
    return probs, assign, probs.gather(1, assign[:, None])[:, 0]


def _expert(x, w_in, w_out):
    return ops.mm(torch.relu(ops.mm(x, w_in)), w_out)


def moe_forward_reference(params, x: torch.Tensor) -> torch.Tensor:
    """The unsharded oracle: top-1 routing, the gate-scaled expert FFN."""
    _, assign, gate = _route(params["router"], x)
    out = torch.zeros_like(x)
    for e in range(params["w_in"].shape[0]):
        h = _expert(x, params["w_in"][e], params["w_out"][e])
        out = out + torch.where((assign == e)[:, None], h, 0.0)
    return out * gate[:, None]


def moe_forward(params, x: torch.Tensor, mesh, axis: str = "expert") -> torch.Tensor:
    """The experts over `axis`, the tokens on every rank, the outputs summed:
    `moe_forward_reference`'s result on every rank."""
    E, n = params["w_in"].shape[0], axis_size(mesh, axis)
    if E % n != 0:
        raise ValueError(f"num_experts {E} must divide shards {n}")
    e_local, group = E // n, mesh.get_group(axis)
    _, assign, gate = _route(params["router"], x)  # cheap: on every rank alike
    w_in, w_out = shard(params["w_in"], group, 0), shard(params["w_out"], group, 0)
    xe = replicated(x, group)  # each rank's experts see a part of x's uses
    out = torch.zeros_like(x)
    for le in range(e_local):
        ge = axis_rank(mesh, axis) * e_local + le
        out = out + torch.where((assign == ge)[:, None], _expert(xe, w_in[le], w_out[le]), 0.0)
    return megatron_sum(out, group) * gate[:, None]


def moe_forward_a2a(params, x: torch.Tensor, mesh, axis: str = "expert",
                    capacity_factor: float = 2.0) -> torch.Tensor:
    """Capacity-based all-to-all dispatch, the tokens split over `axis`.
    With capacity_factor >= E nothing is dropped and the result is
    `moe_forward_reference`'s; else a token past its expert's capacity
    gives 0."""
    E, d, n = params["w_in"].shape[0], x.shape[-1], axis_size(mesh, axis)
    if E % n != 0:
        raise ValueError(f"num_experts {E} must be divisible by the shard count {n}")
    if x.shape[0] % n != 0:
        raise ValueError(f"token count {x.shape[0]} must be divisible by the shard count {n}")
    e_local, t_local = E // n, x.shape[0] // n
    cap = int(np.ceil(capacity_factor * t_local / E))
    group = mesh.get_group(axis)
    x_l = shard(x, group, 0)
    w_in, w_out = shard(params["w_in"], group, 0), shard(params["w_out"], group, 0)
    _, assign, gate = _route(replicated(params["router"], group), x_l)

    # each token's place in its expert's bucket: the running count
    pos = (torch.cumsum(F.one_hot(assign, E), 0) - 1).gather(1, assign[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, pos, cap - 1)
    disp = x_l.new_zeros((E, cap, d)).index_put(
        (assign, slot), torch.where(keep[:, None], x_l, 0.0), accumulate=True)
    # (source rank, local expert, slot, d) after the exchange
    recv = all_to_all(disp.reshape(n, e_local, cap, d), group, 0, 0)
    out = torch.stack([_expert(recv[:, le].reshape(n * cap, d), w_in[le], w_out[le])
                       .reshape(n, cap, d) for le in range(e_local)], dim=1)
    back = all_to_all(out, group, 0, 0).reshape(E, cap, d)
    y = torch.where(keep[:, None], back[assign, slot], 0.0) * gate[:, None]
    return gather(y, group, 0)


def load_balance_loss(params, x: torch.Tensor) -> torch.Tensor:
    """The switch-transformer auxiliary loss E · Σ_e f_e · p_e: f_e the share
    of tokens routed to e, p_e the mean router probability."""
    probs, assign, _ = _route(params["router"], x)
    E = probs.shape[-1]
    f = F.one_hot(assign, E).to(probs.dtype).mean(0)
    return E * torch.sum(f * probs.mean(0))
