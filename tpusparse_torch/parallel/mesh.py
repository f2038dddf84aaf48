"""Process groups and device meshes on `torch.distributed`.

Counterpart of `tpusparse/parallel/mesh.py:39-78`. JAX's mesh names axes of
devices that one program drives through `shard_map`; here every rank is a
process that runs its own shard, and each named axis of the mesh is a
process group (`torch.distributed.device_mesh.init_device_mesh`). The
collectives run on NCCL for the card and on gloo for `device='cpu'`.

`shard_map` has no counterpart: a sharded function takes this rank's
coordinates from the mesh (`axis_rank`), computes its shard, and where JAX
returns a global array (`out_specs=P(axis)`) returns the same global tensor
through an `all_gather` on that axis (`gather_rows`). Two autograd
functions carry the gradients across ranks as JAX's transposes do:
`replicated` (an input that every rank of the axis holds whole; its
gradient is summed over the axis) and `gather_rows` (the gathered rows'
gradient is this rank's slice of the gradient, which every rank computed
alike).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpusparse_torch.utils.config import resolve_device

__all__ = ["make_mesh", "initialize_distributed"]


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(device=None, **kwargs) -> None:
    """Bring up the default process group; a no-op when one is up.

    With `RANK` and `WORLD_SIZE` in the environment it initialises from it
    (`env://`); otherwise it builds a group of world size 1 on a `file://`
    store in a temporary directory. The backend is NCCL for the card
    (`device=None`, which raises without one) and gloo for the CPU, unless
    `backend=` says otherwise; other keywords go to
    `torch.distributed.init_process_group`. A failure to initialise raises.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", _backend(dev))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index or 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kwargs.setdefault("init_method", "env://")
        dist.init_process_group(**kwargs)
        return
    store_dir = tempfile.mkdtemp(prefix="tpusparse_torch_pg_")
    atexit.register(shutil.rmtree, store_dir, True)
    kwargs.setdefault("init_method", "file://" + os.path.join(store_dir, "store"))
    dist.init_process_group(rank=0, world_size=1, **kwargs)


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    device=None,
):
    """A `DeviceMesh` over the ranks of the default process group, one
    process group per named axis.

    Default shape: every rank on the last axis, the others 1, as in JAX.
    Raises ValueError when the shape's product is not the world size, or
    when the group's backend is not the one `device` needs.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    initialize_distributed(dev)
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    if dist.get_backend() != _backend(dev):
        raise ValueError(f"the process group runs {dist.get_backend()}; a mesh on {dev.type} "
                         f"needs {_backend(dev)}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


# the one-tensor collectives; newer torch renames the `*_tensor` forms `*_single`
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (r, ...) tensors of `group`, stacked on dim 0 in rank order."""
    size = dist.get_world_size(group)
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of the ranks' x, this rank's block of rows."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """all_gather forward; the gradient of this rank's rows is its slice of
    the (replicated) upstream gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _Replicated(torch.autograd.Function):
    """Identity forward; the gradient is summed over the group, as JAX
    transposes an input that a `shard_map` replicates (`P()`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The global tensor of the group's row shards (JAX's `out_specs=P(axis)`)."""
    return _GatherRows.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, held whole by every rank of the group, with its gradient summed
    over the group."""
    return _Replicated.apply(x, group)
