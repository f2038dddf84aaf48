"""Process groups and device meshes on `torch.distributed`.

Counterpart of `tpusparse/parallel/mesh.py:39-78`. JAX's mesh names axes of
devices that one program drives through `shard_map`; here every rank is a
process that runs its own shard, and each named axis of the mesh is a
process group (`torch.distributed.device_mesh.init_device_mesh`). The
collectives run on NCCL for the card and on gloo for `device='cpu'`.

`shard_map` has no counterpart: a sharded function takes this rank's
coordinates from the mesh (`axis_rank`), computes its shard, and where JAX
returns a global array (`out_specs=P(axis)`) returns the same global tensor
through an `all_gather` on that axis (`gather`). Autograd functions carry
the gradients across ranks as JAX's transposes do, each the identity at
world size 1, sending nothing there:
`replicated` (an input that every rank of the axis holds whole; its
gradient is summed over the axis), `gather` and `shard` (the global tensor
of the ranks' blocks along any dim, its gradient this rank's slice of the
gradient that every rank computed alike; and the inverse), `all_to_all`
(JAX's `lax.all_to_all(..., tiled=True)`, backward the reverse exchange),
`ring_permute` (`lax.ppermute` by a shift around the axis, on
`spmm.exchange`, which counts the bytes; backward the other way round) and
`megatron_sum` (all-reduce forward, identity backward: the sum of partials
whose total every rank then uses alike).
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


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, held whole by every rank of the group, with its gradient summed
    over the group (`x` itself at world size 1)."""
    if dist.get_world_size(group) == 1:
        return x
    return _Replicated.apply(x, group)


# -- part b: the collectives of the sharded models --------------------------------


def local_slice(t: torch.Tensor, spec: tuple, axis: str, rank: int, size: int,
                name: str = "tensor") -> torch.Tensor:
    """Rank `rank`'s block of `t` under a placement `spec` (JAX's
    PartitionSpec as a tuple: the dim that names `axis` is split over its
    `size` ranks; a placement without it keeps `t` whole)."""
    for dim, ax in enumerate(spec):
        if ax == axis:
            if t.shape[dim] % size:
                raise ValueError(f"{name}: dim {dim} of size {t.shape[dim]} must divide over "
                                 f"the '{axis}' axis ({size})")
            n = t.shape[dim] // size
            return t.narrow(dim, rank * n, n)
    return t


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' tensors of `group` concatenated along `dim`, in rank order."""
    if dist.get_world_size(group) == 1:
        return x
    return all_gather_rows(x.movedim(dim, 0), group).movedim(0, dim)


class _Shard(torch.autograd.Function):
    """This rank's slice along `dim` of a tensor every rank holds whole; the
    gradient of the whole is the ranks' slices' gradients, gathered."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g.contiguous(), ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """all_gather along `dim`; the gradient of this rank's part is its slice
    of the upstream gradient, which every rank computed alike."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather_dim(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None


def shard(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of `x` along `dim` (JAX's `in_specs=P(axis)` on a
    global array); its gradient reaches the whole of `x` on every rank."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} must divide over {size} ranks")
    if size == 1:
        return x
    return _Shard.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The global tensor of the ranks' blocks along `dim` (JAX's
    `out_specs=P(axis)`)."""
    if dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


def _a2a(x: torch.Tensor, group, split: int, concat: int) -> torch.Tensor:
    size = dist.get_world_size(group)
    chunks = x.unflatten(split, (size, x.shape[split] // size)).movedim(split, 0).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return out.movedim(0, concat).flatten(concat, concat + 1)  # rank j's chunk j-th


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _a2a(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.concat, ctx.split), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's tiled `lax.all_to_all`: `x` is cut into as many blocks along
    `split_axis` as the group has ranks, block j goes to rank j, and the
    blocks received are concatenated along `concat_axis` in rank order. The
    backward is the reverse exchange."""
    size = dist.get_world_size(group)
    if x.shape[split_axis] % size:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} must divide over "
                         f"{size} ranks")
    if size == 1:
        return x
    return _AllToAll.apply(x, group, split_axis % x.ndim, concat_axis % x.ndim)


def start_permute(tensors, group, shift: int = 1):
    """Start sending each tensor `shift` places on round the group and
    receiving those of the rank `shift` places back, in one batch (the
    bytes are counted in `spmm.p2p_bytes`). Returns (the receive buffers,
    the requests); `finish_permute` waits on them."""
    from tpusparse_torch.parallel.spmm import exchange

    size, rank = dist.get_world_size(group), dist.get_rank(group)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    reqs = exchange([(t, (rank + shift) % size) for t in tensors],
                    [(o, (rank - shift) % size) for o in outs], group)
    return outs, reqs


def finish_permute(outs, reqs) -> list:
    for req in reqs:
        req.wait()
    return outs


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(finish_permute(*start_permute(tensors, group, shift)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *finish_permute(*start_permute(grads, ctx.group, -ctx.shift)))


def ring_permute(tensors, group, shift: int = 1) -> tuple:
    """JAX's `lax.ppermute` with the permutation i -> (i + shift) mod n: each
    rank sends its tensors `shift` places on and receives those of the rank
    `shift` places back (`start_permute`). The backward sends the gradients
    the other way. At world size 1 the tensors come back as they are, and
    nothing is sent."""
    tensors = tuple(tensors)
    if dist.get_world_size(group) == 1:
        return tensors
    return _RingPermute.apply(group, shift, *tensors)


class _MegatronSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def megatron_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of the ranks' partials, with the identity for
    its backward: every rank goes on with the same total, so the gradient of
    its partial is the upstream gradient (Megatron's g operator; part a's
    `train._Psum` keeps JAX's psum -> psum transpose instead)."""
    if dist.get_world_size(group) == 1:
        return x
    return _MegatronSum.apply(x, group)
