"""Linear layers on the port's ops, and flax's LayerNorm and Embed, as
`torch.nn.Module`s.

Counterpart of `tpusparse/nn/layers.py:33-271`. Each linear forward is
``op(x, Wᵀ) + b``. Weights and biases start from the reference init
U(±1/√fan_in) (layers.py:118-131), drawn on the CPU from `generator` (the
default CPU generator when None) and then moved to `device`, so one seed
gives the same weights on the CPU and on the card. `device=None` means the
CUDA card (see `utils.config.resolve_device`).

Parameter names follow the flax modules ('kernel', 'kernel_values',
'kernel_blocks', 'bias'; 'scale' and 'bias' of `LayerNorm`, 'embedding' of
`Embed`), so `convert.load_flax_params` maps them one to one.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpusparse_torch import ops
from tpusparse_torch.plan import build_plan, build_plan_pair
from tpusparse_torch.types import CSR
from tpusparse_torch.utils.config import resolve_device


@dataclass(frozen=True, eq=False)
class Pattern:
    """Hashable host-side sparsity pattern: read-only numpy int32 arrays,
    equality and hash by content fingerprint."""

    indices: np.ndarray
    indptr: np.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        idx = np.ascontiguousarray(np.asarray(self.indices, dtype=np.int32))
        ptr = np.ascontiguousarray(np.asarray(self.indptr, dtype=np.int32))
        # copy before freezing when the conversion returned the caller's buffer
        if idx is self.indices:
            idx = idx.copy()
        if ptr is self.indptr:
            ptr = ptr.copy()
        idx.flags.writeable = False
        ptr.flags.writeable = False
        object.__setattr__(self, "indices", idx)
        object.__setattr__(self, "indptr", ptr)
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        h = hashlib.sha1()
        h.update(idx.tobytes())
        h.update(ptr.tobytes())
        h.update(repr(self.shape).encode())
        object.__setattr__(self, "_fp", h.digest())

    @classmethod
    def from_csr(cls, a: CSR) -> "Pattern":
        return cls(indices=a.indices, indptr=a.indptr, shape=a.shape)

    @classmethod
    def random(cls, seed: int, shape: Tuple[int, int], density: float) -> "Pattern":
        """Numpy pattern sampling; the same seed gives the JAX package's pattern."""
        m, n = shape
        nnz = max(1, int(round(density * m * n)))
        rng = np.random.default_rng(seed)
        flat = rng.choice(m * n, size=nnz, replace=False)
        flat.sort()
        rows = (flat // n).astype(np.int32)
        cols = (flat % n).astype(np.int32)
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(indptr[1:], rows, 1)
        indptr = np.cumsum(indptr)
        return cls(indices=cols, indptr=indptr, shape=(m, n))

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def to_csr(self, data: torch.Tensor) -> CSR:
        return CSR(data=data, indices=self.indices, indptr=self.indptr, shape=self.shape)

    def __eq__(self, other):
        return (
            isinstance(other, Pattern)
            and self.shape == other.shape
            and self._fp == other._fp
        )

    def __hash__(self):
        return int.from_bytes(self._fp[:8], "little")


def _uniform(shape, fan_in: int, generator) -> torch.Tensor:
    """U(±1/√fan_in) on the CPU from `generator`."""
    bound = 1.0 / np.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * bound) - bound


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(device))


def _flat_batch(x: torch.Tensor, in_features: int) -> torch.Tensor:
    if x.shape[-1] != in_features:
        raise ValueError(
            f"input features {x.shape[-1]} != layer in_features {in_features}"
        )
    return x.reshape(-1, in_features)


class DenseLinear(nn.Module):
    """nn.Linear-compatible dense layer on the port's `transb_mm` op.

    use_kernel: the flax module's `use_pallas`. True runs the forward and
    backward products on the GEMM kernel whatever the config says; False
    (default) leaves the choice to the config's `use_gemm_kernel`.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 use_kernel: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.features = in_features, features
        self.use_kernel = use_kernel
        self.kernel = _param(_uniform((features, in_features), in_features, generator), device)
        self.bias = (
            _param(_uniform((features,), in_features, generator), device)
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        # x @ Wᵀ through the transb op: Wᵀ is never materialised
        y = ops.transb_mm(_flat_batch(x, self.in_features), self.kernel,
                          use_kernel=True if self.use_kernel else None)
        y = y.reshape(*lead, self.features)
        return y + self.bias if self.bias is not None else y


class SparseLinear(nn.Module):
    """Linear layer with a static-sparse (out, in) weight; the parameter is
    the nnz value vector. forward: y = x @ Wᵀ + b computed as (W @ xᵀ)ᵀ
    through the block-ELL executor; the backward runs the SDDMM kernel (dW)
    and the executor on the transpose plan (dx)."""

    def __init__(self, pattern: Pattern, use_bias: bool = True,
                 method: str = "tiled", blocksize: Optional[Tuple[int, int]] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.pattern, self.method, self.blocksize = pattern, method, blocksize
        out_features, in_features = pattern.shape
        self.kernel_values = _param(_uniform((pattern.nnz,), in_features, generator), device)
        self.bias = (
            _param(_uniform((out_features,), in_features, generator), device)
            if use_bias else None
        )

    @classmethod
    def random(cls, seed: int, in_features: int, out_features: int,
               density: float, **kw) -> "SparseLinear":
        return cls(Pattern.random(seed, (out_features, in_features), density), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_features, in_features = self.pattern.shape
        x2 = _flat_batch(x, in_features)
        w = self.pattern.to_csr(self.kernel_values)
        xt = x2.transpose(0, 1).contiguous()
        if self.method == "tiled":
            plans = build_plan_pair(w, self.blocksize)
            y = ops.tiled_spmm(w, xt, plans=plans)
        else:
            y = ops.spmm(w, xt, method=self.method, blocksize=self.blocksize)
        y = y.transpose(0, 1).reshape(*x.shape[:-1], out_features)
        return y + self.bias if self.bias is not None else y


class BlockSparseLinear(nn.Module):
    """Linear layer whose weight is the packed ELL block tensor
    (num_slots, bm, bk), with a fixed 0/1 mask (a buffer) that keeps it
    inside the sparsity pattern; no per-call packing. The forward multiplies
    by the mask, so the gradient of the blocks is zero outside the
    pattern."""

    def __init__(self, pattern: Pattern, use_bias: bool = True,
                 blocksize: Optional[Tuple[int, int]] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.pattern = pattern
        out_features, in_features = pattern.shape
        w_csr = pattern.to_csr(torch.zeros((pattern.nnz,)))
        self.plan = build_plan(w_csr, blocksize)
        bm, bk = self.plan.blocksize
        mask = np.zeros((self.plan.num_slots * bm * bk,), np.float32)
        mask[np.asarray(self.plan.scatter_idx)] = 1.0
        self.register_buffer(
            "mask", torch.from_numpy(mask.reshape(self.plan.num_slots, bm, bk)).to(device)
        )
        vals = _uniform((pattern.nnz,), in_features, generator)
        self.kernel_blocks = _param(self.plan.pack_values(vals), device)
        self.bias = (
            _param(_uniform((out_features,), in_features, generator), device)
            if use_bias else None
        )

    @classmethod
    def random(cls, seed: int, in_features: int, out_features: int,
               density: float, **kw) -> "BlockSparseLinear":
        return cls(Pattern.random(seed, (out_features, in_features), density), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_features, in_features = self.pattern.shape
        xt = _flat_batch(x, in_features).transpose(0, 1).contiguous()
        y = ops.spmm_blocks(self.plan, self.kernel_blocks * self.mask, xt)
        y = y.transpose(0, 1).reshape(*x.shape[:-1], out_features)
        return y + self.bias if self.bias is not None else y


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last dim: eps 1e-6 (torch's default is
    1e-5), scale 1 and bias 0 at init. flax takes the variance as
    mean(x²) − mean(x)², torch in two passes; the two agree within the fp32
    tier for rows whose mean is not large against their spread."""

    EPS = 1e-6  # flax's default

    def __init__(self, features: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.features = features
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.features,), self.scale, self.bias, self.EPS)


class Embed(nn.Module):
    """flax `nn.Embed`: an (num_embeddings, features) table looked up by
    index, drawn from flax's default init N(0, 1/features) on the CPU from
    `generator`."""

    def __init__(self, num_embeddings: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        w = torch.randn((num_embeddings, features), generator=generator) / np.sqrt(features)
        self.embedding = _param(w, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)
