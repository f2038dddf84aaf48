"""Drop-in integration: route existing `nn.Linear` models through the port's ops.

Counterpart of `tpusparse/patch.py:32-144` in the reference library's own
form: its deployment mode reassigns `torch.nn.Linear` to a custom layer
(reference benchmarks/pytorch_linear.py). JAX reaches flax's `Dense`
through its `dot_general` hook; here the layer itself is patched.

  - `tpusparse_linear(x, weight, bias)`: y = x Wᵀ + b on `ops.transb_mm`
    (its autograd included), leading dims flattened, as the reference's
    `custom_matmul` routes 3-D × 2-D (matmuls.py:43-48). The GEMM kernel
    takes it when the config's `use_gemm_kernel` is set.
  - `PatchedLinear`: an `nn.Linear` whose forward is `tpusparse_linear`;
    its state dict is `nn.Linear`'s.
  - `patch_torch_linear()`: a context that rebinds `torch.nn.Linear`
    (and `torch.nn.modules.linear.Linear`), restored on exit and on error.
  - `sparsify_dense_params`: magnitude-prune chosen weights of a state dict
    into CSR weights, with JAX's threshold rule.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpusparse_torch import ops
from tpusparse_torch.types import CSR, _back, _host


def tpusparse_linear(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x Wᵀ + b for x (..., in) and W (out, in) on `ops.transb_mm`."""
    lead = x.shape[:-1]
    y = ops.transb_mm(x.reshape(-1, x.shape[-1]), weight).reshape(*lead, weight.shape[0])
    return y if bias is None else y + bias


class PatchedLinear(nn.Linear):
    """nn.Linear whose product runs on the port's `transb_mm` (with its
    backward)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tpusparse_linear(x, self.weight, self.bias)


@contextlib.contextmanager
def patch_torch_linear(cls: type = PatchedLinear):
    """Rebind `torch.nn.Linear` for the duration of the context.

    The reference's `torch.nn.Linear = cublasLinear` deployment. Only code
    that constructs layers through `torch.nn` or `torch.nn.modules.linear`
    while the context is active picks the class up; existing instances and
    `from torch.nn import Linear` names taken earlier are untouched.
    """
    import torch.nn.modules.linear as linear

    originals = (torch.nn.Linear, linear.Linear)
    torch.nn.Linear = cls
    linear.Linear = cls
    try:
        yield cls
    finally:
        torch.nn.Linear, linear.Linear = originals


def sparsify_dense_params(
    state_dict: Mapping[str, torch.Tensor],
    path_patterns: Sequence[str],
    threshold: Optional[float] = None,
    density: Optional[float] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, CSR]]:
    """Magnitude-prune the matrices of a state dict whose names contain any
    of `path_patterns`: keep |w| at or above `threshold`, or the top
    `density` fraction (JAX's numpy rule). Returns the pruned dict (pruned
    entries zero, on each tensor's device) and `{name: CSR}` of each pruned
    weight as stored, (out, in): the orientation `SparseLinear` takes, the
    transpose of JAX's, which prunes the (in, out) kernel.
    """
    if (threshold is None) == (density is None):
        raise ValueError("specify exactly one of threshold / density")
    pruned, sparse = {}, {}
    for name, t in state_dict.items():
        if any(p in name for p in path_patterns) and t.ndim == 2:
            w = _host(t)
            if density is not None:
                k = max(1, int(round(density * w.size)))
                thr = np.partition(np.abs(w).ravel(), w.size - k)[w.size - k]
            else:
                thr = threshold
            t = _back(w * (np.abs(w) >= thr), t, t.device)
            sparse[name] = CSR.from_dense(t, device=t.device)
        pruned[name] = t
    return pruned, sparse
