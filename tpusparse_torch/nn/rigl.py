"""Dynamic sparse training (RigL-style prune and regrow).

Counterpart of `tpusparse/nn/rigl.py:57-218`, on dicts of tensors in place
of pytrees: a parameter dict maps names to tensors (such as
``dict(model.named_parameters())``) and its mask dict maps the same names
to a dense 0/1 mask of the weight's shape, or to None for a tensor that is
not masked (by default every one that is not a matrix).

The recipe (the invariant that makes the grow signal work): the weights
stay masked, their inactive entries exactly zero, and the forward uses the
raw weight (not ``w * mask``, whose chain rule would zero the gradient at
the inactive positions). The backward then gives the dense gradient RigL
grows from. Each step, keep that gradient, give the optimizer
`mask_grads`' masked one, and copy `apply_masks`' result back into the
weights after the update; every few hundred steps call `rigl_update_tree`
with the dense gradient, then `apply_masks` once more. The final mask and
weight go to the sparse executors through `harvest_csr`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpusparse_torch.types import CSR, _back, _host
from tpusparse_torch.utils.config import resolve_device

__all__ = [
    "random_mask",
    "init_masks",
    "apply_masks",
    "mask_grads",
    "rigl_update",
    "rigl_update_tree",
    "cosine_drop_fraction",
    "harvest_csr",
    "sparsity_of",
]

Tensors = Dict[str, torch.Tensor]
Masks = Dict[str, Optional[torch.Tensor]]


def random_mask(generator: torch.Generator, shape: Tuple[int, ...], density: float,
                device=None) -> torch.Tensor:
    """fp32 0/1 mask with exactly round(density·size) ones, uniform over the
    positions; drawn on the CPU from `generator`, then moved to `device`."""
    size = int(np.prod(shape))
    nnz = max(1, min(size, int(round(density * size))))
    scores = torch.rand((size,), generator=generator)
    mask = torch.zeros((size,), dtype=torch.float32)
    mask[torch.topk(scores, nnz).indices] = 1.0
    return mask.reshape(shape).to(resolve_device(device))


def _is_matrix(x: torch.Tensor) -> bool:
    return x.ndim == 2


def init_masks(params: Tensors, density: float, generator: torch.Generator,
               select: Optional[Callable[[torch.Tensor], bool]] = None) -> Masks:
    """A random fixed-nnz mask for each tensor that `select` accepts (by
    default each matrix), on its device, None elsewhere; drawn in the
    dict's order from `generator`."""
    select = select or _is_matrix
    return {name: random_mask(generator, tuple(x.shape), density, device=x.device)
            if select(x) else None for name, x in params.items()}


def _map_masked(fn, masks: Masks, tensors: Tensors) -> Tensors:
    return {name: x if masks.get(name) is None else fn(masks[name], x)
            for name, x in tensors.items()}


def apply_masks(params: Tensors, masks: Masks) -> Tensors:
    """w ⊙ mask for every masked tensor (after each optimizer step, so that
    momentum cannot bring pruned weights back)."""
    return _map_masked(lambda m, w: w * m, masks, params)


def mask_grads(grads: Tensors, masks: Masks) -> Tensors:
    """g ⊙ mask: the optimizer updates the active connections only (the
    dense gradients stay, for RigL to grow from)."""
    return _map_masked(lambda m, g: g * m, masks, grads)


def _top_with_ties(scores: torch.Tensor, valid: torch.Tensor, count: int) -> torch.Tensor:
    """Exactly `count` strongest of `scores` over `valid`: everything
    strictly above the threshold survives; only the entries tied at it are
    trimmed, by position, to fill the budget (rigl.py:142-153)."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    thresh = torch.topk(masked, count).values[-1]
    above = (masked > thresh) & valid
    tie = (masked == thresh) & valid
    budget = count - above.sum()
    return above | (tie & (torch.cumsum(tie.to(torch.int64), 0) <= budget))


def rigl_update(mask: torch.Tensor, w: torch.Tensor, grad: torch.Tensor,
                drop_fraction: float) -> torch.Tensor:
    """One prune/regrow step on one mask; nnz is exactly kept.

    Drops the k = floor(drop_fraction · nnz) active connections of smallest
    |w| and grows the k inactive ones of largest |grad|, ties broken by
    position; k is at most the inactive pool.
    """
    nnz = int(round(float(mask.sum())))
    size = mask.numel()
    k = min(int(np.floor(drop_fraction * nnz)), size - nnz)
    if k <= 0:
        return mask
    m = mask.reshape(-1)
    aw = w.detach().reshape(-1).abs()
    ag = grad.detach().reshape(-1).abs()
    keep_n = nnz - k
    kept = _top_with_ties(aw, m > 0, keep_n) if keep_n > 0 else torch.zeros_like(m, dtype=bool)
    grown = _top_with_ties(ag, m == 0, k)
    return (kept | grown).to(mask.dtype).reshape(mask.shape)


def rigl_update_tree(masks: Masks, params: Tensors, grads: Tensors,
                     drop_fraction: float) -> Masks:
    """`rigl_update` over a mask dict (None stays None)."""
    return {name: None if m is None else rigl_update(m, params[name], grads[name], drop_fraction)
            for name, m in masks.items()}


def cosine_drop_fraction(step: int, total_steps: int, alpha: float = 0.3) -> float:
    """RigL's annealed drop fraction α/2·(1 + cos(π·t/T))."""
    t = min(max(step, 0), total_steps)
    return 0.5 * alpha * (1.0 + float(np.cos(np.pi * t / total_steps)))


def harvest_csr(w: torch.Tensor, mask: torch.Tensor) -> CSR:
    """mask ⊙ w as a CSR on w's device (a host pattern pass), for
    `SparseLinear` or `ops.spmm` at inference."""
    mask_h = _host(mask)
    wm = _host(w) * mask_h
    keep = mask_h.reshape(-1) > 0
    m_, n_ = wm.shape
    rows, cols = np.nonzero(mask_h > 0)
    indptr = np.zeros(m_ + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m_), out=indptr[1:])
    return CSR(data=_back(wm.reshape(-1)[keep], w, w.device),
               indices=cols.astype(np.int32), indptr=indptr.astype(np.int32), shape=(m_, n_))


def sparsity_of(masks: Masks) -> float:
    """Fraction of the masked tensors' entries that are zero (1 − density)."""
    ones = total = 0
    for m in masks.values():
        if m is None:
            continue
        ones += int(m.sum())
        total += m.numel()
    return 1.0 - ones / max(total, 1)
