"""Carry parameters of the JAX package's flax models into the port's modules.

`load_flax_params(module, params)` takes the flax parameter tree as numpy
arrays, `{'params': {'fc1': {'kernel_values' | 'kernel_blocks' | 'kernel',
'bias'}, ...}}`, and writes it into the port's module in place. The port's
parameter names are the flax ones, except for a plain `nn.Linear` (the
'xla' variant's flax `Dense`), whose `weight` is the transpose of flax's
(in, out) `kernel`. Any missing or extra key, or a shape mismatch, raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _leaf_map(child: nn.Module) -> dict:
    """flax leaf name -> (port parameter, transpose?) for one layer."""
    if isinstance(child, nn.Linear):
        return {"kernel": (child.weight, True), "bias": (child.bias, False)}
    return {name: (p, False) for name, p in child.named_parameters(recurse=False)}


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    if set(params) != {"params"}:
        raise KeyError(f"expected {{'params': ...}}, got keys {sorted(params)}")
    tree = params["params"]
    layers = {name: c for name, c in module.named_children()
              if any(True for _ in c.parameters())}
    if set(tree) != set(layers):
        raise KeyError(
            f"layer mismatch: flax has {sorted(tree)}, module has {sorted(layers)}"
        )
    for lname, child in layers.items():
        leaves = _leaf_map(child)
        src = tree[lname]
        if set(src) != set(leaves):
            raise KeyError(
                f"{lname}: flax has {sorted(src)}, module has {sorted(leaves)}"
            )
        for leaf, (p, transpose) in leaves.items():
            arr = np.asarray(src[leaf])
            if transpose:
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{lname}.{leaf}: shape {arr.shape} != module's {tuple(p.shape)}"
                )
            with torch.no_grad():
                p.copy_(torch.tensor(arr, dtype=p.dtype))
    return module
