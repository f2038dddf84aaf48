"""Carry parameters of the JAX package's flax models into the port's modules.

`load_flax_params(module, params)` takes the flax parameter tree as numpy
arrays, `{'params': {...}}`, and writes it into the port's module in
place. The tree is nested as the modules are: a module's own parameters are
leaves under their names, each child that holds parameters is a subtree
under its attribute name. So the MLP's tree is `{'fc1': {'kernel_values' |
'kernel_blocks' | 'kernel', 'bias'}, ...}` and the BERT encoder's is
`{'tok_emb': {'embedding'}, 'emb_ln': {'scale', 'bias'}, 'layer0':
{'attention': {'query': {'kernel', 'bias'}, ...}, 'ln1', 'ffn_in', ...},
...}`, and the GPT decoder's is `{'tok_emb', 'pos_emb', 'block0': {'ln1',
'q_proj', 'k_proj', 'v_proj', 'o_proj', 'ln2', 'fc1', 'fc2'}, ...,
'final_ln', 'lm_head'}`, and the graph models' are `{'conv1': {'DenseLinear_0':
{'kernel', 'bias'}}, ..., 'head': ...}` (GCN), `{'gat1': {'DenseLinear_0':
{'kernel'}, 'att_src', 'att_dst', 'bias'}, ..., 'head': ...}` (GAT) and
`{'mlp1': {'kernel', 'bias'}, ..., 'head': ...}` (APPNP), the child modules
carrying flax's auto-names. The port's parameter names are the flax ones,
except for a plain `nn.Linear` (the 'xla' variant's flax `Dense`) or a
`patch.PatchedLinear` (flax's `PatchedDense`), whose `weight` is the
transpose of flax's (in, out) `kernel`; without a bias it has `kernel` only. Any missing or
extra key, or a shape mismatch, raises, naming the path. `to_flax_params(module)` is the
inverse: the module's parameters as that numpy tree, so that the two
packages' parameters can be compared. The parameters of the sharded models
that are plain dicts or trees in both packages carry as arrays:
`load_moe_params` (the MoE dict) and `load_stage_params` (pipeline stages).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from tpusparse_torch.types import host_numpy


def _tree(module: nn.Module) -> dict:
    """flax key -> (port parameter, transpose?) for a leaf, or -> subtree for
    a child that holds parameters."""
    if isinstance(module, nn.Linear):  # a flax `Dense` or `PatchedDense`
        tree = {"kernel": (module.weight, True)}
        if module.bias is not None:
            tree["bias"] = (module.bias, False)
        return tree
    out = {name: (p, False) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if any(True for _ in child.parameters()):
            out[name] = _tree(child)
    return out


def _to_numpy(tree: dict) -> dict:
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out[key] = _to_numpy(node)
        else:
            p, transpose = node
            arr = host_numpy(p)
            out[key] = np.ascontiguousarray(arr.T) if transpose else arr
    return out


def to_flax_params(module: nn.Module) -> dict:
    """{'params': nested tree of np.ndarray}: the module's parameters in the
    flax tree's names and layouts, copied to host numpy."""
    return {"params": _to_numpy(_tree(module))}


def _load(tree: dict, src: Mapping, path: str) -> None:
    if not isinstance(src, Mapping):
        raise KeyError(f"{path or 'params'}: expected a subtree, got {type(src).__name__}")
    if set(src) != set(tree):
        raise KeyError(
            f"layer mismatch at {path or 'params'}: flax has {sorted(src)}, "
            f"module has {sorted(tree)}"
        )
    for key, node in tree.items():
        where = f"{path}.{key}" if path else key
        if isinstance(node, dict):
            _load(node, src[key], where)
            continue
        p, transpose = node
        if isinstance(src[key], Mapping):
            raise KeyError(f"{where}: flax has a subtree, module has a parameter")
        arr = np.asarray(src[key])
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{where}: shape {arr.shape} != module's {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(arr, dtype=p.dtype))


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    if set(params) != {"params"}:
        raise KeyError(f"expected {{'params': ...}}, got keys {sorted(params)}")
    _load(_tree(module), params["params"], "")
    return module


def load_sharded_train_state(cfg, params: Mapping, mask, momentum: Mapping,
                             model_rank: int = 0, device=None):
    """The port's sharded-MLP state (`parallel.make_sharded_train_state`'s
    params, mask and optimizer) from the JAX package's, as numpy arrays:
    `params` {'w1_blocks' (tp, slots, bm, bk), 'b1', 'w2', 'b2'}, the
    (tp, slots, bm, bk) `mask` and `momentum`, the trace of optax's sgd
    state, keyed as `params`. Model rank `model_rank` takes its slice of the
    blocks; everything lands on `device` (None: the card)."""
    from tpusparse_torch.parallel.train import make_optimizer
    from tpusparse_torch.utils.config import resolve_device

    dev = resolve_device(device)

    def rank_slice(name, tree):
        arr = np.asarray(tree[name], np.float32)
        return arr[model_rank] if name == "w1_blocks" else arr

    out = {name: torch.tensor(rank_slice(name, params), device=dev).requires_grad_()
           for name in ("w1_blocks", "b1", "w2", "b2")}
    optimizer = make_optimizer(cfg, out)
    for name, p in out.items():
        optimizer.state[p]["momentum_buffer"] = torch.tensor(rank_slice(name, momentum),
                                                             device=dev)
    return out, torch.tensor(np.asarray(mask, np.float32)[model_rank], device=dev), optimizer


def load_moe_params(params: Mapping, device=None) -> dict:
    """The port's MoE parameters (`parallel.init_moe_params`' dict) from the
    JAX package's as numpy arrays: {'router' (d, E), 'w_in' (E, d, dh),
    'w_out' (E, dh, d)}, fp32 on `device` (None: the card). A missing or
    extra key, or shapes that do not fit together, raise."""
    from tpusparse_torch.utils.config import resolve_device

    if set(params) != {"router", "w_in", "w_out"}:
        raise KeyError(f"expected router, w_in and w_out, got {sorted(params)}")
    arr = {k: np.asarray(params[k], np.float32) for k in ("router", "w_in", "w_out")}
    (d, e), (e2, d2, dh), (e3, dh2, d3) = (arr[k].shape for k in ("router", "w_in", "w_out"))
    if not (e == e2 == e3 and d == d2 == d3 and dh == dh2):
        raise ValueError(f"MoE shapes do not fit: {[a.shape for a in arr.values()]}")
    dev = resolve_device(device)
    return {k: torch.tensor(a, device=dev) for k, a in arr.items()}


def load_stage_params(tree, device=None):
    """Pipeline stage parameters (each leaf with a leading stage dim) from
    numpy: the same tuple/list/dict tree of fp32 tensors on `device` (None:
    the card)."""
    import torch.utils._pytree as pytree

    from tpusparse_torch.utils.config import resolve_device

    dev = resolve_device(device)
    return pytree.tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)
