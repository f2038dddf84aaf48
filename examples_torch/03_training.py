"""FC-layer training (the reference's cublasLinear / cusparseLinear +
mnist_benchmark.py workflow), with a static-sparse weight the reference
cannot train.

Reference: swap `nn.Linear` for `cublasLinear(in, out)` in a torch module
and train normally. tpusparse_torch: `DenseLinear` / `SparseLinear` are
`nn.Module`s over the port's autograd ops; any `torch.optim` optimizer
trains them. The sparse layer keeps its weight's nonzeros as the
parameter: the forward runs the block SpMM, the backward the SDDMM (dW on
the pattern) and the SpMM on the transpose plan (dX).

    python examples_torch/03_training.py     # on the card
    main(device='cpu')                        # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import torch

import tpusparse_torch as tt
from _common import launches_since
from tpusparse_torch import kernels

STEPS, LR = 300, 3e-2


def inputs() -> dict:
    """A small regression task, from numpy seeds (the JAX example's draws);
    y = x @ w_true in float32."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    w_true = rng.normal(size=(64, 10)).astype(np.float32)
    return dict(x=x, y=x @ w_true)


def models(device) -> dict:
    """The dense layer (reference: cublasLinear) and the static-sparse one
    (reference: cusparseLinear, but here the WEIGHT is sparse and training
    stays sparse end to end), weights from a seeded generator."""
    gen = lambda: torch.Generator().manual_seed(0)
    return {"dense": tt.DenseLinear(64, 10, device=device, generator=gen()),
            "sparse": tt.SparseLinear.random(0, 64, 10, density=0.5, device=device,
                                             generator=gen())}


def train(model, x, y, steps: int = STEPS, lr: float = LR) -> list:
    """`steps` Adam steps on mean((model(x) - y)²); the loss of each step,
    taken before its update."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for _ in range(steps):
        loss = torch.mean((model(x) - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return [float(v) for v in torch.stack(losses).cpu()]


def main(device=None) -> dict:
    dev = tt.resolve_device(device)
    inp = inputs()
    x, y = (torch.from_numpy(inp[n]).to(dev) for n in ("x", "y"))
    before = kernels.launches_by_kernel()
    losses = {}
    for name, model in models(dev).items():
        first_steps = kernels.launches_by_kernel()
        losses[name] = train(model, x, y)
        steps = launches_since(first_steps)
        l0, l1 = losses[name][0], losses[name][-1]
        print(f"  {type(model).__name__ + ':':14s} loss {l0:.3f} -> {l1:.4f}, launches {steps}")
    if not losses["dense"][-1] < 0.01 * losses["dense"][0]:
        raise AssertionError(f"DenseLinear: loss {losses['dense'][0]} -> {losses['dense'][-1]}")
    if not losses["sparse"][-1] < 0.5 * losses["sparse"][0]:
        raise AssertionError(f"SparseLinear: loss {losses['sparse'][0]} -> "
                             f"{losses['sparse'][-1]}")
    launches = launches_since(before)
    print("03_training: OK  (the MNIST MLP: tt.MnistNet and tt.train_step; RigL prune/regrow "
          "training: tpusparse_torch.nn.rigl)")
    return {"losses": {k: (v[0], v[-1]) for k, v in losses.items()}, "launches": launches}


if __name__ == "__main__":
    main()
