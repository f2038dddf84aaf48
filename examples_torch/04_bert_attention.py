"""The reference README's BERT-attention patch (README.md:61-80),
tpusparse_torch style.

Reference recipe: inside HuggingFace BERT, replace
    attention_scores = torch.matmul(query_layer, key_layer.transpose(-1, -2))
with
    attention_scores = matmuls.cublasTransbMM.apply(query_layer, key_layer)

tpusparse_torch: the same substitution is `tt.transb_mm(q, k)`, or skip the
manual patching and use the attention modules (`nn.Module`s): dense
scores, the fused flash kernels, and the sparse-score variant the
reference only gestures at.

    python examples_torch/04_bert_attention.py     # on the card
    main(device='cpu')                              # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import torch

import tpusparse_torch as tt
from _common import check, host, launches_since
from tpusparse_torch import kernels

BATCH, HEADS, SEQ, HD = 2, 4, 128, 16


def inputs() -> dict:
    """q, k for the manual patch and the modules' input, from numpy seeds
    (the JAX example's draws)."""
    rng = np.random.default_rng(0)
    f32 = lambda shape: rng.normal(size=shape).astype(np.float32)
    return dict(q=f32((BATCH, HEADS, SEQ, HD)), k=f32((BATCH, HEADS, SEQ, HD)),
                xh=f32((BATCH, SEQ, HEADS * HD)))


def modules(device) -> dict:
    """The attention modules, weights from a seeded generator: dense scores,
    the same on the fused flash kernels, and banded scores."""
    kw = dict(hidden=HEADS * HD, device=device)
    gen = lambda: torch.Generator().manual_seed(0)
    return {
        "dense": tt.SelfAttention(HEADS, HD, **kw, generator=gen()),
        "fused": tt.SelfAttention(HEADS, HD, fused=True, **kw, generator=gen()),
        "sparse": tt.SparseSelfAttention(HEADS, HD, window=16, **kw, generator=gen()),
    }


def main(device=None) -> dict:
    dev = tt.resolve_device(device)
    inp = inputs()
    before = kernels.launches_by_kernel()

    # --- the manual patch: batched transposed matmul on 4-D tensors ---
    q, k = (torch.from_numpy(inp[n]).to(dev) for n in ("q", "k"))
    scores = tt.transb_mm(q, k)  # == q @ k.transpose(-1, -2)
    err = check("tt.transb_mm attention scores", scores,
                host(q) @ host(k).transpose(0, 1, 3, 2))

    # --- or the full modules ---
    xh = torch.from_numpy(inp["xh"]).to(dev)
    mods = modules(dev)
    out = {"scores": host(scores)}
    with torch.no_grad():
        for name, mod in mods.items():
            y = mod(xh)
            if y.shape != xh.shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{name}: output {tuple(y.shape)}, finite "
                                     f"{bool(torch.isfinite(y).all())}")
            out[name] = host(y)
    route = mods["sparse"].engine(SEQ)[0]
    print("  SelfAttention (dense scores) OK")
    print(f"  SelfAttention(fused=True) (flash kernels), within "
          f"{np.abs(out['fused'] - out['dense']).max():.1e} of the dense scores' output")
    print(f"  SparseSelfAttention (banded scores, routed to '{route}') OK")
    launches = launches_since(before)
    print(f"  kernel launches: {launches}")
    print("04_bert_attention: OK  (local/ring variants: nn.LocalAttention, "
          "tpusparse_torch/parallel/attention.py)")
    return {"errors": {"transb_mm": err}, "sparse_route": route, "out": out,
            "launches": launches}


if __name__ == "__main__":
    main()
