"""Migrating the reference's core matmul workflows (README.md:16-58).

Reference (torch + CUDA extension):

    init_cublas()                      # global handle
    a = torch.rand(8, 64).cuda()
    b = torch.rand(64, 8).cuda()
    c = cublasMM.apply(a, b)           # autograd-capable matmul
    destroy_cublas()

tpusparse_torch: no handles; the tensors say where they live (`device`,
None meaning the card), and every op is a `torch.autograd.Function`, so
`.backward()` reaches it. This script runs each reference workflow and
checks it against a host float64 oracle.

    python examples_torch/01_migrate_matmuls.py     # on the card
    main(device='cpu')                              # the kernels' plain versions
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import scipy.sparse as ssp
import torch

import tpusparse_torch as tt
from _common import check, host, launches_since
from tpusparse_torch import kernels


def inputs() -> dict:
    """The example's operands, from numpy seeds (the JAX example's draws)."""
    rng = np.random.default_rng(0)
    f32 = lambda shape: rng.normal(size=shape).astype(np.float32)
    out = dict(a=f32((8, 64)), b=f32((64, 8)), q=f32((16, 64)), k=f32((16, 64)),
               x4=f32((4, 3, 32, 16)), y4=f32((4, 3, 16, 8)))
    a_sp = ssp.random(512, 512, density=0.02, format="csr", random_state=1, dtype=np.float32)
    a_sp.sort_indices()
    out.update(a_sp=a_sp, B=f32((512, 128)))
    return out


def main(device=None) -> dict:
    dev = tt.resolve_device(device)
    inp = inputs()
    t = lambda name: torch.from_numpy(inp[name]).to(dev)
    errors, out = {}, {}
    before = kernels.launches_by_kernel()

    # --- dense matmul with autograd (reference: cublasMM.apply) ---
    a, b = t("a").requires_grad_(True), t("b")
    c = tt.mm(a, b)
    errors["mm"] = check("tt.mm (cublasMM)", c, host(a) @ host(b))
    # gradients: no InplaceFunction, just .backward()
    c.sum().backward()
    errors["mm dA"] = check("grad dA = dC @ B^T", a.grad, np.ones((8, 8)) @ host(b).T)
    out.update(mm=host(c), mm_da=host(a.grad))

    # --- transposed variants (reference: cublasTransbMM etc.) ---
    q, k = t("q"), t("k")
    qk = tt.transb_mm(q, k)
    errors["transb_mm"] = check("tt.transb_mm (cublasTransbMM)", qk, host(q) @ host(k).T)

    # --- batched 4-D matmul (reference: cublas_bmm with dim folding) ---
    x4, y4 = t("x4"), t("y4")
    xy = tt.bmm(x4, y4)
    errors["bmm"] = check("tt.bmm 4-D (cublas_bmm)", xy, host(x4) @ host(y4))
    out.update(transb_mm=host(qk), bmm=host(xy))

    # --- sparse x dense with autograd (reference: cusparseMM/naiveSpMM) ---
    a_sp = inp["a_sp"]
    A = tt.CSR.from_scipy(a_sp, device=dev)  # one-time boundary conversion
    B = t("B")
    ref = a_sp.astype(np.float64) @ host(B)
    route = tt.ops._route_spmm(A, B, None)
    y_auto, y_naive = tt.spmm(A, B), tt.spmm(A, B, method="naive")
    errors["spmm"] = check(f"tt.spmm auto-routed ('{route}', cusparseMM)", y_auto, ref)
    errors["spmm naive"] = check("tt.spmm method='naive' (naiveSpMM)", y_naive, ref)

    # sparse gradients: dA comes back SDDMM-restricted to A's pattern
    data = A.data.clone().requires_grad_(True)
    tt.spmm(tt.CSR(data, A.indices, A.indptr, A.shape), B).sum().backward()
    errors["spmm dA"] = check("grad dA (pattern-restricted)", data.grad,
                              host(B).sum(1)[np.asarray(A.indices)])
    out.update(spmm=host(y_auto), spmm_naive=host(y_naive), spmm_da=host(data.grad))

    launches = launches_since(before)
    print(f"  kernel launches: {launches}")
    print("01_migrate_matmuls: OK")
    return {"errors": errors, "route": route, "out": out, "launches": launches}


if __name__ == "__main__":
    main()
