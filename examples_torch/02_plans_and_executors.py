"""The inspect-once / multiply-many lifecycle (the reference's TiledSpMM).

Reference (tests/tiledsppm_kernel_test.py):

    tiledspmm_inspect_coo(m, n, k, nnz, rows, cols, vals, "layer0")
    tiledspmm_mm(b, c, "layer0")        # many times
    tiledspmm_clean()

tpusparse_torch: the plan is keyed by the PATTERN's content fingerprint,
not by a name you must manage; repeated `tt.spmm` calls on the same pattern
hit the cache. Or build the plan once, pack the values once, and call the
executor directly, with no lookup a call.

    python examples_torch/02_plans_and_executors.py     # on the card
    main(device='cpu')                                   # the plain versions
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
from tpusparse_torch.plan import build_plan, plan_cache_info


def inputs() -> dict:
    """The example's operands, from numpy seeds (the JAX example's draws)."""
    rng = np.random.default_rng(0)
    a_sp = ssp.random(1024, 1024, density=0.01, format="csr", random_state=2, dtype=np.float32)
    a_sp.sort_indices()
    B = rng.normal(size=(1024, 256)).astype(np.float32)
    B3 = rng.normal(size=(4, 1024, 256)).astype(np.float32)
    return dict(a_sp=a_sp, B=B, B3=B3)


def main(device=None) -> dict:
    dev = tt.resolve_device(device)
    inp = inputs()
    a_sp = inp["a_sp"]
    A = tt.CSR.from_scipy(a_sp, device=dev)
    B = torch.from_numpy(inp["B"]).to(dev)
    ref = a_sp.astype(np.float64) @ host(B)
    errors, out = {}, {}
    before = kernels.launches_by_kernel()

    # implicit: every call fingerprints the pattern and reuses the plan
    hits = plan_cache_info()["hits"]
    tt.spmm(A, B, method="tiled")
    y2 = tt.spmm(A, B, method="tiled")
    if not plan_cache_info()["hits"] > hits:
        raise AssertionError("the second call did not reuse the plan")
    errors["implicit"] = check("implicit plan reuse (cache hits grew)", y2, ref)

    # explicit: a Plan object and packed values, no lookup a call
    plan = build_plan(A)
    report = plan.report()
    print(f"  {report}")
    packed = plan.pack_values(A.data)

    def multiply_many(packed, b):
        return tt.ops.spmm_blocks(plan, packed, b)

    y3 = multiply_many(packed, B)
    errors["explicit"] = check("explicit plan executor", y3, ref)

    # --- batched 3-D operands: one sparse pattern times a batch of dense
    # operands. The batched executor takes the batch as one launch (folded
    # into its column walk); the gradients flow as in 2-D.
    B3 = torch.from_numpy(inp["B3"]).to(dev)
    y4 = tt.spmm(A, B3, method="tiled")
    ref3 = np.einsum("ij,bjk->bik", a_sp.toarray().astype(np.float64), host(B3))
    errors["batched"] = check("batched 3-D tiled spmm", y4, ref3)
    out.update(implicit=host(y2), explicit=host(y3), batched=host(y4))

    launches = launches_since(before)
    print(f"  kernel launches: {launches}")
    print("02_plans_and_executors: OK")
    return {"errors": errors, "report": report, "out": out, "launches": launches}


if __name__ == "__main__":
    main()
