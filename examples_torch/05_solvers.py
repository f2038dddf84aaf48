"""Beyond the reference: the solver stack (CG + preconditioners, the
Lanczos eigensolver, smoothed-aggregation AMG) riding the same plan-cached
SpMM. The AMG levels run on the wide-DIA SpMV kernel and the windowed
kernels where their formats route there.

    python examples_torch/05_solvers.py     # on the card
    main(device='cpu')                       # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import scipy.sparse as ssp
import torch

import tpusparse_torch as tt
from _common import host, launches_since
from tpusparse_torch import kernels
from tpusparse_torch.linalg import cg, eigsh_lanczos, ic_preconditioner

N1, ITERS, LANCZOS_ITERS = 24, 25, 120


def inputs() -> dict:
    """The 1-D stencil T and identity I whose Kronecker sums make the 2-D
    Poisson matrix, and b, from numpy seeds (the JAX example's draws)."""
    rng = np.random.default_rng(0)
    t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N1, N1), format="csr")
    eye = ssp.eye(N1, format="csr")
    b = rng.normal(size=(N1 * N1,)).astype(np.float32)
    return dict(T=t.astype(np.float32), I=eye.astype(np.float32), b=b)


def poisson(inp: dict, device) -> tt.CSR:
    """The 2-D Poisson matrix I ⊗ T + T ⊗ I, built with sp_kron and sp_add."""
    s = lambda m: tt.CSR.from_scipy(m.tocsr(), device=device)
    return tt.sp_add(tt.sp_kron(s(inp["I"]), s(inp["T"])), tt.sp_kron(s(inp["T"]), s(inp["I"])))


def main(device=None) -> dict:
    dev = tt.resolve_device(device)
    inp = inputs()
    A = poisson(inp, dev)
    b = torch.from_numpy(inp["b"]).to(dev)
    a64 = A.to_scipy().astype(np.float64)

    def resid(x):
        """The float64 relative residual ‖A x − b‖ / ‖b‖."""
        r = a64 @ host(x) - inp["b"]
        return float(np.linalg.norm(r) / np.linalg.norm(inp["b"]))

    before = kernels.launches_by_kernel()
    xs, residuals = {}, {}
    # use a real tolerance: CG with tol 0 iterates past exact convergence
    xs["cg"], _ = cg(A, b, tol=1e-7, maxiter=ITERS)
    xs["ic"], _ = cg(A, b, M=ic_preconditioner(A), tol=1e-7, maxiter=ITERS)
    M = tt.smoothed_aggregation_setup(A, coarse_size=50)
    xs["amg"], _ = cg(A, b, M=M, tol=1e-7, maxiter=ITERS)
    for name, label in (("cg", "plain CG"), ("ic", "IC(0)-CG"), ("amg", "AMG-CG")):
        residuals[name] = resid(xs[name])
        print(f"  {label + ', 25 iters:':24s} rel resid {residuals[name]:.2e}")
    if not residuals["amg"] < 1e-4:
        raise AssertionError(f"AMG-CG: rel resid {residuals['amg']}")

    # 2-D Poisson's 2nd and 3rd eigenvalues are DEGENERATE: single-vector
    # Lanczos needs extra iterations to surface the second copy
    vals, _ = eigsh_lanczos(A, k=3, which="LA", iters=LANCZOS_ITERS)
    ref = np.sort(np.linalg.eigvalsh(a64.toarray()))[::-1][:3]
    if not np.allclose(host(vals), ref, rtol=1e-3):
        raise AssertionError(f"eigsh_lanczos: {host(vals)} against {ref}")
    print(f"  eigsh_lanczos top-3: {np.round(host(vals), 4)}")
    launches = launches_since(before)
    print(f"  AMG hierarchy:\n{M.report()}\n  kernel launches: {launches}")
    print("05_solvers: OK")
    return {"residuals": residuals, "eigenvalues": host(vals), "amg": M.report(),
            "out": {name: host(x) for name, x in xs.items()}, "launches": launches}


if __name__ == "__main__":
    main()
