"""What the examples share: the host float64 check each of them asserts
with, and the kernel launches a stretch of an example made."""

import numpy as np
import torch

from tpusparse_torch import kernels


def host(x) -> np.ndarray:
    """A tensor (any device, any float type) or array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def check(name: str, got, ref, tol: float = 1e-4) -> float:
    """max |got - ref| / max |ref| against the float64 oracle `ref`; raises
    AssertionError above `tol`. Returns the error."""
    ref = host(ref)
    err = float(np.abs(host(got) - ref).max() / max(np.abs(ref).max(), 1e-30))
    if not err < tol:
        raise AssertionError(f"{name}: rel err {err:.2e} >= {tol}")
    print(f"  {name:38s} rel err {err:.2e}")
    return err


def launches_since(before: dict) -> dict:
    """The kernels launched since `before = kernels.launches_by_kernel()`,
    by kernel; kernels not launched are left out."""
    now = kernels.launches_by_kernel()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
