"""Card-only tests of the port's CUDA kernel; each skips without an NVIDIA
card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest skips tests/conftest.py, which configures JAX.) The kernel is
held against its plain PyTorch version on the same card inputs.
"""

import numpy as np
import pytest
import torch

import tpusparse_torch as tt
from tpusparse_torch.kernels import tiled_spmm as tk

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier: kernel and plain sum in other orders
# C in bf16: nearly equal fp32 sums may round to adjacent bf16 values
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)

# (m, k, n), blocksize, empty row range
CASES = {
    "ragged_8x32_n130": ((100, 70, 130), (8, 32), None),
    "ragged_32x8_n33": ((75, 53, 33), (32, 8), None),
    "empty_rowblock_128x128": ((300, 260, 40), (128, 128), (128, 256)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(name, device, vals_dtype=torch.float32, b_dtype=torch.float32):
    (m, k, n), bs, empty = CASES[name]
    rng = np.random.default_rng(0)
    mask = rng.random((m, k)) < 0.15
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=device)
    plan = tt.build_plan(a, bs)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return plan, plan.pack_values(a.data).to(vals_dtype), b.to(device, b_dtype)


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_and_counts(cuda, name, precision):
    plan, bv, b = _inputs(name, cuda)
    tk.reset_launch_counts()
    got_t = tk.tiled_spmm_kernel(plan, bv, b, precision=precision)
    got_r = tk.resident_spmm_kernel(plan, bv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {"tiled_spmm": 1, "resident_spmm": 1}
    assert torch.equal(got_t, got_r)
    want = tk._block_exec_plain(plan, bv, b, precision=precision)
    torch.testing.assert_close(got_t, want, **TOL)


@pytest.mark.parametrize("vals_dtype,b_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32),
])
def test_kernel_bf16_operands(cuda, vals_dtype, b_dtype):
    plan, bv, b = _inputs("ragged_8x32_n130", cuda, vals_dtype, b_dtype)
    got = tk.tiled_spmm_kernel(plan, bv, b)
    want = tk._block_exec_plain(plan, bv, b)
    assert got.dtype == want.dtype == torch.result_type(bv, b)
    tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_mixed_devices_raise(cuda):
    plan, bv, b = _inputs("ragged_32x8_n33", cuda)
    with pytest.raises(ValueError, match="same device"):
        tk.tiled_spmm_kernel(plan, bv.cpu(), b)


@pytest.mark.parametrize("variant", ["sparse", "blocksparse"])
def test_mnist_forward_on_card_matches_cpu(cuda, variant):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((32, 784)).astype(np.float32))
    nets = {d: tt.MnistNet(variant, hidden=256, device=d,
                           generator=torch.Generator().manual_seed(0)) for d in ("cpu", cuda)}
    tk.reset_launch_counts()
    with torch.inference_mode():
        got = nets[cuda](x.to(cuda))
        torch.cuda.synchronize()
        assert sum(tk.launch_counts().values()) == 2  # fc1 and fc2
        want = nets["cpu"](x)
    torch.testing.assert_close(got.cpu(), want, **TOL)
