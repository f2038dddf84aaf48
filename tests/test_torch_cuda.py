"""Card-only tests of the port's CUDA kernels; each skips without an NVIDIA
card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest skips tests/conftest.py, which configures JAX.) Each kernel is
held against its plain PyTorch version on the same card inputs.
"""

import numpy as np
import pytest
import torch

import tpusparse_torch as tt
from tpusparse_torch import kernels
from tpusparse_torch.kernels import gemm as gk
from tpusparse_torch.kernels import sddmm as sk
from tpusparse_torch.kernels import tiled_spmm as tk
from tpusparse_torch.utils.data import synthetic_mnist

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


# -- sddmm ----------------------------------------------------------------------

# (m, k, n), blocksize, empty row range
SDDMM_CASES = {
    "ragged_8x16_n33": ((100, 70, 33), (8, 16), None),
    "ragged_32x8_n130": ((75, 53, 130), (32, 8), None),
    "empty_rowblock_128x128_n40": ((300, 260, 40), (128, 128), (128, 256)),
}


def _sddmm_inputs(name, device, dtype=torch.float32):
    (m, k, n), bs, empty = SDDMM_CASES[name]
    rng = np.random.default_rng(1)
    mask = rng.random((m, k)) < 0.15
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=device)
    plan = tt.build_plan(a, bs)
    dc = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device, dtype)
    return plan, dc, b


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("name", sorted(SDDMM_CASES))
def test_sddmm_kernel_matches_plain(cuda, name, precision):
    plan, dc, b = _sddmm_inputs(name, cuda)
    sk.reset_launch_counts()
    got = sk.sddmm_kernel(plan, dc, b, precision=precision)
    torch.cuda.synchronize()
    assert sk.launch_counts() == {"sddmm": 1}
    want = sk._sddmm_plain(plan, dc, b, precision=precision)
    assert got.shape == (plan.num_slots, *plan.blocksize) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)
    pad = ~plan.slot_valid_mask(cuda).bool().reshape(-1)
    assert torch.count_nonzero(got[pad]) == 0  # pad slots exactly 0


def test_sddmm_kernel_bf16(cuda):
    plan, dc, b = _sddmm_inputs("ragged_32x8_n130", cuda, torch.bfloat16)
    got = sk.sddmm_kernel(plan, dc, b)
    want = sk._sddmm_plain(plan, dc, b)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)


# -- gemm -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("transa,transb", [(False, False), (True, False), (False, True), (True, True)])
def test_gemm_kernel_matches_plain(cuda, transa, transb, dtype, precision):
    m, n, k = 100, 70, 33
    rng = np.random.default_rng(2)
    a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
    a, b = torch.from_numpy(a).to(cuda, dtype), torch.from_numpy(b).to(cuda, dtype)
    gk.reset_launch_counts()
    got = gk.gemm_kernel(a, b, transa=transa, transb=transb, precision=precision)
    torch.cuda.synchronize()
    assert gk.launch_counts() == {"gemm": 1}
    want = gk._gemm_plain(a, b, transa=transa, transb=transb, precision=precision)
    assert got.shape == (m, n) and got.dtype == dtype
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    plan, dc, b = _sddmm_inputs("ragged_8x16_n33", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sddmm_kernel(plan, dc.t().contiguous().t(), b)
    with pytest.raises(TypeError, match="dtype"):
        sk.sddmm_kernel(plan, dc.double(), b)
    with pytest.raises(ValueError, match="shape"):
        sk.sddmm_kernel(plan, dc[:-1], b)
    with pytest.raises(ValueError, match="same device"):
        sk.sddmm_kernel(plan, dc, b.cpu())
    a = torch.ones(8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gemm_kernel(a.t(), a)
    with pytest.raises(TypeError, match="dtype"):
        gk.gemm_kernel(a.half(), a.t().contiguous().half())
    with pytest.raises(ValueError, match="contraction"):
        gk.gemm_kernel(a, a)
    with pytest.raises(ValueError, match="same device"):
        gk.gemm_kernel(a, a.cpu(), transb=True)


# -- one training step, card against CPU ----------------------------------------

# launches per step: 'sparse'/'blocksparse' run fc1 and fc2 forward, fc2's dB
# and both dW (SDDMM); 'dense' with the GEMM kernel runs 2 forward products,
# fc2's dX and dW, and fc1's dW.
STEP_LAUNCHES = {
    "sparse": {"block_ell_spmm": 3, "sddmm": 2, "gemm": 0},
    "blocksparse": {"block_ell_spmm": 3, "sddmm": 2, "gemm": 0},
    "dense": {"block_ell_spmm": 0, "sddmm": 0, "gemm": 5},
}


@pytest.mark.parametrize("variant", sorted(STEP_LAUNCHES))
def test_train_step_on_card_matches_cpu(cuda, variant):
    tx, ty, _, _ = synthetic_mnist(n_train=64, n_test=8)
    x, y = torch.from_numpy(tx[:32]), torch.from_numpy(ty[:32])
    prev = tt.get_config().use_gemm_kernel
    tt.set_config(use_gemm_kernel=variant == "dense")
    try:
        nets = {d: tt.MnistNet(variant, hidden=256, device=d,
                               generator=torch.Generator().manual_seed(0)) for d in ("cpu", cuda)}
        opts = {d: tt.make_train_state(n) for d, n in nets.items()}
        kernels.reset_launch_counts()
        got = tt.train_step(nets[cuda], opts[cuda], x.to(cuda), y.to(cuda))
        torch.cuda.synchronize()
        assert kernels.launches_by_kernel() == STEP_LAUNCHES[variant]
        want = tt.train_step(nets["cpu"], opts["cpu"], x, y)
    finally:
        tt.set_config(use_gemm_kernel=prev)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    for (name, p), (_, q) in zip(nets[cuda].named_parameters(), nets["cpu"].named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), **TOL, msg=name)
