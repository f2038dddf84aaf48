"""Parity of the port's dense GEMM kernel (plain version on the CPU),
`dense.matmul`'s kernel route, the `use_gemm_kernel` switch and the
autograd `mm` family with the JAX package: `gemm_pallas` runs in interpret
mode, the gradients come from `jax.vjp` of the JAX ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.ops as jops
from tpusparse.kernels.gemm import gemm_pallas

import tpusparse_torch as tt
import tpusparse_torch.dense as tdense
import tpusparse_torch.ops as tops
from tpusparse_torch.kernels import gemm as gk

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
# bf16 output: fp32 sums of two implementations may round to adjacent bf16
# values (one ulp is 2^-8..2^-7 of the value); inputs are ~N(0, 1).
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)
TRANS = [(False, False), (True, False), (False, True), (True, True)]
M, N, K = 100, 70, 33  # ragged in every dimension


def _operands(transa, transb, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, M) if transa else (M, K)).astype(np.float32)
    b = rng.standard_normal((N, K) if transb else (K, N)).astype(np.float32)
    return a, b


def _pallas(a, b, transa, transb, dtype=jnp.float32):
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    return gemm_pallas(ja.T if transa else ja, jb.T if transb else jb)


@pytest.fixture
def kernel_switch():
    prev = tt.get_config().use_gemm_kernel
    yield lambda on: tt.set_config(use_gemm_kernel=on)
    tt.set_config(use_gemm_kernel=prev)


@pytest.mark.parametrize("transa,transb", TRANS)
def test_gemm_plain_matches_pallas(transa, transb):
    a, b = _operands(transa, transb)
    want = np.asarray(_pallas(a, b, transa, transb))
    got = gk.gemm_kernel(torch.from_numpy(a), torch.from_numpy(b), transa=transa, transb=transb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("transa,transb", TRANS)
def test_dense_matmul_kernel_route_matches_pallas(transa, transb, kernel_switch):
    a, b = _operands(transa, transb, seed=1)
    want = np.asarray(_pallas(a, b, transa, transb))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = tdense.matmul(at, bt, transa=transa, transb=transb, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    kernel_switch(True)  # the config switch takes the same route
    np.testing.assert_allclose(
        tdense.matmul(at, bt, transa=transa, transb=transb).numpy(), want, **TOL)


def test_gemm_bf16_matches_pallas():
    a, b = _operands(False, True, seed=2)
    want = _pallas(a, b, False, True, jnp.bfloat16)
    got = gk.gemm_kernel(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
                         transb=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL_BF16)


def test_gemm_default_tier_matches_bf16_rounded_numpy():
    a, b = _operands(True, False, seed=3)

    def rnd(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()

    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = gk.gemm_kernel(at, bt, transa=True, precision="default")
    # bf16 x bf16 products are exact in fp32, so only the sums round
    np.testing.assert_allclose(got.numpy(), rnd(a).T @ rnd(b), **TOL)
    assert not torch.equal(got, gk.gemm_kernel(at, bt, transa=True, precision="high"))


def test_transposed_views_go_to_the_kernel_as_flags():
    a, b = _operands(False, False, seed=4)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    # a transposed view is passed as its storage with the flag flipped
    got = tdense.matmul(at.t().contiguous().t(), bt.t().contiguous(), transb=True,
                        use_kernel=True)
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ b, **TOL)
    # any other strided view is copied
    got = tdense.matmul(torch.from_numpy(np.repeat(a, 2, axis=1))[:, ::2], bt, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ b, **TOL)


def test_gemm_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = _operands(False, False)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="contraction"):
        gk.gemm_kernel(at, bt, transb=True)
    with pytest.raises(ValueError, match="2-D"):
        gk.gemm_kernel(at[None], bt)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gemm_kernel(at.t(), bt, transa=True)
    with pytest.raises(TypeError, match="dtype"):
        gk.gemm_kernel(at.double(), bt)
    with pytest.raises(TypeError, match="out_dtype"):
        gk.gemm_kernel(at, bt, out_dtype=torch.float16)
    gk.reset_launch_counts()
    gk.gemm_kernel(at, bt)
    assert gk.launch_counts() == {"gemm": 0}  # the CPU path launches nothing


def test_kernel_route_records_no_gradient():
    a, b = _operands(False, False)
    at = torch.from_numpy(a).requires_grad_(True)
    with pytest.raises(RuntimeError, match="ops.mm"):
        tdense.matmul(at, torch.from_numpy(b), use_kernel=True)
    with torch.no_grad():
        tdense.matmul(at, torch.from_numpy(b), use_kernel=True)


def test_use_gemm_kernel_defaults_off():
    assert tt.get_config().use_gemm_kernel is False


# -- the autograd mm family --------------------------------------------------------

OPS = {"mm": (False, False), "transa_mm": (True, False), "transb_mm": (False, True),
       "transab_mm": (True, True)}


@pytest.mark.parametrize("kernel", [False, True], ids=["torch_matmul", "gemm_kernel"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_dense_op_grads_match_jax_vjp(op, kernel, kernel_switch):
    transa, transb = OPS[op]
    a, b = _operands(transa, transb, seed=5)
    g = np.random.default_rng(6).standard_normal((M, N)).astype(np.float32)
    want, vjp = jax.vjp(getattr(jops, op), jnp.asarray(a), jnp.asarray(b))
    da_want, db_want = vjp(jnp.asarray(g))
    kernel_switch(kernel)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = getattr(tops, op)(at, bt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(da_want), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_want), **TOL)


def test_dense_op_use_kernel_argument_overrides_the_config(kernel_switch):
    a, b = _operands(False, True, seed=7)
    kernel_switch(False)
    at = torch.from_numpy(a).requires_grad_(True)
    out = tops.transb_mm(at, torch.from_numpy(b), use_kernel=True)
    out.sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.ones((M, N)) @ b, **TOL)


def test_dense_op_needs_same_rank_operands():
    with pytest.raises(ValueError, match="same-rank"):
        tops.mm(torch.zeros(3, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="same-rank"):
        tops.mm(torch.zeros(4), torch.zeros(4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.mm(torch.zeros(2, 3, 4), torch.zeros(2, 4, 5))


def test_dense_linear_use_kernel_matches_the_default_route():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((6, 12)).astype(np.float32))
    layers = [tt.DenseLinear(12, 5, use_kernel=k, device="cpu",
                             generator=torch.Generator().manual_seed(0)) for k in (False, True)]
    outs = [layer(x) for layer in layers]
    torch.testing.assert_close(outs[0], outs[1], **TOL)
    for out in outs:
        out.square().sum().backward()
    torch.testing.assert_close(layers[0].kernel.grad, layers[1].kernel.grad, **TOL)
