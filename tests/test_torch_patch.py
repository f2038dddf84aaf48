"""The port's `nn.Linear` patch (tpusparse_torch.patch) against the JAX
package's flax `Dense` patch: tests/test_patch.py's cases on the port, each
then held against JAX on the same numpy inputs. The patched layer's output
and grads against `PatchedDense` with the parameters carried across: the
fp32 tier (rtol 1e-4, atol 5e-5); `sparsify_dense_params`' masks and CSR
exactly (the port's CSR is JAX's transposed: it prunes the (out, in)
weight, JAX the (in, out) kernel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse_torch as tt
from tpusparse.patch import PatchedDense, tpusparse_dot_general
from tpusparse.patch import sparsify_dense_params as jsparsify
from tpusparse_torch import kernels
from tpusparse_torch.patch import (
    PatchedLinear,
    patch_torch_linear,
    sparsify_dense_params,
    tpusparse_linear,
)

TOL = dict(rtol=1e-4, atol=5e-5)


def _carried(features=8, in_features=16, use_bias=True, seed=0):
    """PatchedDense's params and a PatchedLinear holding them."""
    x = jnp.zeros((1, in_features))
    params = PatchedDense(features, use_bias=use_bias).init(jax.random.PRNGKey(seed), x)
    lin = PatchedLinear(in_features, features, bias=use_bias)
    tt.load_flax_params(lin, jax.tree_util.tree_map(np.asarray, params))
    return params, lin


def test_linear_matches_float64_and_jax(rng):
    x = rng.normal(size=(4, 6, 8)).astype(np.float32)
    w = rng.normal(size=(5, 8)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    got = tpusparse_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    want = x.astype(np.float64) @ w.T.astype(np.float64) + b
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    jgot = tpusparse_dot_general(jnp.asarray(x), jnp.asarray(w.T), (((2,), (0,)), ((), ())))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot) + b, **TOL)


def test_linear_takes_a_vector(rng):
    # JAX falls back to lax.dot_general off nn.Dense's contraction; an
    # nn.Linear is only ever called with (..., in), a 1-D input included
    x = rng.normal(size=(8,)).astype(np.float32)
    w = rng.normal(size=(3, 8)).astype(np.float32)
    got = tpusparse_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), w.astype(np.float64) @ x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_patched_linear_parity_and_grads(rng, use_kernel):
    """Output and grads of PatchedLinear against nn.Linear and against
    JAX's PatchedDense on the carried params; with `use_gemm_kernel` the
    CPU takes the GEMM kernel's plain version (no launch)."""
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    params, lin = _carried()
    ref = torch.nn.Linear(16, 8)
    ref.load_state_dict(lin.state_dict())
    tt.set_config(use_gemm_kernel=use_kernel)
    kernels.reset_launch_counts()
    try:
        out = lin(torch.from_numpy(x))
        (out ** 2).sum().backward()
    finally:
        tt.set_config(use_gemm_kernel=False)
    assert not any(kernels.launches_by_kernel().values())
    ref_out = ref(torch.from_numpy(x))
    (ref_out ** 2).sum().backward()
    torch.testing.assert_close(out, ref_out, **TOL)
    for p, q in zip(lin.parameters(), ref.parameters()):
        torch.testing.assert_close(p.grad, q.grad, **TOL)
    layer = PatchedDense(8)
    jout = layer.apply(params, jnp.asarray(x))
    g = jax.grad(lambda p: jnp.sum(layer.apply(p, jnp.asarray(x)) ** 2))(params)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lin.weight.grad.numpy(), np.asarray(g["params"]["kernel"]).T, **TOL)
    np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(g["params"]["bias"]), **TOL)


def test_patched_dense_params_carry_across():
    for use_bias in (True, False):
        params, lin = _carried(use_bias=use_bias, seed=3)
        assert (lin.bias is None) != use_bias
        back = tt.to_flax_params(lin)
        assert set(back["params"]) == set(params["params"])
        for k, v in params["params"].items():
            np.testing.assert_array_equal(back["params"][k], np.asarray(v))


def test_patch_context_rebinds_and_restores():
    import torch.nn.modules.linear as linear

    original = torch.nn.Linear
    with patch_torch_linear() as cls:
        assert cls is PatchedLinear
        assert torch.nn.Linear is PatchedLinear and linear.Linear is PatchedLinear
        layer = torch.nn.Linear(4, 2)
        assert isinstance(layer, PatchedLinear)
    assert torch.nn.Linear is original and linear.Linear is original


def test_patch_context_restores_on_error():
    import torch.nn.modules.linear as linear

    original = torch.nn.Linear
    with pytest.raises(RuntimeError):
        with patch_torch_linear():
            raise RuntimeError("boom")
    assert torch.nn.Linear is original and linear.Linear is original


def _same_pruning(w, **mode):
    """The port's pruning of the (out, in) weight `w` and JAX's of its
    kernel wᵀ: equal masks and values, the CSR transposed."""
    pruned, sparse = sparsify_dense_params({"fc.weight": torch.from_numpy(w),
                                            "fc.bias": torch.zeros(w.shape[0])},
                                           ["weight"], **mode)
    (name, csr), = sparse.items()
    assert name == "fc.weight" and csr.shape == w.shape
    jpruned, jsparse = jsparsify({"params": {"fc": {"kernel": jnp.asarray(w.T)}}}, ["kernel"],
                                 **mode)
    (_, jcsr), = jsparse.items()
    np.testing.assert_array_equal(pruned["fc.weight"].numpy(),
                                  np.asarray(jpruned["params"]["fc"]["kernel"]).T)
    np.testing.assert_array_equal(csr.to_dense().numpy(), np.asarray(jcsr.to_dense()).T)
    np.testing.assert_array_equal(csr.to_dense().numpy(), pruned["fc.weight"].numpy())
    assert torch.equal(pruned["fc.bias"], torch.zeros(w.shape[0]))
    return csr


def test_sparsify_dense_params_density(rng):
    lin = torch.nn.Linear(16, 8)
    csr = _same_pruning(lin.weight.detach().numpy(), density=0.25)
    assert csr.nnz == pytest.approx(0.25 * 16 * 8, abs=2)


def test_sparsify_requires_exactly_one_mode():
    sd = torch.nn.Linear(4, 4).state_dict()
    with pytest.raises(ValueError):
        sparsify_dense_params(sd, ["weight"])
    with pytest.raises(ValueError):
        sparsify_dense_params(sd, ["weight"], threshold=0.1, density=0.5)


def test_sparsify_dense_params_threshold(rng):
    w = rng.normal(size=(12, 10)).astype(np.float32)
    csr = _same_pruning(w, threshold=0.5)
    expected = np.abs(w) >= 0.5
    assert csr.nnz == expected.sum()
    np.testing.assert_allclose(csr.to_dense().numpy(), w * expected, rtol=1e-6)
    # the CSR is what SparseLinear consumes: the pruned layer's product
    x = torch.from_numpy(rng.normal(size=(3, 10)).astype(np.float32))
    torch.testing.assert_close(tt.spmm(csr, x.T).T, x @ torch.from_numpy(w * expected).T, **TOL)


def test_sparsify_dense_params_of_bf16_matches_jax():
    """A bf16 weight at density 0.3: JAX's 14 nonzeros and a bf16 weight,
    exactly."""
    w = np.random.default_rng(0).standard_normal((8, 6))
    pruned, sparse = sparsify_dense_params({"fc.weight": torch.tensor(w, dtype=torch.bfloat16)},
                                           ["weight"], density=0.3)
    jpruned, jsparse = jsparsify({"params": {"fc": {"kernel": jnp.asarray(w.T, jnp.bfloat16)}}},
                                 ["kernel"], density=0.3)
    (csr,), (jcsr,) = sparse.values(), jsparse.values()
    kernel = jpruned["params"]["fc"]["kernel"]
    assert pruned["fc.weight"].dtype == torch.bfloat16 and kernel.dtype == jnp.bfloat16
    assert csr.data.dtype == torch.bfloat16 and jcsr.data.dtype == jnp.bfloat16
    assert csr.nnz == jcsr.nnz == 14
    np.testing.assert_array_equal(pruned["fc.weight"].float().numpy(),
                                  np.asarray(kernel, np.float32).T)
    np.testing.assert_array_equal(csr.to_dense().float().numpy(),
                                  np.asarray(jcsr.to_dense(), np.float32).T)
