"""Parity of the port's block-ELL SpMM (tpusparse_torch.kernels.tiled_spmm and
tpusparse_torch.ops) with the JAX package's Pallas executors, which run here
in interpret mode. On CPU tensors the port's wrappers run their plain
PyTorch version; the CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.ops as jops
import tpusparse.plan as jplan
from tpusparse.kernels.tiled_spmm import resident_spmm_pallas, tiled_spmm_pallas
from tpusparse.types import CSR as JCSR

import tpusparse_torch.ops as tops
import tpusparse_torch.plan as tplan
from tpusparse_torch.kernels import tiled_spmm as tk
from tpusparse_torch.types import COO as TCOO
from tpusparse_torch.types import CSR as TCSR
from tpusparse_torch.types import csr_to_coo

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
# bf16 output: the fp32 sums of two implementations may round to adjacent
# bf16 values (one ulp is 2^-8..2^-7 of the value); inputs are ~N(0, 1).
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)

# name: (m, k, n, density, blocksize, empty row range)
CASES = {
    "ragged_8x8": (100, 70, 33, 0.1, (8, 8), None),
    "ragged_8x32_n130": (100, 70, 130, 0.1, (8, 32), None),
    "empty_rowblock_16x16": (64, 48, 17, 0.2, (16, 16), (16, 32)),
    "ragged_32x8_n129": (75, 53, 129, 0.15, (32, 8), None),
    "empty_rowblock_8x16": (40, 50, 20, 0.2, (8, 16), (8, 24)),
    "empty_rowblock_128x128": (300, 260, 40, 0.05, (128, 128), (128, 256)),
}


def _case(name, seed=0):
    m, k, n, density, bs, empty = CASES[name]
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    dense = (mask * rng.standard_normal((m, k))).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    j = JCSR.from_dense(dense)
    t = TCSR.from_dense(dense, device="cpu")
    return dense, b, j, t, bs


@pytest.mark.parametrize("entry", ["tiled", "resident"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_plain_path_matches_pallas(name, entry):
    _, b, j, t, bs = _case(name)
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    jfn = tiled_spmm_pallas if entry == "tiled" else resident_spmm_pallas
    tfn = tk.tiled_spmm_kernel if entry == "tiled" else tk.resident_spmm_kernel
    want = np.asarray(jfn(pj, pj.pack_values(j.data), jnp.asarray(b)))
    got = tfn(pt, pt.pack_values(t.data), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_entry_points_bitwise_equal():
    _, b, _, t, bs = _case("ragged_8x32_n130")
    plan = tplan.build_plan(t, bs)
    bv = plan.pack_values(t.data)
    bt = torch.from_numpy(b)
    assert torch.equal(tk.tiled_spmm_kernel(plan, bv, bt), tk.resident_spmm_kernel(plan, bv, bt))


@pytest.mark.parametrize("entry", ["tiled", "resident"])
def test_bf16_operands_match_pallas(entry):
    _, b, j, t, bs = _case("ragged_8x32_n130")
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    jfn = tiled_spmm_pallas if entry == "tiled" else resident_spmm_pallas
    tfn = tk.tiled_spmm_kernel if entry == "tiled" else tk.resident_spmm_kernel
    want = jfn(pj, pj.pack_values(j.data).astype(jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    got = tfn(pt, pt.pack_values(t.data).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL_BF16)


def test_default_tier_matches_bf16_rounded_numpy():
    dense, b, _, t, bs = _case("ragged_32x8_n129")
    plan = tplan.build_plan(t, bs)
    bv, bt = plan.pack_values(t.data), torch.from_numpy(b)
    got = tk.tiled_spmm_kernel(plan, bv, bt, precision="default")

    def rnd(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()

    # bf16 x bf16 products are exact in fp32, so only the sums round
    np.testing.assert_allclose(got.numpy(), rnd(dense) @ rnd(b), **TOL)
    high = tk.tiled_spmm_kernel(plan, bv, bt, precision="high")
    assert not torch.equal(got, high)  # the tier really rounds
    np.testing.assert_allclose(high.numpy(), dense.astype(np.float64) @ b, **TOL)


def test_out_dtype_and_mixed_operands():
    dense, b, _, t, bs = _case("ragged_8x8")
    plan = tplan.build_plan(t, bs)
    bv = plan.pack_values(t.data)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    out = tk.tiled_spmm_kernel(plan, bv, bt)  # result type of f32 and bf16
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), dense @ bt.float().numpy(), **TOL)
    out16 = tk.resident_spmm_kernel(plan, bv, bt, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out.numpy(), **TOL_BF16)


@pytest.mark.parametrize("method", ["tiled", "resident", "reference"])
@pytest.mark.parametrize("name", ["ragged_8x32_n130", "empty_rowblock_16x16"])
def test_spmm_methods_match_jax(name, method):
    _, b, j, t, bs = _case(name)
    want = np.asarray(jops.spmm(j, jnp.asarray(b), method=method, blocksize=bs))
    got = tops.spmm(t, torch.from_numpy(b), method=method, blocksize=bs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("op", ["tiled_spmm", "resident_spmm"])
def test_named_ops_match_jax(op):
    _, b, j, t, bs = _case("ragged_32x8_n129")
    want = np.asarray(getattr(jops, op)(j, jnp.asarray(b), blocksize=bs))
    got = getattr(tops, op)(t, torch.from_numpy(b), blocksize=bs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmm_blocks_matches_jax():
    _, b, j, t, bs = _case("empty_rowblock_8x16")
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    want = np.asarray(jops.spmm_blocks(pj, pj.pack_values(j.data), jnp.asarray(b)))
    got = tops.spmm_blocks(pt, pt.pack_values(t.data), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmv_lift_and_coo_input_match_jax():
    _, b, j, t, bs = _case("ragged_8x8")
    v = b[:, 0].copy()
    want = np.asarray(jops.spmm(j, jnp.asarray(v), method="tiled", blocksize=bs))
    got = tops.spmm(t, torch.from_numpy(v), method="tiled", blocksize=bs)
    assert tuple(got.shape) == want.shape == (t.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_coo = tops.spmm(csr_to_coo(t), torch.from_numpy(b), blocksize=bs)
    assert isinstance(csr_to_coo(t), TCOO)
    np.testing.assert_allclose(got_coo.numpy(), np.asarray(jops.spmm(j, jnp.asarray(b), method="tiled", blocksize=bs)), **TOL)


def test_cpu_path_does_not_count_launches():
    _, b, _, t, bs = _case("ragged_8x8")
    tk.reset_launch_counts()
    tops.spmm(t, torch.from_numpy(b), blocksize=bs)
    assert tk.launch_counts() == {"tiled_spmm": 0, "resident_spmm": 0}


# -- errors -------------------------------------------------------------------


@pytest.mark.parametrize("call", ["spmm", "tiled_spmm", "resident_spmm"])
def test_wrong_b_shape_raises(call):
    _, _, _, t, _ = _case("ragged_8x8")
    with pytest.raises(ValueError, match="incompatible"):
        getattr(tops, call)(t, torch.zeros(t.shape[1] + 1, 4))


def test_unknown_method_raises():
    _, b, _, t, _ = _case("ragged_8x8")
    with pytest.raises(ValueError, match="unknown spmm method"):
        tops.spmm(t, torch.from_numpy(b), method="bogus")


@pytest.mark.parametrize("method", ["auto", "footprint", "gather", "dense", "naive", "dia"])
def test_unported_method_raises(method):
    _, b, _, t, _ = _case("ragged_8x8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.spmm(t, torch.from_numpy(b), method=method)


def test_unported_reducer_raises():
    _, b, _, t, _ = _case("ragged_8x8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.spmm(t, torch.from_numpy(b), method="reference", reduce="max")


@pytest.mark.parametrize("call", ["spmm", "tiled_spmm", "resident_spmm", "spmm_blocks"])
def test_3d_b_raises(call):
    _, _, _, t, bs = _case("ragged_8x8")
    b3 = torch.zeros(2, t.shape[1], 4)
    with pytest.raises(NotImplementedError, match="3-D"):
        if call == "spmm_blocks":
            plan = tplan.build_plan(t, bs)
            tops.spmm_blocks(plan, plan.pack_values(t.data), b3)
        else:
            getattr(tops, call)(t, b3)


@pytest.mark.parametrize("call", ["tiled_spmm", "spmm_blocks"])
def test_backward_raises(call):
    """The backward no longer raises: d(values) and dB of sum(A @ B) match
    jax.grad of the JAX op."""
    _, b, j, t, bs = _case("ragged_8x8")
    data = t.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    a = TCSR(data=data, indices=t.indices, indptr=t.indptr, shape=t.shape)

    def jf(vals, bb):
        if call == "spmm_blocks":
            pj = jplan.build_plan(j, bs)
            return jops.spmm_blocks(pj, pj.pack_values(vals), bb).sum()
        return jops.tiled_spmm(JCSR(vals, j.indices, j.indptr, j.shape), bb, blocksize=bs).sum()

    d_vals, d_b = jax.grad(jf, argnums=(0, 1))(j.data, jnp.asarray(b))
    if call == "spmm_blocks":
        plan = tplan.build_plan(a, bs)
        out = tops.spmm_blocks(plan, plan.pack_values(data), bt)
    else:
        out = tops.tiled_spmm(a, bt, blocksize=bs)
    out.sum().backward()
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(d_vals), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(d_b), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, b, _, t, bs = _case("ragged_8x8")
    plan = tplan.build_plan(t, bs)
    bv = plan.pack_values(t.data)
    bt = torch.from_numpy(b)
    with pytest.raises(ValueError, match="contiguous"):
        tk.tiled_spmm_kernel(plan, bv, torch.from_numpy(np.asfortranarray(b)))
    with pytest.raises(TypeError, match="dtype"):
        tk.tiled_spmm_kernel(plan, bv, bt.double())
    with pytest.raises(ValueError, match="block_vals shape"):
        tk.tiled_spmm_kernel(plan, bv[:-1], bt)
    with pytest.raises(ValueError, match="precision"):
        tk.tiled_spmm_kernel(plan, bv, bt, precision="tf32")
