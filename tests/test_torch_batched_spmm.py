"""Parity of the port's batched (3-D) block SpMM, `dsmm`, `transpose_csr` and
the container methods that use them with the JAX package, whose Pallas
executors run here in interpret mode. On CPU tensors the port's batched
wrapper runs its plain PyTorch version; the CUDA kernel is held against it
on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.ops as jops
import tpusparse.plan as jplan
import tpusparse.types as jtypes
from tpusparse.kernels.tiled_spmm import resident_spmm_batched_pallas, resident_spmm_pallas
from tpusparse.types import CSR as JCSR

import tpusparse_torch as tt
import tpusparse_torch.ops as tops
import tpusparse_torch.plan as tplan
import tpusparse_torch.types as ttypes
from tpusparse_torch.kernels import tiled_spmm as tk
from tpusparse_torch.types import CSR as TCSR

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
# bf16 output: the fp32 sums of two implementations may round to adjacent
# bf16 values (one ulp is 2^-8..2^-7 of the value); inputs are ~N(0, 1).
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)

# name: (m, k, n, batch, density, blocksize, empty row range)
CASES = {
    "ragged_8x16_b3": (50, 70, 33, 3, 0.2, (8, 16), None),
    "ragged_32x8_b2_n65": (75, 53, 65, 2, 0.15, (32, 8), None),
    "empty_rowblock_16x16_b1": (64, 48, 17, 1, 0.3, (16, 16), (16, 32)),
    # the batched executor's tile edges: bm 5 and 24 (the n-major tile), 72
    # (two warpgroups); n 1, 130 and 64; row-blocks with no slot
    "bm5_n1_b3_empty": (43, 37, 1, 3, 0.2, (5, 8), (10, 20)),
    "bm24_n130_b2_empty": (100, 70, 130, 2, 0.15, (24, 16), (24, 48)),
    "bm72_n64_b2": (150, 90, 64, 2, 0.15, (72, 32), None),
    # fewer blocks than block-columns: the forward folds, dB is batched
    "low_reuse_8x8_b4": (16, 400, 9, 4, 0.005, (8, 8), None),
    # the transpose of that: the forward is batched, dB folds
    "tall_8x8_b2": (400, 16, 7, 2, 0.005, (8, 8), None),
}


def _case(name, seed=0):
    m, k, n, batch, density, bs, empty = CASES[name]
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    mask[0, 0] = True  # at least one nonzero
    dense = (mask * rng.standard_normal((m, k))).astype(np.float32)
    b3 = rng.standard_normal((batch, k, n)).astype(np.float32)
    return dense, b3, JCSR.from_dense(dense), TCSR.from_dense(dense, device="cpu"), bs


def _with(a, data):
    return type(a)(data, a.indices, a.indptr, a.shape)


# -- the batched kernel (queue 2 row 3) ----------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_kernel_plain_path_matches_pallas(name):
    _, b3, j, t, bs = _case(name)
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    want = np.asarray(resident_spmm_batched_pallas(pj, pj.pack_values(j.data), jnp.asarray(b3)))
    got = tk.resident_spmm_batched_kernel(pt, pt.pack_values(t.data), torch.from_numpy(b3))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_batched_kernel_equals_2d_kernel_per_batch_element():
    """C[g] against the 2-D entry point on B[g] and JAX's per-element
    resident executor (which JAX holds bitwise to its batched one)."""
    _, b3, j, t, bs = _case("ragged_8x16_b3")
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    bv = pt.pack_values(t.data)
    got = tk.resident_spmm_batched_kernel(pt, bv, torch.from_numpy(b3))
    for g in range(b3.shape[0]):
        two_d = tk.resident_spmm_kernel(pt, bv, torch.from_numpy(b3[g]))
        np.testing.assert_allclose(got[g].numpy(), two_d.numpy(), rtol=1e-6, atol=1e-6)
        want = resident_spmm_pallas(pj, pj.pack_values(j.data), jnp.asarray(b3[g]))
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("vals_dtype,b_dtype", [(torch.bfloat16, torch.bfloat16),
                                                (torch.float32, torch.bfloat16)])
def test_batched_kernel_bf16_operands_match_pallas(vals_dtype, b_dtype):
    _, b3, j, t, bs = _case("ragged_32x8_b2_n65")
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    jv = pj.pack_values(j.data).astype(jnp.dtype(str(vals_dtype).split(".")[1]))
    jb = jnp.asarray(b3).astype(jnp.dtype(str(b_dtype).split(".")[1]))
    want = resident_spmm_batched_pallas(pj, jv, jb)
    got = tk.resident_spmm_batched_kernel(pt, pt.pack_values(t.data).to(vals_dtype),
                                          torch.from_numpy(b3).to(b_dtype))
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL_BF16)


def test_batched_kernel_default_tier_matches_bf16_rounded_numpy():
    dense, b3, _, t, bs = _case("ragged_8x16_b3")
    plan = tplan.build_plan(t, bs)
    got = tk.resident_spmm_batched_kernel(plan, plan.pack_values(t.data), torch.from_numpy(b3),
                                          precision="default")

    def rnd(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()

    np.testing.assert_allclose(got.numpy(), np.einsum("ij,bjk->bik", rnd(dense), rnd(b3)), **TOL)


def test_batched_kernel_rejects_what_it_does_not_take():
    _, b3, _, t, bs = _case("ragged_8x16_b3")
    plan = tplan.build_plan(t, bs)
    bv = plan.pack_values(t.data)
    with pytest.raises(ValueError, match="incompatible"):
        tk.resident_spmm_batched_kernel(plan, bv, torch.from_numpy(b3[0]))
    with pytest.raises(ValueError, match="contiguous"):
        tk.resident_spmm_batched_kernel(plan, bv, torch.from_numpy(b3).transpose(1, 2)
                                        .contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="dtype"):
        tk.resident_spmm_batched_kernel(plan, bv, torch.from_numpy(b3).double())


# -- the ops: routes, fold helpers, gradients ------------------------------------


def test_fold_cols_round_trip_matches_jax():
    b3 = np.random.default_rng(3).standard_normal((3, 5, 4)).astype(np.float32)
    folded = tops._fold_cols(torch.from_numpy(b3))
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jops._fold_cols(jnp.asarray(b3))))
    assert folded.is_contiguous()
    np.testing.assert_array_equal(tops._unfold_cols(folded, 3, 4).numpy(), b3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_resident_ok_keeps_the_reuse_test(name):
    _, b3, _, t, bs = _case(name)
    plan, plan_t, _ = tplan.build_plan_pair(t, bs)
    for p in (plan, plan_t):
        assert tops._batched_resident_ok(p, torch.from_numpy(b3)) == (
            p.nblocks >= p.num_col_blocks)
    b = torch.from_numpy(b3)
    assert tops._batched_resident_ok(plan, b) == (name != "low_reuse_8x8_b4")
    assert tops._batched_resident_ok(plan_t, b) == (name != "tall_8x8_b2")


@pytest.mark.parametrize("method", ["tiled", "resident", "footprint"])
def test_spmm_batched_b(rng, method):
    """test_ops.py::test_spmm_batched_b: a 3-D b under a shared pattern,
    against JAX's same method and the per-element oracle."""
    a = jtypes.random_csr(6, (32, 48), 0.1)
    ta = TCSR(torch.from_numpy(np.array(a.data)), np.asarray(a.indices),
              np.asarray(a.indptr), a.shape)
    b = rng.random((4, 48, 16), dtype=np.float32)
    got = tops.spmm(ta, torch.from_numpy(b), method=method)
    assert tuple(got.shape) == (4, 32, 16)
    want = jops.spmm(a, jnp.asarray(b), method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = jax.vmap(lambda bb: jtypes.spmm_reference(a, bb))(jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_spmm_batched_4d_bert_shape(rng):
    """test_ops.py::test_spmm_batched_4d_bert_shape: leading dims fold to one
    batch, which takes the batched executor."""
    a = jtypes.random_csr(17, (64, 64), 0.1)
    ta = TCSR(torch.from_numpy(np.array(a.data)), np.asarray(a.indices),
              np.asarray(a.indptr), a.shape)
    b = rng.random((3, 2, 64, 16), dtype=np.float32)
    got = tops.spmm(ta, torch.from_numpy(b), method="tiled")
    assert tuple(got.shape) == (3, 2, 64, 16)
    want = jops.spmm(a, jnp.asarray(b), method="tiled")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = jax.vmap(jax.vmap(lambda bb: jtypes.spmm_reference(a, bb)))(jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", ["tiled_spmm", "resident_spmm", "spmm"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_ops_match_jax(name, op):
    _, b3, j, t, bs = _case(name)
    kw = dict(method="tiled") if op == "spmm" else {}
    got = getattr(tops, op)(t, torch.from_numpy(b3), blocksize=bs, **kw)
    want = getattr(jops, op)(j, jnp.asarray(b3), blocksize=bs, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("op", ["tiled_spmm", "resident_spmm"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_grads_match_jax_vjp(name, op):
    """d(values) and dB of <C, G> for a seeded G, against jax.vjp of the JAX
    op: both routes of the forward (the batched executor, or the fold where
    the pattern fails the reuse test) and both of dB."""
    _, b3, j, t, bs = _case(name)
    g = np.random.default_rng(9).standard_normal(
        (b3.shape[0], t.shape[0], b3.shape[2])).astype(np.float32)
    data = t.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b3).requires_grad_(True)
    getattr(tops, op)(_with(t, data), bt, blocksize=bs).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda v, bb: getattr(jops, op)(_with(j, v), bb, blocksize=bs),
                     j.data, jnp.asarray(b3))
    d_vals, d_b = vjp(jnp.asarray(g))
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(d_vals), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(d_b), **TOL)


def test_spmm_batched_grads():
    """test_ops.py::test_spmm_batched_grads: gradients of a 3-D tiled_spmm
    with explicit plans, against jax.vjp and a float64 oracle."""
    a = jtypes.random_csr(18, (32, 48), 0.1)
    ta = TCSR(torch.from_numpy(np.array(a.data)), np.asarray(a.indices),
              np.asarray(a.indptr), a.shape)
    b = np.random.default_rng(123).random((3, 48, 16), dtype=np.float32)
    data = ta.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    plans = tplan.build_plan_pair(ta, (8, 16))
    out = tops.tiled_spmm(_with(ta, data), bt, plans=plans)
    (out ** 2).sum().backward()
    jplans = jplan.build_plan_pair(a, blocksize=(8, 16))
    d_vals, d_b = jax.grad(
        lambda v, bb: jnp.sum(jops.tiled_spmm(_with(a, v), bb, plans=jplans) ** 2),
        argnums=(0, 1))(a.data, jnp.asarray(b))
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(d_vals), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(d_b), **TOL)
    ad = np.asarray(a.to_dense(), np.float64)
    y0 = np.einsum("ij,bjk->bik", ad, b.astype(np.float64))
    np.testing.assert_allclose(bt.grad.numpy(), 2.0 * np.einsum("ji,bjk->bik", ad, y0),
                               rtol=1e-4, atol=1e-4)


def test_batched_fp16_b_widens_like_jax():
    _, b3, j, t, bs = _case("ragged_8x16_b3")
    b16 = b3.astype(np.float16)
    got = tops.tiled_spmm(t, torch.from_numpy(b16), blocksize=bs)
    want = jops.tiled_spmm(j, jnp.asarray(b16), blocksize=bs)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batched_rank_errors():
    _, b3, _, t, bs = _case("ragged_8x16_b3")
    b4 = torch.from_numpy(b3)[None]
    for op in (tops.tiled_spmm, tops.resident_spmm, tops.footprint_spmm):
        with pytest.raises(ValueError, match="2-D/3-D"):
            op(t, b4, blocksize=bs)


def test_batched_cpu_path_counts_no_launch():
    _, b3, _, t, bs = _case("ragged_8x16_b3")
    tk.reset_launch_counts()
    tops.tiled_spmm(t, torch.from_numpy(b3), blocksize=bs)
    assert tk.launch_counts()["resident_spmm_batched"] == 0


# -- dsmm, transpose_csr and the container methods ----------------------------------


def _pair_csr(seed, shape, density):
    j = jtypes.random_csr(seed, shape, density)
    t = TCSR(torch.from_numpy(np.array(j.data)), np.asarray(j.indices, np.int32),
             np.asarray(j.indptr, np.int32), j.shape)
    return j, t


def test_transpose_csr_matches_jax():
    j, t = _pair_csr(0, (40, 24), 0.15)
    jt_, tt_ = jops.transpose_csr(j), tops.transpose_csr(t)
    assert tt_.shape == jt_.shape == (24, 40)
    np.testing.assert_array_equal(tt_.indices, np.asarray(jt_.indices))
    np.testing.assert_array_equal(tt_.indptr, np.asarray(jt_.indptr))
    np.testing.assert_array_equal(tt_.data.numpy(), np.asarray(jt_.data))
    assert tops.transpose_csr(t).indices is tt_.indices  # the pattern is cached


def test_transpose_csr_is_differentiable():
    _, t = _pair_csr(1, (16, 12), 0.3)
    data = t.data.clone().requires_grad_(True)
    w = torch.arange(t.nnz, dtype=torch.float32)
    (tops.transpose_csr(_with(t, data)).data * w[: t.nnz]).sum().backward()
    perm = np.argsort(t.indices, kind="stable")
    want = np.zeros(t.nnz, np.float32)
    want[perm] = np.arange(t.nnz)
    np.testing.assert_array_equal(data.grad.numpy(), want)


def test_csr_transpose():
    """test_types.py::test_csr_transpose, with COO's transpose and density."""
    rng = np.random.default_rng(5)
    mat = ((rng.random((48, 80)) < 0.1) * rng.standard_normal((48, 80))).astype(np.float32)
    csr = TCSR.from_dense(mat, device="cpu")
    np.testing.assert_array_equal(csr.T.to_dense().numpy(), mat.T)
    np.testing.assert_array_equal(csr.transpose().to_dense().numpy(), mat.T)
    coo = ttypes.csr_to_coo(csr)
    np.testing.assert_array_equal(coo.T.to_dense().numpy(), mat.T)
    jc = JCSR.from_dense(mat)
    assert csr.density == jc.density and coo.density == jtypes.csr_to_coo(jc).density
    np.testing.assert_array_equal(csr.T.indices, np.asarray(jc.T.indices))


@pytest.mark.parametrize("x_shape", [(40,), (6, 40), (2, 3, 40)])
@pytest.mark.parametrize("method", ["tiled", "gather", "reference"])
def test_dsmm_matches_jax(rng, x_shape, method):
    """test_elementwise.py::test_dsmm_matches_dense for the ported methods."""
    j, t = _pair_csr(0, (40, 24), 0.15)
    x = rng.random(x_shape, dtype=np.float32)
    got = tops.dsmm(torch.from_numpy(x), t, method=method)
    want = jops.dsmm(jnp.asarray(x), j, method=method)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = x.astype(np.float64) @ np.asarray(j.to_dense(), np.float64)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_dsmm_tiled_route_and_grads(rng):
    """test_elementwise.py::test_dsmm_tiled_route, with the gradients of
    <X @ A, G> in x and A's values against jax.vjp."""
    j, t = _pair_csr(1, (64, 48), 0.2)
    x = rng.random((8, 64), dtype=np.float32)
    g = rng.standard_normal((8, 48)).astype(np.float32)
    data = t.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tops.dsmm(xt, _with(t, data), method="tiled")
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(lambda xx, v: jops.dsmm(xx, _with(j, v), method="tiled"),
                        jnp.asarray(x), j.data)
    dx, dv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(dv), **TOL)


def test_dsmm_rejects_k_mismatch():
    _, t = _pair_csr(0, (40, 24), 0.15)
    with pytest.raises(ValueError, match="incompatible"):
        tops.dsmm(torch.zeros(3, 39), t)


def test_csr_matmul_operators_match_jax(rng):
    j, t = _pair_csr(2, (32, 24), 0.2)
    b = rng.random((24, 5), dtype=np.float32)
    x = rng.random((3, 32), dtype=np.float32)
    np.testing.assert_allclose((t @ torch.from_numpy(b)).numpy(),
                               np.asarray(jops.spmm(j, jnp.asarray(b), method="tiled")), **TOL)
    np.testing.assert_allclose((t @ b).numpy(), np.asarray(j @ jnp.asarray(b)), **TOL)
    np.testing.assert_allclose((torch.from_numpy(x) @ t).numpy(),
                               np.asarray(jnp.asarray(x) @ j), **TOL)
    np.testing.assert_allclose((x @ t).numpy(), np.asarray(x @ j), **TOL)
    j, t = _pair_csr(3, (24, 24), 0.2)  # square, for A @ A
    c, jc = t @ t, j @ j  # spgemm in both packages
    np.testing.assert_array_equal(c.indptr, np.asarray(jc.indptr))
    np.testing.assert_array_equal(c.indices, np.asarray(jc.indices))
    np.testing.assert_allclose(c.data.numpy(), np.asarray(jc.data), **TOL)


def test_random_powerlaw_csr_equals_jax():
    """For an int seed both packages draw everything from numpy: the same
    matrix, with test_routing.py::test_random_powerlaw_csr_skew's shape."""
    j = jtypes.random_powerlaw_csr(0, (512, 512), avg_nnz_per_row=8.0)
    t = ttypes.random_powerlaw_csr(0, (512, 512), avg_nnz_per_row=8.0, device="cpu")
    np.testing.assert_array_equal(t.indptr, np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    deg = np.diff(t.indptr)
    assert deg.min() >= 1 and 4.0 <= deg.mean() <= 12.0 and deg.max() > 5 * deg.mean()


def test_random_coo_exact_nnz_and_random_csr_from_it():
    coo = ttypes.random_coo(1, (32, 48), 0.25, device="cpu")
    assert coo.nnz == int(round(0.25 * 32 * 48))
    flat = coo.row.astype(np.int64) * 48 + coo.col
    assert (np.diff(flat) > 0).all()  # row-major, no duplicates
    csr = ttypes.random_csr(1, (32, 48), 0.25, device="cpu")
    np.testing.assert_array_equal(csr.to_dense().numpy(), coo.to_dense().numpy())
    assert isinstance(tt.random_coo(2, (4, 4), 0.5, device="cpu"), ttypes.COO)


def test_spmm_powerlaw_block_methods_match_jax(rng):
    """test_routing.py::test_spmm_powerlaw_all_methods for the ported block
    routes: the same skewed matrix through both packages."""
    j = jtypes.random_powerlaw_csr(1, (128, 160), avg_nnz_per_row=4.0)
    t = ttypes.random_powerlaw_csr(1, (128, 160), avg_nnz_per_row=4.0, device="cpu")
    b = rng.normal(size=(160, 32)).astype(np.float32)
    for method in ("tiled", "footprint", "gather", "reference"):
        got = tops.spmm(t, torch.from_numpy(b), method=method)
        want = jops.spmm(j, jnp.asarray(b), method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=method)
