"""Parity of the port's sparse elementwise algebra and dense × sparse product
with the JAX package: tests/test_elementwise.py's cases through both
packages on the same inputs, each also against numpy/scipy in float64
where the JAX test holds it there. Patterns must be equal; values and
gradients agree within the fp32 tier (TOL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import tpusparse as ts
from tpusparse import random_csr, random_powerlaw_csr
from tpusparse.types import CSR as JCSR

import tpusparse_torch as tt
from tpusparse_torch import elementwise as te
from tpusparse_torch.types import CSR as TCSR

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite


def _port(j, requires_grad=False) -> TCSR:
    data = torch.from_numpy(np.array(j.data)).requires_grad_(requires_grad)
    return TCSR(data, np.asarray(j.indices, np.int32), np.asarray(j.indptr, np.int32),
                tuple(j.shape))


def _pair(seed, shape, density):
    j = random_csr(seed, shape, density)
    return j, _port(j)


def _same(tc, jc, tol=TOL):
    """Equal shape and pattern, values within `tol` (None: equal)."""
    assert tuple(tc.shape) == tuple(jc.shape)
    np.testing.assert_array_equal(tc.indptr, np.asarray(jc.indptr))
    np.testing.assert_array_equal(tc.indices, np.asarray(jc.indices))
    got, want = tc.data.detach().numpy(), np.asarray(jc.data)
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


def _dense64(a):
    return a.to_dense().detach().double().numpy()


def _grads_match(jfn, tfn, mats):
    """Gradients of sum(out.data**2) w.r.t. every operand's values, from
    both packages (tests/test_elementwise.py runs check_grads there)."""
    def jloss(*datas):
        out = jfn(*[JCSR(d, m.indices, m.indptr, m.shape) for d, m in zip(datas, mats)])
        return jnp.sum(out.data ** 2)

    want = jax.grad(jloss, argnums=tuple(range(len(mats))))(*[m.data for m in mats])
    ports = [_port(m, True) for m in mats]
    (tfn(*ports).data ** 2).sum().backward()
    for p, w in zip(ports, want):
        np.testing.assert_allclose(p.data.grad.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# dsmm: dense × sparse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_shape", [(40,), (6, 40), (2, 3, 40)])
@pytest.mark.parametrize("method", ["tiled", "gather", "reference"])
def test_dsmm_matches_jax_and_dense(rng, x_shape, method):
    ja, ta = _pair(0, (40, 24), 0.15)
    x = rng.random(x_shape, dtype=np.float32)
    got = tt.dsmm(torch.from_numpy(x), ta, method=method)
    want = ts.dsmm(jnp.asarray(x), ja, method=method)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = x.astype(np.float64) @ _dense64(ta)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_dsmm_shape_mismatch():
    _, ta = _pair(0, (40, 24), 0.15)
    with pytest.raises(ValueError, match="incompatible"):
        tt.dsmm(torch.zeros((6, 24)), ta)


def test_dsmm_grads_match_jax(rng):
    ja, _ = _pair(2, (32, 20), 0.2)
    x = rng.random((4, 32), dtype=np.float32)
    jx, jd = jax.grad(lambda xx, ad: jnp.sum(ts.dsmm(xx, JCSR(ad, ja.indices, ja.indptr, ja.shape),
                                                     method="gather") ** 2),
                      argnums=(0, 1))(jnp.asarray(x), ja.data)
    ta = _port(ja, True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tt.dsmm(tx, ta, method="gather") ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(ta.data.grad.numpy(), np.asarray(jd), **TOL)


def test_transpose_csr_matches_jax_and_scipy():
    ja = random_powerlaw_csr(3, (48, 32), avg_nnz_per_row=3.0)
    ta = _port(ja)
    at = tt.transpose_csr(ta)
    _same(at, ts.transpose_csr(ja), tol=None)
    np.testing.assert_array_equal(at.to_dense().numpy(), ta.to_dense().numpy().T)


# ---------------------------------------------------------------------------
# add / hadamard / scale / map
# ---------------------------------------------------------------------------


def test_sp_add_matches_jax_and_scipy():
    ja, ta = _pair(5, (32, 40), 0.1)
    jb, tb = _pair(6, (32, 40), 0.15)
    c = tt.sp_add(ta, tb, alpha=2.0, beta=-0.5)
    _same(c, ts.sp_add(ja, jb, alpha=2.0, beta=-0.5))
    np.testing.assert_allclose(c.to_dense().numpy(), 2.0 * _dense64(ta) - 0.5 * _dense64(tb),
                               rtol=1e-5, atol=1e-6)
    pat = (ta.to_scipy().astype(bool) + tb.to_scipy().astype(bool)).astype(bool).tocsr()
    assert c.nnz == pat.nnz
    np.testing.assert_array_equal(c.indptr, pat.indptr)


def test_sp_add_keeps_cancelled_slots():
    def one(v):
        return TCSR(torch.tensor([v]), np.array([2], np.int32), np.array([0, 1], np.int32), (1, 4))
    c = tt.sp_add(one(1.0), one(-1.0))
    assert c.nnz == 1 and float(c.data[0]) == 0.0


def test_sp_sub_and_scale_match_jax():
    ja, ta = _pair(7, (16, 16), 0.2)
    z = tt.sp_sub(ta, ta)
    _same(z, ts.sp_sub(ja, ja), tol=None)
    assert float(z.data.abs().max()) == 0.0
    _same(tt.sp_scale(ta, 2.0), ts.sp_scale(ja, 2.0), tol=None)
    per = np.linspace(-1, 1, ta.nnz).astype(np.float32)  # a per-nonzero scale
    _same(tt.sp_scale(ta, per), ts.sp_scale(ja, jnp.asarray(per)), tol=None)


def test_sp_hadamard_matches_jax_and_scipy():
    ja, ta = _pair(8, (32, 24), 0.2)
    jb, tb = _pair(9, (32, 24), 0.25)
    c = tt.sp_hadamard(ta, tb)
    _same(c, ts.sp_hadamard(ja, jb), tol=None)
    np.testing.assert_allclose(c.to_dense().numpy(), _dense64(ta) * _dense64(tb),
                               rtol=1e-5, atol=1e-6)
    inter = ta.to_scipy().astype(bool).multiply(tb.to_scipy().astype(bool)).tocsr()
    assert c.nnz == inter.nnz


def test_sp_add_hadamard_grads_match_jax():
    ja, _ = _pair(10, (16, 20), 0.2)
    jb, _ = _pair(11, (16, 20), 0.2)
    _grads_match(lambda a, b: ts.sp_add(a, b, alpha=1.5, beta=-2.0),
                 lambda a, b: tt.sp_add(a, b, alpha=1.5, beta=-2.0), (ja, jb))
    _grads_match(ts.sp_hadamard, tt.sp_hadamard, (ja, jb))


def test_sp_map():
    ja, ta = _pair(12, (8, 8), 0.3)
    m = tt.sp_map(ta, torch.abs)
    _same(m, ts.sp_map(ja, jnp.abs), tol=None)
    assert (m.data >= 0).all() and m.nnz == ta.nnz


def test_shape_mismatch_raises():
    _, ta = _pair(0, (8, 8), 0.2)
    _, tb = _pair(1, (8, 9), 0.2)
    with pytest.raises(ValueError, match="shape mismatch"):
        tt.sp_add(ta, tb)
    with pytest.raises(ValueError, match="shape mismatch"):
        tt.sp_hadamard(ta, tb)


# ---------------------------------------------------------------------------
# prune
# ---------------------------------------------------------------------------


def test_prune_threshold_matches_jax():
    ja, ta = _pair(13, (32, 32), 0.3)
    p = tt.prune_csr(ta, threshold=0.5)
    _same(p, ts.prune_csr(ja, threshold=0.5), tol=None)
    d = ta.to_dense().numpy()
    np.testing.assert_array_equal(p.to_dense().numpy(), np.where(np.abs(d) > 0.5, d, 0.0))


def test_prune_density_matches_jax():
    ja, ta = _pair(14, (32, 32), 0.5)
    p = tt.prune_csr(ta, density=0.4)
    _same(p, ts.prune_csr(ja, density=0.4), tol=None)
    keep_n = max(1, int(round(0.4 * ta.nnz)))
    assert p.nnz == keep_n
    np.testing.assert_array_equal(np.sort(p.data.abs().numpy()),
                                  np.sort(ta.data.abs().numpy())[-keep_n:])


def test_prune_density_breaks_ties_as_jax():
    """Ties at the threshold keep the first entries (elementwise.py:169-217)."""
    vals = np.array([3.0, 1.0, 2.0, 2.0, 2.0, 0.5, 2.0], np.float32)
    ja = JCSR(jnp.asarray(vals), jnp.arange(7, dtype=jnp.int32),
              jnp.array([0, 3, 7], jnp.int32), (2, 7))
    for density in (3 / 7, 4 / 7):
        p = tt.prune_csr(_port(ja), density=density)
        _same(p, ts.prune_csr(ja, density=density), tol=None)


def test_prune_arg_validation():
    _, ta = _pair(0, (8, 8), 0.2)
    with pytest.raises(ValueError, match="exactly one"):
        tt.prune_csr(ta)
    with pytest.raises(ValueError, match="exactly one"):
        tt.prune_csr(ta, threshold=0.1, density=0.5)


# ---------------------------------------------------------------------------
# reductions / norms
# ---------------------------------------------------------------------------


def test_row_col_reduce_match_jax():
    ja = random_powerlaw_csr(15, (24, 16), avg_nnz_per_row=3.0)
    ta = _port(ja)
    d = _dense64(ta)
    for mode in ("sum", "mean", "min", "max", "nnz"):
        np.testing.assert_allclose(tt.row_reduce(ta, mode).numpy(),
                                   np.asarray(ts.row_reduce(ja, mode)), **TOL, err_msg=mode)
        np.testing.assert_allclose(tt.col_reduce(ta, mode).numpy(),
                                   np.asarray(ts.col_reduce(ja, mode)), **TOL, err_msg=mode)
    np.testing.assert_allclose(tt.row_reduce(ta, "sum").numpy(), d.sum(axis=1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tt.col_reduce(ta, "sum").numpy(), d.sum(axis=0), rtol=1e-5,
                               atol=1e-6)
    nnz = tt.row_reduce(ta, "nnz")
    assert nnz.dtype == torch.int32
    np.testing.assert_array_equal(nnz.numpy(), np.diff(ta.indptr))


def test_row_reduce_empty_rows_and_modes():
    ta = TCSR(torch.tensor([2.0, -3.0, 4.0]), np.array([0, 1, 2], np.int32),
              np.array([0, 2, 2, 3], np.int32), (3, 4))
    np.testing.assert_allclose(tt.row_reduce(ta, "max").numpy(), [2.0, 0.0, 4.0])
    np.testing.assert_allclose(tt.row_reduce(ta, "min").numpy(), [-3.0, 0.0, 4.0])
    np.testing.assert_allclose(tt.row_reduce(ta, "mean").numpy(), [-0.5, 0.0, 4.0])
    with pytest.raises(ValueError, match="unknown reduce"):
        tt.row_reduce(ta, "prod")


def test_vstack_hstack_block_diag_match_jax():
    jmats = [random_csr(20, (8, 12), 0.2),
             random_powerlaw_csr(21, (5, 12), avg_nnz_per_row=2.0),
             random_csr(22, (3, 12), 0.5)]
    tmats = [_port(m) for m in jmats]
    v = tt.vstack(tmats)
    _same(v, ts.vstack(jmats), tol=None)
    np.testing.assert_array_equal(v.to_dense().numpy(),
                                  np.concatenate([m.to_dense().numpy() for m in tmats]))
    jh = [random_csr(23, (7, 8), 0.2), random_csr(24, (7, 5), 0.4), random_csr(25, (7, 16), 0.1)]
    th = [_port(m) for m in jh]
    h = tt.hstack(th)
    _same(h, ts.hstack(jh), tol=None)
    np.testing.assert_array_equal(h.to_dense().numpy(),
                                  np.concatenate([m.to_dense().numpy() for m in th], axis=1))
    for r in range(h.shape[0]):  # sorted within rows
        assert (np.diff(h.indices[h.indptr[r]:h.indptr[r + 1]]) > 0).all()
    bd = tt.block_diag(tmats)
    assert bd.shape == (16, 36)
    _same(bd, ts.block_diag(jmats), tol=None)
    np.testing.assert_array_equal(bd.to_dense().numpy(),
                                  ssp.block_diag([m.to_scipy() for m in tmats]).toarray())


def test_stack_shape_validation():
    _, a = _pair(0, (4, 6), 0.3)
    _, b = _pair(1, (4, 7), 0.3)
    _, c = _pair(2, (5, 6), 0.3)
    with pytest.raises(ValueError, match="column counts differ"):
        tt.vstack([a, b])
    with pytest.raises(ValueError, match="row counts differ"):
        tt.hstack([a, c])
    for fn in (tt.vstack, tt.hstack, tt.block_diag):
        with pytest.raises(ValueError, match="at least one"):
            fn([])


def test_block_diag_batched_heterogeneous_spmm(rng):
    """Batched SpMM with a different pattern per batch element as one
    product over the block-diagonal operand."""
    j1 = random_csr(26, (16, 24), 0.1)
    j2 = random_powerlaw_csr(27, (16, 24), avg_nnz_per_row=3.0)
    x1 = rng.random((24, 8), dtype=np.float32)
    x2 = rng.random((24, 8), dtype=np.float32)
    x = np.concatenate([x1, x2])
    got = tt.spmm(tt.block_diag([_port(j1), _port(j2)]), torch.from_numpy(x), method="gather")
    want = ts.spmm(ts.block_diag([j1, j2]), jnp.asarray(x), method="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = np.concatenate([_dense64(_port(j1)) @ x1, _dense64(_port(j2)) @ x2])
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_stack_grads_match_jax():
    mats = (random_csr(28, (4, 6), 0.3), random_csr(29, (3, 6), 0.4))
    _grads_match(lambda a, b: ts.vstack([a, b]), lambda a, b: tt.vstack([a, b]), mats)
    _grads_match(lambda a, b: ts.block_diag([a, b]), lambda a, b: tt.block_diag([a, b]), mats)
    hm = (random_csr(28, (4, 6), 0.3), random_csr(29, (4, 3), 0.4))
    _grads_match(lambda a, b: ts.hstack([a, b]), lambda a, b: tt.hstack([a, b]), hm)


def test_sp_norm_matches_jax():
    ja, ta = _pair(16, (16, 20), 0.25)
    d = np.abs(_dense64(ta))
    for ord_, ref in (("fro", np.sqrt((d ** 2).sum())), (1, d.sum(axis=0).max()),
                      ("inf", d.sum(axis=1).max())):
        got = float(tt.sp_norm(ta, ord_))
        np.testing.assert_allclose(got, float(ts.sp_norm(ja, ord_)), rtol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    with pytest.raises(ValueError, match="unsupported norm"):
        tt.sp_norm(ta, 2)


# ---------------------------------------------------------------------------
# row_softmax against JAX, with a temperature
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [1.0, 0.1, 10.0])
def test_row_softmax_matches_jax(temperature):
    ja, ta = _pair(7, (24, 32), 0.2)
    _same(tt.row_softmax(ta, temperature=temperature),
          ts.row_softmax(ja, temperature=temperature))


def test_row_softmax_grad_matches_jax():
    ja, _ = _pair(8, (12, 16), 0.3)
    _grads_match(ts.row_softmax, tt.row_softmax, (ja,))


# ---------------------------------------------------------------------------
# permute_csr
# ---------------------------------------------------------------------------


def test_permute_csr_matches_jax_and_dense(rng):
    ja, ta = _pair(20, (24, 30), 0.2)
    p, q = rng.permutation(24), rng.permutation(30)
    d = ta.to_dense().numpy()
    for rp, cp, ref in ((p, q, d[p][:, q]), (p, None, d[p]), (None, q, d[:, q])):
        out = tt.permute_csr(ta, rp, cp)
        _same(out, ts.permute_csr(ja, rp, cp), tol=None)
        np.testing.assert_array_equal(out.to_dense().numpy(), ref)
    flat = out.row_ids().astype(np.int64) * 30 + out.indices
    assert (np.diff(flat) > 0).all()  # sorted indices kept


def test_permute_csr_differentiable_as_jax(rng):
    ja = random_csr(21, (12, 12), 0.3)
    p = rng.permutation(12)
    _grads_match(lambda a: ts.permute_csr(a, p, p), lambda a: tt.permute_csr(a, p, p), (ja,))


def test_permute_csr_rejects_non_permutation():
    _, ta = _pair(22, (8, 8), 0.3)
    with pytest.raises(ValueError, match="row_perm"):
        tt.permute_csr(ta, np.zeros(8, np.int64))
    with pytest.raises(ValueError, match="col_perm"):
        tt.permute_csr(ta, None, np.array([0] * 8))


# ---------------------------------------------------------------------------
# constructors: kron / tril / triu
# ---------------------------------------------------------------------------


def _sc(m):
    m = m.tocsr().astype(np.float32)
    m.sort_indices()
    return ts.CSR.from_scipy(m), tt.CSR.from_scipy(m, device="cpu")


def test_sp_kron_matches_jax_and_scipy():
    a = ssp.random(13, 17, density=0.2, format="csr", random_state=1)
    b = ssp.random(7, 5, density=0.3, format="csr", random_state=2)
    (ja, ta), (jb, tb) = _sc(a), _sc(b)
    k = tt.sp_kron(ta, tb)
    _same(k, ts.sp_kron(ja, jb), tol=None)
    ref = ssp.kron(a, b, format="csr")
    ref.sort_indices()
    np.testing.assert_allclose(k.to_dense().numpy(), ref.toarray(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(k.indices, ref.indices)
    np.testing.assert_array_equal(k.indptr, ref.indptr)


def test_sp_kron_grads_both_operands():
    (ja, _), (jb, _) = (_sc(ssp.random(6, 6, density=0.4, format="csr", random_state=3)),
                        _sc(ssp.random(4, 4, density=0.5, format="csr", random_state=4)))
    _grads_match(ts.sp_kron, tt.sp_kron, (ja, jb))


@pytest.mark.parametrize("k", [-3, -1, 0, 1, 4])
def test_sp_tril_triu_match_jax_and_scipy(k):
    a = ssp.random(11, 9, density=0.35, format="csr", random_state=5)
    ja, ta = _sc(a)
    lo, up = tt.sp_tril(ta, k), tt.sp_triu(ta, k)
    _same(lo, ts.sp_tril(ja, k), tol=None)
    _same(up, ts.sp_triu(ja, k), tol=None)
    np.testing.assert_allclose(lo.to_dense().numpy(), ssp.tril(a, k).toarray(), rtol=1e-6)
    np.testing.assert_allclose(up.to_dense().numpy(), ssp.triu(a, k).toarray(), rtol=1e-6)


def test_tril_triu_partition():
    _, ta = _sc(ssp.random(16, 16, density=0.3, format="csr", random_state=6))
    back = tt.sp_add(tt.sp_tril(ta, -1), tt.sp_triu(ta, 0))
    np.testing.assert_allclose(back.to_dense().numpy(), ta.to_dense().numpy(), rtol=1e-6)


def test_elementwise_values_stay_on_their_device():
    """The host pattern passes never move the values: every result's data
    lies where the operands' did (here the CPU)."""
    _, ta = _pair(30, (10, 10), 0.3)
    outs = (te.sp_hadamard(ta, ta), te.sp_scale(ta, 3.0), te.prune_csr(ta, density=0.5),
            te.vstack([ta, ta]), te.hstack([ta, ta]), te.block_diag([ta, ta]),
            te.permute_csr(ta, np.arange(10)[::-1]), te.sp_kron(ta, ta), te.sp_tril(ta))
    assert all(o.data.device == ta.data.device for o in outs)
