"""Parity of the port's sparse containers (tpusparse_torch.types) with the
JAX package's (tpusparse.types)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import tpusparse.types as jtypes

import tpusparse_torch.types as ttypes
from tpusparse_torch.plan import build_plan
from tpusparse_torch.utils.matrices import block_sparse_csr

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite


def _dense(seed, m=37, k=23, density=0.2):
    rng = np.random.default_rng(seed)
    return ((rng.random((m, k)) < density) * rng.standard_normal((m, k))).astype(np.float32)


def _assert_csr_equal(t, j):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
    np.testing.assert_array_equal(t.indptr, np.asarray(j.indptr))
    assert t.shape == tuple(j.shape)


def test_csr_from_dense_matches_jax_and_round_trips():
    d = _dense(0)
    t = ttypes.CSR.from_dense(d, device="cpu")
    _assert_csr_equal(t, jtypes.CSR.from_dense(d))
    np.testing.assert_array_equal(t.to_dense().numpy(), d)


def test_csr_from_scipy_matches_jax():
    sp = ssp.random(40, 30, density=0.15, random_state=3, format="csr", dtype=np.float32)
    t = ttypes.CSR.from_scipy(sp, device="cpu")
    _assert_csr_equal(t, jtypes.CSR.from_scipy(sp))
    np.testing.assert_array_equal(t.to_scipy().toarray(), sp.toarray())


def test_coo_to_csr_on_unsorted_coo_matches_jax():
    rng = np.random.default_rng(1)
    d = _dense(1)
    rows, cols = np.nonzero(d)
    perm = rng.permutation(rows.size)
    rows, cols = rows[perm].astype(np.int32), cols[perm].astype(np.int32)
    vals = d[rows, cols]
    t = ttypes.coo_to_csr(ttypes.COO(torch.from_numpy(vals), rows, cols, d.shape))
    j = jtypes.coo_to_csr(jtypes.COO(jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(cols), d.shape))
    _assert_csr_equal(t, j)
    coo = ttypes.csr_to_coo(t)
    np.testing.assert_array_equal(coo.to_dense().numpy(), d)


@pytest.mark.parametrize("n", [1, 16, 130])
def test_spmm_reference_matches_jax(n):
    d = _dense(2, 64, 48, 0.1)
    b = np.random.default_rng(5).standard_normal((48, n)).astype(np.float32)
    t = ttypes.spmm_reference(ttypes.CSR.from_dense(d, device="cpu"), torch.from_numpy(b))
    j = jtypes.spmm_reference(jtypes.CSR.from_dense(d), jnp.asarray(b))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_spmm_reference_reducers_not_ported():
    """The reducers are ported: every one, and the arg of max and min, give
    JAX's values (the arg matrix exactly), and a bad mode raises."""
    d = _dense(3)
    b = np.random.default_rng(6).standard_normal((d.shape[1], 4)).astype(np.float32)
    t, j = ttypes.CSR.from_dense(d, device="cpu"), jtypes.CSR.from_dense(d)
    for reduce in ("mean", "max", "min", "mul", "div"):
        got = ttypes.spmm_reference(t, torch.from_numpy(b), reduce=reduce)
        want = jtypes.spmm_reference(j, jnp.asarray(b), reduce=reduce)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for reduce in ("max", "min"):
        got = ttypes.spmm_reference(t, torch.from_numpy(b), reduce=reduce, return_arg=True)
        want = jtypes.spmm_reference(j, jnp.asarray(b), reduce=reduce, return_arg=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    with pytest.raises(ValueError, match="min/max"):
        ttypes.spmm_reference(t, torch.from_numpy(b), return_arg=True)


def test_random_csr_is_seeded_and_exact():
    a = ttypes.random_csr(4, (50, 40), 0.1, device="cpu")
    b = ttypes.random_csr(4, (50, 40), 0.1, device="cpu")
    assert a.nnz == 200 and a.shape == (50, 40) and a.indptr[-1] == 200
    assert torch.equal(a.data, b.data) and np.array_equal(a.indices, b.indices)


def test_block_sparse_csr_fills_whole_blocks():
    a = block_sparse_csr(1, (64, 96), (16, 32), 0.4, device="cpu")
    plan = build_plan(a, (16, 32), use_cache=False)
    assert a.nnz == plan.nblocks * 16 * 32 > 0
    assert plan.report()["block_fill"] == 1.0
    dense = a.to_dense().numpy()
    blocks = dense.reshape(4, 16, 3, 32).transpose(0, 2, 1, 3)
    occupied = (blocks != 0).any(axis=(2, 3))
    assert ((blocks != 0).all(axis=(2, 3)) == occupied).all()
