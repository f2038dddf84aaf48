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


def _bf16_matrix():
    """The 16x16 matrix of the bf16 conversion fault: a normal draw masked
    at 30 %, in bf16 (JAX's ml_dtypes bf16 and torch's)."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((16, 16)) * (rng.random((16, 16)) < 0.3)
    return torch.tensor(d, dtype=torch.bfloat16), jnp.asarray(d, jnp.bfloat16)


def _bf16_equal(t: torch.Tensor, j) -> None:
    assert t.dtype == torch.bfloat16 and np.asarray(j).dtype == jnp.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_bf16_host_conversions_match_jax():
    """bf16 values through every host conversion: the same bf16 values as
    the JAX package, exactly (the host pass widens to fp32 and casts back,
    which is exact)."""
    from tpusparse import interop as jinterop

    from tpusparse_torch import interop as tinterop

    td, jd = _bf16_matrix()
    for cls in ("COO", "CSR", "DIA"):
        t = getattr(ttypes, cls).from_dense(td, device="cpu")
        j = getattr(jtypes, cls).from_dense(jd)
        _bf16_equal(t.data, j.data)
        _bf16_equal(t.to_dense(), j.to_dense())
    tc, jc = ttypes.CSR.from_dense(td, device="cpu"), jtypes.CSR.from_dense(jd)
    for ts_, js_ in ((tc.to_scipy(), jc.to_scipy()),
                     (ttypes.DIA.from_dense(td, device="cpu").to_scipy(),
                      jtypes.DIA.from_dense(jd).to_scipy()),
                     (tinterop.to_scipy(tc), jinterop.to_scipy(jc))):
        assert type(ts_) is type(js_) and ts_.dtype == js_.dtype == jnp.bfloat16
        # scipy cannot densify bf16: hold the stored arrays
        for field in ("data", "indices", "indptr", "offsets"):
            if hasattr(js_, field):
                np.testing.assert_array_equal(np.asarray(getattr(ts_, field), np.float32),
                                              np.asarray(getattr(js_, field), np.float32))
    tb, jb = ttypes.csr_to_bsr(tc, (4, 4)), jtypes.csr_to_bsr(jc, (4, 4))
    _bf16_equal(tb.data, jb.data)
    np.testing.assert_array_equal(tb.indices, np.asarray(jb.indices))
    back, jback = ttypes.bsr_to_csr(tb), jtypes.bsr_to_csr(jb)
    _bf16_equal(back.data, jback.data)
    np.testing.assert_array_equal(back.indices, np.asarray(jback.indices))
    # scipy refuses bf16 COO and BSR matrices in both packages
    for a, ja in ((ttypes.csr_to_coo(tc), jtypes.csr_to_coo(jc)), (tb, jb)):
        with pytest.raises(ValueError, match="bfloat16"):
            jinterop.to_scipy(ja)
        with pytest.raises(ValueError, match="bfloat16"):
            tinterop.to_scipy(a)


def test_spmm_on_a_bf16_bsr_matches_jax():
    import tpusparse.ops as jops

    import tpusparse_torch.ops as tops

    td, jd = _bf16_matrix()
    rng = np.random.default_rng(1)
    b = rng.standard_normal((16, 3)).astype(np.float32)
    tb = ttypes.csr_to_bsr(ttypes.CSR.from_dense(td, device="cpu"), (4, 4))
    jb = jtypes.csr_to_bsr(jtypes.CSR.from_dense(jd), (4, 4))
    got = tops.spmm(tb, torch.tensor(b, dtype=torch.bfloat16))
    want = jops.spmm(jb, jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
