"""Parity of the port's torch and scipy converters with the JAX package
(tests/test_interop.py's torch and scipy cases): the same matrix through
both packages gives the same containers, and every round trip gives the
matrix back. The JAX converters of `jax.experimental.sparse` types are not
carried (the port imports nothing of JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from tpusparse import interop as ji
from tpusparse.types import DIA as JDIA

import tpusparse_torch as tt
from tpusparse_torch import interop as ti
from tpusparse_torch.types import BSR, COO, CSR

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite


@pytest.fixture
def mat(rng):
    d = rng.random((24, 36), dtype=np.float32)
    d[d < 0.8] = 0.0
    return d


def _dense(a):
    return a.to_dense().double().numpy()


def _same(t, j):
    """The port's container equals JAX's: type, shape, index arrays, values."""
    assert type(t).__name__ == type(j).__name__ and tuple(t.shape) == tuple(j.shape)
    fields = {"CSR": ("indices", "indptr"), "COO": ("row", "col"),
              "BSR": ("indices", "indptr")}[type(t).__name__]
    for f in fields:
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    if isinstance(t, BSR):
        assert t.blocksize == tuple(j.blocksize)


# --- torch ------------------------------------------------------------------


def test_torch_dense_roundtrip(mat):
    t = torch.from_numpy(mat)
    a = ti.from_torch(t, device="cpu")
    assert isinstance(a, CSR)
    _same(a, ji.from_torch(t))
    np.testing.assert_array_equal(_dense(a), mat.astype(np.float64))


def test_torch_csr_roundtrip(mat):
    t = torch.from_numpy(mat).to_sparse_csr()
    a = ti.from_torch(t, device="cpu")
    assert isinstance(a, CSR)
    _same(a, ji.from_torch(t))
    back = ti.to_torch(a)
    assert back.layout == torch.sparse_csr
    np.testing.assert_array_equal(back.to_dense().numpy(), mat)


def test_torch_coo_roundtrip(mat):
    t = torch.from_numpy(mat).to_sparse_coo()
    a = ti.from_torch(t, device="cpu")
    assert isinstance(a, COO)
    _same(a, ji.from_torch(t))
    back = ti.to_torch(a)
    assert back.layout == torch.sparse_coo
    np.testing.assert_array_equal(back.to_dense().numpy(), mat)


def test_torch_bsr_roundtrip(mat):
    t = torch.from_numpy(mat).to_sparse_bsr((4, 6))
    a = ti.from_torch(t, device="cpu")
    assert isinstance(a, BSR) and a.blocksize == (4, 6)
    _same(a, ji.from_torch(t))
    np.testing.assert_array_equal(_dense(a), mat.astype(np.float64))
    back = ti.to_torch(a)
    assert back.layout == torch.sparse_bsr
    np.testing.assert_array_equal(back.to_dense().numpy(), mat)


def test_torch_rejects_bad_inputs(mat):
    with pytest.raises(TypeError):
        ti.from_torch(mat, device="cpu")  # numpy, not torch
    with pytest.raises(ValueError):
        ti.from_torch(torch.zeros(2, 3, 4), device="cpu")
    # unpadded logical shape: torch BSR refused with guidance
    b = BSR.from_dense(mat[:22, :34], (4, 6), device="cpu")
    with pytest.raises(ValueError, match="block multiple"):
        ti.to_torch(b)
    with pytest.raises(ValueError, match="block multiple"):
        ti.to_scipy(b)
    with pytest.raises(TypeError, match="CSR/COO/BSR"):
        ti.to_torch(mat)


def test_torch_user_flow_spmm(mat, rng):
    """The migration story: torch CSR in, spmm out, as in JAX."""
    t = torch.from_numpy(mat).to_sparse_csr()
    x = rng.random((36, 8), dtype=np.float32)
    y = tt.spmm(ti.from_torch(t, device="cpu"), torch.from_numpy(x))
    from tpusparse import spmm as jspmm

    np.testing.assert_allclose(y.numpy(), np.asarray(jspmm(ji.from_torch(t), jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(y.numpy(), mat.astype(np.float64) @ x.astype(np.float64),
                               rtol=1e-4, atol=1e-5)


def test_to_torch_keeps_autograd(mat):
    """The values of a converted CSR keep their graph: a torch sparse
    product of it backpropagates into the CSR's data."""
    a = ti.from_torch(torch.from_numpy(mat).to_sparse_csr(), device="cpu")
    data = a.data.clone().requires_grad_(True)
    t = ti.to_torch(CSR(data, a.indices, a.indptr, a.shape))
    torch.sparse.mm(t, torch.ones(36, 2)).sum().backward()
    np.testing.assert_array_equal(data.grad.numpy(), np.full(a.nnz, 2.0, np.float32))


# --- scipy ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "bsr"])
def test_scipy_roundtrip(mat, fmt):
    sp = (ssp.bsr_matrix(mat, blocksize=(4, 6)) if fmt == "bsr"
          else ssp.csr_matrix(mat).asformat(fmt))
    a = ti.from_scipy(sp, device="cpu")
    _same(a, ji.from_scipy(sp))
    np.testing.assert_array_equal(_dense(a), mat.astype(np.float64))
    back = ti.to_scipy(a)
    assert back.format == {"csc": "csr"}.get(fmt, fmt)
    np.testing.assert_array_equal(back.toarray(), mat)


def test_from_scipy_bsr_sorts_a_copy(rng):
    """Blocks in unsorted column order come out sorted, as in JAX, and the
    caller's matrix is left as it was."""
    blocks = rng.random((3, 2, 2)).astype(np.float32)
    sp = ssp.bsr_matrix((blocks, np.array([1, 0, 0]), np.array([0, 2, 3])), shape=(4, 4))
    dense = sp.toarray()
    a = ti.from_scipy(sp, device="cpu")
    np.testing.assert_array_equal(sp.indices, [1, 0, 0])
    _same(a, ji.from_scipy(sp.copy()))
    np.testing.assert_array_equal(a.indices, [0, 1, 0])
    np.testing.assert_array_equal(_dense(a), dense.astype(np.float64))


def test_to_scipy_rejects_unknown():
    with pytest.raises(TypeError):
        ti.to_scipy(np.zeros((2, 2)))


def test_dia_raises_until_its_container_is_ported():
    """The DIA container is ported: a dia_matrix comes back as a DIA in both
    packages, with JAX's offsets and plane, and to_scipy takes it back."""
    from tpusparse_torch.types import DIA as TDIA

    sp = ssp.diags([1.0, 2.0, 3.0], [-1, 0, 1], shape=(6, 6), format="dia")
    want = ji.from_scipy(sp)
    got = ti.from_scipy(sp, device="cpu")
    assert isinstance(want, JDIA) and isinstance(got, TDIA)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(ti.to_scipy(got).toarray(), sp.toarray())


def test_converters_put_values_on_the_device_asked(mat):
    sp = ssp.csr_matrix(mat)
    t = torch.from_numpy(mat)
    for a in (ti.from_scipy(sp, device="cpu"), ti.from_torch(t, device="cpu"),
              ti.from_scipy(sp.tocoo(), device="cpu"),
              ti.from_torch(t.to_sparse_bsr((4, 6)), device="cpu")):
        assert a.data.device == torch.device("cpu")
        assert a.data.dtype == torch.float32
