"""Parity of the port's int8 serving tier (tpusparse_torch.quant, the int8
executor of kernels/tiled_spmm.py and the int8 GEMM of kernels/gemm.py)
with the JAX package's: the same numpy inputs go through both; the JAX side
runs its Pallas kernels in interpret mode, the port its plain PyTorch
versions (the wrappers take them for CPU tensors).

Tolerances:
  - the quantizers, the int8 weights and scales, and the int8 GEMM: exact;
  - the int8 executor and everything built on it: within 1e-6 of scale.
    Both sides sum the same exact int32 slot products into fp32 in slot
    order; a compiler that contracts the multiply and add into an FMA on
    one side rounds once where the other rounds twice, one fp32 ulp;
  - against float64 (the serving tier's information limit): the JAX
    suite's own 2e-2 relative (tests/test_quant.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpusparse as ts
from tpusparse import quant as jq
from tpusparse.kernels.gemm import gemm_int8_pallas
from tpusparse.kernels.tiled_spmm import resident_spmm_int8_pallas, tiled_spmm_int8_pallas
from tpusparse.plan import build_plan as jax_build_plan

import tpusparse_torch as tt
from tpusparse_torch import quant as tq
from tpusparse_torch.kernels import gemm as gk
from tpusparse_torch.kernels import tiled_spmm as tk

SCALE_TOL = 1e-6


def _block_csr(rng, m, k, bm, bk, fill):
    """Random block-sparse scipy CSR with >= 1 block per row-block (the JAX
    suite's fixture, tests/test_quant.py:26)."""
    mask = rng.random((m // bm, k // bk)) < fill
    for i in range(m // bm):
        if not mask[i].any():
            mask[i, rng.integers(0, k // bk)] = True
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal((len(rows), bm, bk)).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m // bm))])
    return sp.bsr_matrix((vals, cols, indptr), shape=(m, k)).tocsr()


def _ragged_csr(rng, m, k, density, empty_rows=(0, 0)):
    a = (rng.random((m, k)) < density) * rng.standard_normal((m, k))
    a[slice(*empty_rows)] = 0.0
    return sp.csr_matrix(a.astype(np.float32))


def _over_scale(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _equal(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


def _with_ties(rng, shape):
    """Values whose quantization hits exact .5 ties: the max of each slice
    is 127 so the scale is 1, and half-integers must round to even."""
    x = rng.integers(-250, 251, shape).astype(np.float32) / 2
    x.reshape(-1, x.shape[-1])[:, 0] = 127.0
    return x


# -- quantizers ------------------------------------------------------------------


def test_quantize_block_values_equals_jax(rng):
    vals = rng.standard_normal((12, 8, 16)).astype(np.float32)
    vals[3] = 0.0  # a pad block: scale 0, values 0
    vals[5] = _with_ties(rng, (8, 16))
    q, s = tq.quantize_block_values(torch.from_numpy(vals))
    jqv, js = jq.quantize_block_values(jnp.asarray(vals))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _equal(q, jqv) and _equal(s, js)
    assert float(s[3]) == 0.0 and not q[3].any()


def test_quantize_columns_and_rows_equal_jax(rng):
    b = rng.standard_normal((64, 24)).astype(np.float32)
    b[:, 3] = 0.0  # an all-zero column: t 0, values 0
    b[:, 7] = _with_ties(rng, (64, 1))[:, 0]
    q, t = tq.quantize_columns(torch.from_numpy(b))
    jqb, jt = jq.quantize_columns(jnp.asarray(b))
    assert _equal(q, jqb) and _equal(t, jt)
    a = rng.standard_normal((40, 50)).astype(np.float32)
    a[2] = 0.0  # an all-zero row: scale 1
    a[9] = _with_ties(rng, (1, 50))[0]
    qa, sa = tq.quantize_rows(torch.from_numpy(a))
    jqa, jsa = jq.quantize_rows(jnp.asarray(a))
    assert _equal(qa, jqa) and _equal(sa, jsa) and float(sa[2]) == 1.0


# -- the int8 executor and GEMM: plain versions against the Pallas kernels ---------


@pytest.mark.parametrize("blocksize", [(8, 16), (8, 8)])
def test_int8_executor_plain_matches_pallas(blocksize):
    rng = np.random.default_rng(sum(blocksize))
    a_sp = _ragged_csr(rng, 100, 70, 0.15, empty_rows=(16, 40))  # empty row-blocks
    ja = ts.CSR.from_scipy(a_sp)
    jplan = jax_build_plan(ja, blocksize)
    jqv, js = jq.quantize_block_values(jplan.pack_values(ja.data))
    b = rng.standard_normal((70, 33)).astype(np.float32)
    jbq, jt = jq.quantize_columns(jnp.asarray(b))
    want_r = np.asarray(resident_spmm_int8_pallas(jplan, jqv, js, jbq, jt))
    want_t = np.asarray(tiled_spmm_int8_pallas(jplan, jqv, js, jbq, jt))

    plan = tt.build_plan(tt.CSR.from_scipy(a_sp, device="cpu"), blocksize)
    args = (plan, *(torch.from_numpy(np.array(x)) for x in (jqv, js, jbq, jt)))
    got_r = tk.resident_spmm_int8_kernel(*args)
    got_t = tk.tiled_spmm_int8_kernel(*args)
    assert got_r.dtype == torch.float32 and got_r.shape == (100, 33)
    assert torch.equal(got_r, got_t)
    assert _over_scale(got_r, want_r) <= SCALE_TOL
    assert _over_scale(got_t, want_t) <= SCALE_TOL
    assert not got_r[16:40].any()


@pytest.mark.parametrize("shape,ldt", [((70, 33), 80), ((1, 5), 16), ((256, 130), 256)])
def test_int8_kmajor_is_jax_quantized_b_transposed(shape, ldt):
    """The int8 executor's K-major B (`int8_kmajor_kernel`, its plain version
    on the CPU): JAX's quantized B transposed, zero past k."""
    rng = np.random.default_rng(shape[0])
    b = rng.standard_normal(shape).astype(np.float32)
    jbq, _ = jq.quantize_columns(jnp.asarray(b))
    b_q, _ = tq.quantize_columns(torch.from_numpy(b))
    tk.reset_launch_counts()
    bt = tk.int8_kmajor_kernel(b_q, ldt)
    want = np.zeros((shape[1], ldt), np.int8)
    want[:, :shape[0]] = np.asarray(jbq).T
    assert bt.dtype == torch.int8 and tuple(bt.shape) == (shape[1], ldt)
    np.testing.assert_array_equal(bt.numpy(), want)
    assert tk.launch_counts()["int8_kmajor"] == 0  # the CPU runs the plain version


def test_int8_kmajor_refuses_what_the_kernel_does_not_take():
    b_q = torch.zeros((70, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.int8_kmajor_kernel(b_q, 72)
    with pytest.raises(ValueError, match="at least k"):
        tk.int8_kmajor_kernel(b_q, 64)
    with pytest.raises(TypeError, match="int8"):
        tk.int8_kmajor_kernel(b_q.float(), 80)
    with pytest.raises(TypeError, match="int8"):
        tk.int8_kmajor_kernel(b_q.t(), 16)


# (m, k, n): k % 16 != 0 (70, 200 % 16 = 8), k % 128 != 0 with k % 16 == 0
# (144), n under 8, m 1
@pytest.mark.parametrize("shape", [(96, 200, 160), (37, 70, 33), (40, 144, 24), (33, 64, 5),
                                   (1, 300, 40)])
def test_int8_gemm_plain_equals_pallas(shape):
    """The wrapper's CPU path, the card's composition on plain parts (B made
    K-major, A padded where its rows are off 16 bytes, the K-major
    product), equals JAX's int8 GEMM exactly and launches nothing."""
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    gk.reset_launch_counts()
    tk.reset_launch_counts()
    got = gk.gemm_int8_kernel(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert _equal(got, gemm_int8_pallas(jnp.asarray(a), jnp.asarray(b)))
    assert gk.launch_counts()["gemm_s8"] == 0 and tk.launch_counts()["int8_kmajor"] == 0


@pytest.mark.parametrize("shape,ldt", [((50, 70, 30), 80), ((50, 70, 30), 128),
                                       ((8, 64, 3), 64), ((8, 64, 3), 96), ((1, 5, 9), 16),
                                       ((3, 130, 2), 256)])
def test_int8_gemm_kmajor_plain_product_equals_plain(shape, ldt):
    """The K-major plain product on `_int8_kmajor_plain`'s B (zero past k up
    to ldt) and A as the kernel's TMA reads it (itself, or padded to ldt)
    equals `_gemm_int8_plain`."""
    m, k, n = shape
    rng = np.random.default_rng(k + ldt)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    bt = tk._int8_kmajor_plain(b, ldt)
    want = gk._gemm_int8_plain(a, b)
    for a_k in (a, gk._rows_for_tma(a, ldt)):
        assert torch.equal(gk._gemm_s8_kmajor_plain(a_k, bt, k), want)
    a_k = gk._rows_for_tma(a, ldt)
    assert a_k.shape[1] in (k, ldt) and a_k.data_ptr() % 16 == 0
    assert not a_k[:, k:].any()


def test_int8_gemm_binding_matches_the_c_entry_points(monkeypatch):
    """The ctypes argument lists of `gemm_s8` and `gemm_s8_tile_n` have one
    type per parameter of the C entry points in csrc/gemm_s8.cu (ctypes
    refuses a call whose count differs, and only on the card)."""
    import re
    from pathlib import Path

    from tpusparse_torch.kernels import _build

    captured = {}
    monkeypatch.setattr(_build, "bind", lambda name, argtypes: captured.update(argtypes))
    gk._int8_fns.__wrapped__()
    src = (Path(gk.__file__).resolve().parents[1] / "csrc" / "gemm_s8.cu").read_text()
    for name, count in (("gemm_s8", 10), ("gemm_s8_tile_n", 3)):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
        assert len(captured[name]) == len(params) == count


# -- QuantizedMatrix, QuantizedDense, quantized_matmul -----------------------------


def _containers(a_sp, fmt, blocksize):
    """(JAX container, port container) of one scipy CSR in format `fmt`."""
    if fmt == "csr":
        return ts.CSR.from_scipy(a_sp), tt.CSR.from_scipy(a_sp, device="cpu")
    coo = a_sp.tocoo()
    perm = np.random.default_rng(0).permutation(coo.nnz)  # unsorted COO
    row, col, data = coo.row[perm], coo.col[perm], coo.data[perm]
    if fmt == "coo":
        return (ts.COO(data=jnp.asarray(data), row=jnp.asarray(row, jnp.int32),
                       col=jnp.asarray(col, jnp.int32), shape=a_sp.shape),
                tt.COO(data=torch.from_numpy(data), row=row.astype(np.int32),
                       col=col.astype(np.int32), shape=a_sp.shape))
    return (ts.csr_to_bsr(ts.CSR.from_scipy(a_sp), blocksize),
            tt.csr_to_bsr(tt.CSR.from_scipy(a_sp, device="cpu"), blocksize))


@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr"])
def test_quantized_matrix_matches_jax(fmt):
    rng = np.random.default_rng(3)
    a_sp = _block_csr(rng, 128, 256, 8, 16, 0.25)
    ja, ta = _containers(a_sp, fmt, (8, 16))
    jqa = ts.QuantizedMatrix(ja, blocksize=(8, 16))
    qa = tt.QuantizedMatrix(ta, blocksize=(8, 16))
    assert _equal(qa.qvals, jqa.qvals) and _equal(qa.scales, jqa.scales)
    b = rng.standard_normal((256, 48)).astype(np.float32)
    got = qa @ torch.from_numpy(b)
    assert _over_scale(got, jqa @ jnp.asarray(b)) <= SCALE_TOL
    ref = a_sp.toarray().astype(np.float64) @ b.astype(np.float64)
    assert _over_scale(got, ref) < 2e-2
    x = b[:, 0]
    y = qa @ torch.from_numpy(x)  # the 1-D lift
    assert y.shape == (128,)
    assert _over_scale(y, jqa @ jnp.asarray(x)) <= SCALE_TOL


def test_quantized_matrix_dispatches_by_pattern(monkeypatch):
    """The resident entry point when the pattern re-uses the B panel
    (nblocks >= num_col_blocks), the ring otherwise, as the float
    `_block_exec` does; the ring's output matches the JAX ring's."""
    calls = []
    for name in ("resident_spmm_int8_kernel", "tiled_spmm_int8_kernel"):
        fn = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    rng = np.random.default_rng(4)
    dense_rows = _block_csr(rng, 64, 128, 8, 16, 0.5)  # 8 col-blocks, ~32 blocks
    narrow = np.zeros((64, 512), np.float32)  # 32 col-blocks, 8 blocks
    narrow[:, :16] = rng.standard_normal((64, 16))
    b = rng.standard_normal((512, 24)).astype(np.float32)
    for a_sp, k, entry in ((dense_rows, 128, "resident_spmm_int8_kernel"),
                           (sp.csr_matrix(narrow), 512, "tiled_spmm_int8_kernel")):
        calls.clear()
        qa = tt.QuantizedMatrix(tt.CSR.from_scipy(a_sp, device="cpu"), blocksize=(8, 16))
        got = qa @ torch.from_numpy(b[:k])
        assert calls == [entry]
        jqa = ts.QuantizedMatrix(ts.CSR.from_scipy(a_sp), blocksize=(8, 16))
        jplan = jqa.plan
        jbq, jt = jq.quantize_columns(jnp.asarray(b[:k]))
        want = tiled_spmm_int8_pallas(jplan, jqa.qvals, jqa.scales, jbq, jt)
        assert _over_scale(got, want) <= SCALE_TOL


def test_dequantize_and_quantization_error_match_jax():
    rng = np.random.default_rng(5)
    a_sp = _block_csr(rng, 64, 64, 8, 8, 0.4)
    jqa = ts.QuantizedMatrix(ts.CSR.from_scipy(a_sp), blocksize=(8, 8))
    qa = tt.QuantizedMatrix(tt.CSR.from_scipy(a_sp, device="cpu"), blocksize=(8, 8))
    dq, jdq = qa.dequantize(), jqa.dequantize()
    assert np.array_equal(dq.indices, np.asarray(jdq.indices))
    assert np.array_equal(dq.indptr, np.asarray(jdq.indptr))
    assert _equal(dq.data, jdq.data)
    err = qa.quantization_error(tt.CSR.from_scipy(a_sp, device="cpu"))
    assert err == jqa.quantization_error(ts.CSR.from_scipy(a_sp)) and err < 1.0 / 127.0


def test_quantized_dense_and_matmul_match_jax():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((96, 200)).astype(np.float32)
    w[4] = 0.0
    x = rng.standard_normal((200, 40)).astype(np.float32)
    qd, jqd = tt.QuantizedDense(torch.from_numpy(w)), ts.QuantizedDense(jnp.asarray(w))
    assert _equal(qd.qw, jqd.qw) and _equal(qd.sw, jqd.sw)
    assert _equal(qd.dequantize(), jqd.dequantize())
    assert _over_scale(qd @ torch.from_numpy(x), jqd @ jnp.asarray(x)) <= SCALE_TOL
    y = qd @ torch.from_numpy(x[:, 3])
    assert y.shape == (96,) and _over_scale(y, jqd @ jnp.asarray(x[:, 3])) <= SCALE_TOL
    got = tt.quantized_matmul(torch.from_numpy(w), torch.from_numpy(x))
    assert _over_scale(got, ts.quantized_matmul(jnp.asarray(w), jnp.asarray(x))) <= SCALE_TOL
    assert _over_scale(got, w.astype(np.float64) @ x) < 2e-2


def test_bsr_conversions_equal_jax():
    rng = np.random.default_rng(7)
    a_sp = _ragged_csr(rng, 50, 37, 0.2)
    jb = ts.csr_to_bsr(ts.CSR.from_scipy(a_sp), (8, 16))
    b = tt.csr_to_bsr(tt.CSR.from_scipy(a_sp, device="cpu"), (8, 16))
    assert _equal(b.data, jb.data) and b.blocksize == jb.blocksize
    assert np.array_equal(b.indices, np.asarray(jb.indices))
    assert np.array_equal(b.indptr, np.asarray(jb.indptr))
    assert _equal(b.to_dense(), jb.to_dense())
    c, jc = tt.bsr_to_csr(b), ts.bsr_to_csr(jb)
    assert _equal(c.data, jc.data) and np.array_equal(c.indices, np.asarray(jc.indices))
    assert np.array_equal(c.indptr, np.asarray(jc.indptr))
    d = tt.BSR.from_dense(a_sp.toarray(), (8, 16), device="cpu")
    assert _equal(d.data, ts.BSR.from_dense(a_sp.toarray(), (8, 16)).data)


def test_guards_raise_as_jax_does():
    rng = np.random.default_rng(8)
    a_sp = _block_csr(rng, 64, 64, 8, 8, 0.4)
    qa = tt.QuantizedMatrix(tt.CSR.from_scipy(a_sp, device="cpu"), blocksize=(8, 8))
    with pytest.raises(ValueError, match="incompatible"):
        qa @ torch.ones((32, 4))
    b_q, t = tq.quantize_columns(torch.ones((64, 16)))
    with pytest.raises(TypeError, match="int8"):
        tk.resident_spmm_int8_kernel(qa.plan, qa.qvals.float(), qa.scales, b_q, t)
    with pytest.raises(TypeError, match="int8"):
        tk.tiled_spmm_int8_kernel(qa.plan, qa.qvals, qa.scales, b_q.float(), t)
    with pytest.raises(ValueError, match="incompatible"):
        tk.tiled_spmm_int8_kernel(qa.plan, qa.qvals, qa.scales, b_q[:32], t)
    with pytest.raises(TypeError, match="CSR/BSR/COO"):
        tt.QuantizedMatrix(torch.ones((4, 4)))
    with pytest.raises(TypeError, match="int8"):
        gk.gemm_int8_kernel(torch.ones((4, 4)), torch.ones((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="bad shapes"):
        gk.gemm_int8_kernel(torch.ones((4, 5), dtype=torch.int8),
                            torch.ones((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_rows(torch.ones(4))
    with pytest.raises(ValueError, match="2-D"):
        tt.QuantizedDense(torch.ones(4))
    with pytest.raises(ValueError, match="incompatible"):
        tt.QuantizedDense(torch.ones((4, 6))) @ torch.ones((5, 2))
    tk.reset_launch_counts()
    gk.reset_launch_counts()
    qa @ torch.ones((64, 4))
    tt.quantized_matmul(torch.ones((4, 6)), torch.ones((6, 2)))
    assert not any(tk.launch_counts().values()) and not any(gk.launch_counts().values())
