"""Parity of the port's SpGEMM (sparse × sparse -> sparse) and CSR operators
with the JAX package: tests/test_spgemm.py's cases through both packages on
the same inputs. The schedules (a_pos, b_pos, c_pos and C's pattern) must be
equal, with the same windowed plans adopted; C and both gradients agree
within the fp32 tier, and with a host float64 oracle. At these shapes JAX
adopts windowed plans, so its Pallas kernels run here in interpret mode and
the port's wrappers run the kernels' plain versions on CPU tensors."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse import random_csr, random_powerlaw_csr
from tpusparse.types import CSR as JCSR
from tpusparse_torch.kernels import windowed as tw
from tpusparse_torch.types import CSR as TCSR

# the packages export a function named spgemm, which hides the module
js = importlib.import_module("tpusparse.spgemm")
ts = importlib.import_module("tpusparse_torch.spgemm")

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
WINDOWED = ("ws_c", "wg_a", "wg_b", "wg_c")


def _port(j: JCSR, requires_grad=False) -> TCSR:
    data = torch.from_numpy(np.array(j.data)).requires_grad_(requires_grad)
    return TCSR(data, np.asarray(j.indices, np.int32), np.asarray(j.indptr, np.int32),
                tuple(j.shape))


def _pair(seed, shape, density):
    j = random_csr(seed, shape, density)
    return j, _port(j)


def _same_windowed(tplan, jplan):
    """The same windowed plans adopted, with equal arrays."""
    for f in WINDOWED:
        tp, jp = getattr(tplan, f), getattr(jplan, f)
        assert (tp is None) == (jp is None), f
        if tp is not None:
            assert tp.window == jp.window, f
            for arr in ("starts", "exc_pos"):
                np.testing.assert_array_equal(getattr(tp, arr), getattr(jp, arr), err_msg=f)
    tc, jc = tplan.ws_c_chunks, jplan.ws_c_chunks
    assert (tc is None) == (jc is None)
    for t_, j_ in zip(tc or (), jc or ()):
        assert t_[:4] == j_[:4]
        np.testing.assert_array_equal(t_[4].seg_masked, j_[4].seg_masked)


def _same_plan(tplan, jplan):
    for f in ("a_pos", "b_pos", "c_pos", "c_indices", "c_indptr"):
        np.testing.assert_array_equal(getattr(tplan, f), np.asarray(getattr(jplan, f)),
                                      err_msg=f)
    assert tplan.a_shape == tuple(jplan.a_shape) and tplan.b_shape == tuple(jplan.b_shape)
    _same_windowed(tplan, jplan)


def _check(ja, jb, ta, tb):
    """C against JAX's C and the float64 oracle, the pattern against scipy's
    boolean product, the plans equal."""
    jc, tc = js.spgemm(ja, jb), ts.spgemm(ta, tb)
    _same_plan(ts.spgemm_plan(ta, tb), js.spgemm_plan(ja, jb))
    np.testing.assert_array_equal(tc.indptr, np.asarray(jc.indptr))
    np.testing.assert_array_equal(tc.indices, np.asarray(jc.indices))
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data), **TOL)
    ref = ts.spgemm_reference(ta, tb)
    scale = max(np.abs(ref).max(), 1.0)
    got = tc.to_dense().numpy().astype(np.float64)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=1e-5, atol=1e-5)
    pat = (ta.to_scipy().astype(bool) @ tb.to_scipy().astype(bool)).tocsr()
    np.testing.assert_array_equal(tc.indptr, pat.indptr)
    np.testing.assert_array_equal(np.sort(tc.indices), np.sort(pat.indices))
    return tc


@pytest.mark.parametrize(
    "a_shape,b_shape,da,db",
    [
        ((32, 48), (48, 24), 0.1, 0.1),
        ((64, 64), (64, 64), 0.05, 0.2),
        ((16, 128), (128, 8), 0.3, 0.02),
        ((50, 30), (30, 70), 0.15, 0.15),  # non-multiple-of-8 dims
    ],
)
def test_spgemm_matches_jax_and_dense_oracle(a_shape, b_shape, da, db):
    ja, ta = _pair(0, a_shape, da)
    jb, tb = _pair(1, b_shape, db)
    _check(ja, jb, ta, tb)


def test_spgemm_square_power_adopts_jax_windowed_plans():
    """A @ A, the graph-operator case: JAX adopts the accumulation and the
    gathers of a and dC here, so the port runs its kernels' plain versions."""
    ja, ta = _pair(2, (64, 64), 0.08)
    _check(ja, ja, ta, ta)
    plan = ts.spgemm_plan(ta, ta)
    assert plan.ws_c is not None and plan.wg_a is not None and plan.wg_c is not None


def test_spgemm_powerlaw_pattern():
    ja = random_powerlaw_csr(3, (96, 64), avg_nnz_per_row=4.0)
    jb = random_powerlaw_csr(4, (64, 48), avg_nnz_per_row=3.0)
    _check(ja, jb, _port(ja), _port(jb))


def test_spgemm_csr_order_and_dtypes():
    _, ta = _pair(5, (40, 32), 0.1)
    _, tb = _pair(6, (32, 40), 0.1)
    c = ts.spgemm(ta, tb)
    assert c.indptr[0] == 0 and c.indptr[-1] == c.nnz
    assert (np.diff(c.indptr) >= 0).all()
    for r in range(c.shape[0]):  # columns sorted within each row
        assert (np.diff(c.indices[c.indptr[r]:c.indptr[r + 1]]) > 0).all()
    assert c.indices.dtype == np.int32 and c.indptr.dtype == np.int32
    assert c.data.dtype == torch.float32


def test_spgemm_shape_mismatch():
    _, ta = _pair(0, (8, 16), 0.2)
    _, tb = _pair(1, (8, 16), 0.2)
    for method in ("schedule", "dense", "auto"):
        with pytest.raises(ValueError, match="shape mismatch"):
            ts.spgemm(ta, tb, method=method)


def test_spgemm_plan_mismatch():
    _, ta = _pair(0, (8, 16), 0.2)
    _, tb = _pair(1, (16, 8), 0.2)
    plan = ts.spgemm_plan(ta, tb)
    _, ta2 = _pair(2, (16, 16), 0.2)
    with pytest.raises(ValueError, match="plan built for"):
        ts.spgemm(ta2, tb, plan=plan)


def test_spgemm_plan_cache_hit():
    _, ta = _pair(7, (24, 24), 0.1)
    _, tb = _pair(8, (24, 24), 0.1)
    p1 = ts.spgemm_plan(ta, tb)
    # same patterns, other values and other index array objects: the same plan
    ta2 = TCSR(ta.data * 2.0, ta.indices.copy(), ta.indptr.copy(), ta.shape)
    assert ts.spgemm_plan(ta2, tb) is p1


def test_spgemm_empty_result():
    """Disjoint structure: A's columns never hit an occupied B row."""
    def csr(indices, indptr):
        return JCSR(jnp.ones(2), jnp.array(indices, jnp.int32), jnp.array(indptr, jnp.int32),
                    (4, 4))
    ja, jb = csr([0, 1], [0, 1, 2, 2, 2]), csr([0, 1], [0, 0, 0, 1, 2])
    jc, tc = js.spgemm(ja, jb), ts.spgemm(_port(ja), _port(jb))
    assert tc.nnz == jc.nnz == 0
    np.testing.assert_array_equal(tc.to_dense().numpy(), np.zeros((4, 4)))
    np.testing.assert_array_equal(tc.indptr, np.asarray(jc.indptr))


def test_spgemm_numerical_cancellation_keeps_slot():
    ja = JCSR(jnp.array([1.0, -1.0]), jnp.array([0, 1], jnp.int32), jnp.array([0, 2], jnp.int32),
              (1, 2))
    jb = JCSR(jnp.array([3.0, 3.0]), jnp.array([0, 0], jnp.int32),
              jnp.array([0, 1, 2], jnp.int32), (2, 1))
    c = ts.spgemm(_port(ja), _port(jb))
    assert c.nnz == js.spgemm(ja, jb).nnz == 1
    assert float(c.data[0]) == 0.0


def _grads(ja, jb, g, method="schedule"):
    """(dA, dB) of vdot(g, C.data) from both packages."""
    jplan = js.spgemm_plan(ja, jb) if method == "schedule" else None

    def f(ad, bd):
        c = js.spgemm(JCSR(ad, ja.indices, ja.indptr, ja.shape),
                      JCSR(bd, jb.indices, jb.indptr, jb.shape), plan=jplan, method=method)
        return jnp.vdot(jnp.asarray(g), c.data)

    jda, jdb = jax.grad(f, argnums=(0, 1))(ja.data, jb.data)
    ta, tb = _port(ja, True), _port(jb, True)
    c = ts.spgemm(ta, tb, method=method)
    (c.data * torch.from_numpy(g)).sum().backward()
    return (ta.data.grad.numpy(), tb.data.grad.numpy()), (np.asarray(jda), np.asarray(jdb))


def test_spgemm_grads_match_jax(rng):
    ja, _ = _pair(9, (24, 32), 0.15)
    jb, _ = _pair(10, (32, 20), 0.15)
    g = rng.normal(size=ts.spgemm_plan(_port(ja), _port(jb)).c_nnz).astype(np.float32)
    got, want = _grads(ja, jb, g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, **TOL)


def test_spgemm_grad_matches_dense_algebra(rng):
    """dA == (dC @ Bᵀ) restricted to A's pattern, dB == (Aᵀ @ dC) restricted
    to B's, in float64."""
    ja, ta = _pair(11, (16, 24), 0.2)
    jb, tb = _pair(12, (24, 12), 0.2)
    plan = ts.spgemm_plan(ta, tb)
    g = rng.random((plan.c_nnz,), dtype=np.float32)
    (da, db), _ = _grads(ja, jb, g)
    gc = TCSR(torch.from_numpy(g).double(), plan.c_indices, plan.c_indptr, plan.c_shape)
    gc_d = gc.to_dense().numpy()
    ad, bd = ta.to_dense().double().numpy(), tb.to_dense().double().numpy()
    np.testing.assert_allclose(da, (gc_d @ bd.T)[ta.row_ids(), ta.indices], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db, (ad.T @ gc_d)[tb.row_ids(), tb.indices], rtol=1e-4, atol=1e-5)


def test_spgemm_held_plan_takes_new_values():
    """tests/test_spgemm.py::test_spgemm_under_jit_with_plan: a plan built
    once serves other value vectors of the same patterns."""
    ja, ta = _pair(13, (32, 32), 0.1)
    jb, tb = _pair(14, (32, 32), 0.1)
    plan = ts.spgemm_plan(ta, tb)
    ta2 = TCSR(ta.data * -1.5, ta.indices, ta.indptr, ta.shape)
    got = ts.spgemm(ta2, tb, plan=plan).data.numpy()
    ref = ts.spgemm_reference(ta2, tb)
    rows = np.repeat(np.arange(32), np.diff(plan.c_indptr))
    np.testing.assert_allclose(got, ref[rows, plan.c_indices], rtol=1e-5, atol=1e-5)
    jplan = js.spgemm_plan(ja, jb)
    want = js.spgemm(JCSR(ja.data * -1.5, ja.indices, ja.indptr, ja.shape), jb, plan=jplan).data
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("method", ["schedule", "dense"])
def test_spgemm_methods_agree_with_jax(method):
    ja, ta = _pair(17, (48, 64), 0.1)
    jb, tb = _pair(18, (64, 40), 0.1)
    c = ts.spgemm(ta, tb, method=method)
    np.testing.assert_allclose(c.data.numpy(), np.asarray(js.spgemm(ja, jb, method=method).data),
                               **TOL)
    ref = ts.spgemm_reference(ta, tb)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(c.to_dense().numpy().astype(np.float64) / scale, ref / scale,
                               rtol=1e-4, atol=1e-5)
    c2 = ts.spgemm(ta, tb, method="schedule" if method == "dense" else "dense")
    np.testing.assert_array_equal(c.indptr, c2.indptr)
    np.testing.assert_array_equal(c.indices, c2.indices)


def test_spgemm_dense_method_grads_match_jax(rng):
    ja, _ = _pair(19, (24, 32), 0.15)
    jb, _ = _pair(20, (32, 20), 0.15)
    g = rng.normal(size=ts.spgemm_plan(_port(ja), _port(jb)).c_nnz).astype(np.float32)
    got, want = _grads(ja, jb, g, method="dense")
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, **TOL)


def test_spgemm_auto_routes_as_jax():
    for seed, density, route in ((21, 0.3, "dense"), (22, 0.002, "schedule"),
                                 (23, 0.05, None)):
        ja, ta = _pair(seed, (512, 512), density)
        got = ts._route_spgemm(ta, ta)
        assert got == js._route_spgemm(ja, ja)
        assert route is None or got == route


def test_spgemm_unknown_method():
    _, ta = _pair(0, (8, 8), 0.2)
    with pytest.raises(ValueError, match="unknown spgemm method"):
        ts.spgemm(ta, ta, method="warp")


def test_spgemm_report_equals_jax():
    ja, ta = _pair(15, (64, 64), 0.1)
    jb, tb = _pair(16, (64, 64), 0.1)
    rep = ts.spgemm_plan(ta, tb).report()
    assert rep == js.spgemm_plan(ja, jb).report()
    assert rep["nmul"] > 0 and rep["c_nnz"] > 0
    assert rep["dense_mult_ratio"] > 1.0 and rep["mults_per_c_nnz"] >= 1.0


def test_spgemm_plan_native_matches_numpy(monkeypatch):
    """The C++ symbolic pass and the numpy one give the same plan, and both
    equal JAX's."""
    from tpusparse_torch.runtime import native

    if not native.available():
        pytest.skip("no native toolchain")
    ja, ta = _pair(30, (128, 96), 0.08)
    jb, tb = _pair(31, (96, 80), 0.08)
    ts._PLAN_CACHE.clear()
    p_nat = ts.spgemm_plan(ta, tb)
    ts._PLAN_CACHE.clear()
    monkeypatch.setattr(native, "available", lambda: False)
    p_np = ts.spgemm_plan(ta, tb)
    ts._PLAN_CACHE.clear()
    _same_plan(p_nat, js.spgemm_plan(ja, jb))
    _same_plan(p_np, p_nat)


def test_chunked_windowed_accumulation_matches_jax():
    """The chunked accumulation (past JAX's residency budget in production),
    forced at test size with a small target in both packages."""
    ja, ta = _pair(31, (256, 256), 0.05)
    jb, tb = _pair(32, (256, 256), 0.05)
    jplan, tplan = js.spgemm_plan(ja, jb), ts.spgemm_plan(ta, tb)
    seg = tplan.c_pos
    target = max(seg.size // 3, 1)
    tch = ts._chunk_segment_plans(seg, tplan.c_nnz, lambda p, n: True, target=target)
    jch = js._chunk_segment_plans(np.asarray(jplan.c_pos), jplan.c_nnz, lambda p, n: True,
                                  target=target)
    assert tch is not None and len(tch) >= 2 and len(tch) == len(jch)
    assert tch[0][2] == 0 and sum(c[3] for c in tch) == tplan.c_nnz
    for t_, j_ in zip(tch, jch):
        assert t_[:4] == j_[:4]
        np.testing.assert_array_equal(t_[4].seg_masked, j_[4].seg_masked)
    tforced = dataclasses.replace(tplan, ws_c=None, ws_c_chunks=tuple(tch))
    jforced = dataclasses.replace(jplan, ws_c=None, ws_c_chunks=tuple(jch))
    tw.reset_launch_counts()
    got = ts._spgemm_data(tforced, ta.data, tb.data).numpy()
    want = np.asarray(js._spgemm_data(jforced, ja.data, jb.data))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    whole = ts._spgemm_data(dataclasses.replace(tplan, ws_c=None), ta.data, tb.data).numpy()
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-6)


def test_csr_operators_match_jax(rng):
    ja, ta = _pair(40, (40, 40), 0.1)
    jb, tb = _pair(41, (40, 40), 0.15)
    for op in ("matmul", "add", "sub", "mul"):
        jc = getattr(ja, f"__{op}__")(jb)
        tc = getattr(ta, f"__{op}__")(tb)
        np.testing.assert_array_equal(tc.indptr, np.asarray(jc.indptr), err_msg=op)
        np.testing.assert_array_equal(tc.indices, np.asarray(jc.indices), err_msg=op)
        np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data), **TOL, err_msg=op)
    for tc, jc in ((-ta, -ja), (ta * 2.5, ja * 2.5), (2.5 * ta, 2.5 * ja)):
        np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data), **TOL)
    with pytest.raises(TypeError, match="would densify"):
        ta * torch.ones(40)
    with pytest.raises(TypeError, match="would densify"):
        np.ones(3) * ta
    assert ta.__add__(1.0) is NotImplemented
