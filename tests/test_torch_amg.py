"""Parity of the port's smoothed-aggregation AMG with the JAX package
(tests/test_amg.py). Setup is deterministic host work in both packages, so
every array of the hierarchy must be equal: level sizes and formats, the
DIA offsets in plane order and the planes, dinv, agg, w, omega, rho, the
CSR remainders, P and R, and the adopted window plans. The V-cycle and
AMG-CG then meet the fp32 tier of the JAX suite; the JAX side runs its
Pallas kernels in interpret mode, so its calls are kept few. The fixtures
are tests/test_amg.py's: 2-D Poisson on 24², and the 7-point Laplacian on
12³, whose level 1 is a 185-diagonal wide-DIA (PackedDIA) level."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import tpusparse as ts
import tpusparse_torch as tt
from tpusparse import amg as ja
from tpusparse.kernels.dia import PackedDIA as JPacked
from tpusparse.linalg import cg as jcg
from tpusparse.types import DIA as JDIA
from tpusparse_torch import amg as ta
from tpusparse_torch import linalg as tl
from tpusparse_torch.kernels.dia import PackedDIA
from tpusparse_torch.types import DIA

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
GATHER_FIELDS = ("idx", "starts", "rel", "exc_pos", "exc_idx", "n", "table_len", "window", "nb")
SEGMENT_FIELDS = ("seg", "starts", "seg_masked", "exc_pos", "exc_seg", "mask", "n_in",
                  "num_segments", "window", "nb")


def _sp_poisson2d(n1):
    T = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n1, n1), format="csr")
    I = ssp.eye(n1, format="csr")
    a = (ssp.kron(I, T) + ssp.kron(T, I)).tocsr().astype(np.float32)
    a.sort_indices()
    return a


def _sp_laplace3d(n1):
    T = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n1, n1), format="csr")
    I = ssp.eye(n1, format="csr")
    a = (ssp.kron(ssp.kron(T, I), I) + ssp.kron(ssp.kron(I, T), I)
         + ssp.kron(ssp.kron(I, I), T)).tocsr().astype(np.float32)
    a.sort_indices()
    return a


def _both(sp):
    return tt.CSR.from_scipy(sp, device="cpu"), ts.CSR.from_scipy(sp)


def _setup_pair(sp, **kw):
    t, j = _both(sp)
    return t, j, ta.smoothed_aggregation_setup(t, **kw), ja.smoothed_aggregation_setup(j, **kw)


@pytest.fixture(scope="module")
def poisson():
    return (_sp_poisson2d(24),) + _setup_pair(_sp_poisson2d(24), coarse_size=40)


@pytest.fixture(scope="module")
def laplace3d():
    return (_sp_laplace3d(12),) + _setup_pair(_sp_laplace3d(12))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, what):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, what
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
        got = got.astype(np.float32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_op(t, j, what):
    """A level operator (or a factored prolongator's D⁻¹A) of either kind."""
    assert type(t).__name__.lstrip("_") == type(j).__name__.lstrip("_"), what
    if isinstance(j, JPacked):
        _same(t.offsets, j.offsets, what + " offsets")  # plane order
        _same(t.unpack_data().float(), j.unpack_data().astype(jnp.float32), what + " plane")
        assert t.shape == j.shape
    elif isinstance(j, JDIA):
        _same(t.offsets, j.offsets, what + " offsets")
        _same(t.data.float(), j.data.astype(jnp.float32), what + " plane")
    elif isinstance(j, ja._HybridOp):
        _same_op(t.dia, j.dia, what + " dia part")
        for f in ("indptr", "indices"):
            _same(getattr(t.rem, f), getattr(j.rem, f), what + " remainder " + f)
        _same(t.rem.data, j.rem.data, what + " remainder values")
    else:  # _RoutedCSR
        assert t.kind == j.kind, what
        for f in ("indptr", "indices", "data"):
            _same(getattr(t.host, f), getattr(j.host, f), what + " host " + f)


def _same_plan(tp, jp, fields, what):
    assert (tp is None) == (jp is None), what
    if tp is None:
        return
    for f in fields:
        got, want = getattr(tp, f), getattr(jp, f)
        if isinstance(want, np.ndarray):
            _same(got, want, f"{what} {f}")
        else:
            assert got == want, f"{what} {f}"


def _same_hierarchy(tm, jm):
    assert len(tm.levels) == len(jm.levels)
    assert tm.report() == jm.report()
    for i, (tl_, jl) in enumerate(zip(tm.levels, jm.levels)):
        w = f"level {i}"
        assert (tl_.nnz, tl_.rho) == (jl.nnz, jl.rho), w
        assert tl_.a.shape == jl.a.shape, w
        _same_op(tl_.a, jl.a, w)
        _same(tl_.dinv, jl.dinv, w + " dinv")
        assert (tl_.p is None) == (jl.p is None), w
        if jl.p is None:
            continue
        for name in ("p", "r"):
            for f in ("indptr", "indices", "data"):
                _same(getattr(getattr(tl_, name), f), getattr(getattr(jl, name), f),
                      f"{w} {name} {f}")
        assert (tl_.p_fact is None) == (jl.p_fact is None), w
        if jl.p_fact is not None:
            tf, jf = tl_.p_fact, jl.p_fact
            _same(tf.agg, jf.agg.astype(np.int64), w + " agg")
            _same(tf.w, jf.w, w + " w")
            assert (tf.omega, tf.shape) == (jf.omega, jf.shape), w
            _same_op(tf.dinv_a, jf.dinv_a, w + " D⁻¹A")
            _same_op(tf.dinv_a_t, jf.dinv_a_t, w + " (D⁻¹A)ᵀ")
            _same_plan(tf.gplan, jf.gplan, GATHER_FIELDS, w + " gather plan")
            _same_plan(tf.splan, jf.splan, SEGMENT_FIELDS, w + " segment plan")
        else:
            _same_op(tl_.p_op, jl.p_op, w + " P")
            _same_op(tl_.r_op, jl.r_op, w + " R")
    np.testing.assert_allclose(_host(tm.coarse_lu[0]), _host(jm.coarse_lu[0]), rtol=1e-6,
                               atol=1e-6)


def test_poisson_hierarchy_equals_jax(poisson):
    _, _, _, tm, jm = poisson
    _same_hierarchy(tm, jm)
    assert all(lv.p_fact is not None for lv in tm.levels[:-1])
    assert tm.grid_complexity == jm.grid_complexity < 2.0


def test_laplace3d_hierarchy_equals_jax(laplace3d):
    _, _, _, tm, jm = laplace3d
    _same_hierarchy(tm, jm)
    assert isinstance(tm.levels[1].a, PackedDIA) and tm.levels[1].a.offsets.size == 185
    assert tm.levels[1].p_fact is not None
    assert isinstance(tm.levels[1].p_fact.dinv_a_t, PackedDIA)
    ns = [lv.a.shape[0] for lv in tm.levels]
    for fine, coarse in zip(ns, ns[1:]):
        assert coarse <= fine / 2.5, ns


@pytest.mark.parametrize("fixture", ["poisson", "laplace3d"])
def test_vcycle_matches_jax(fixture, request):
    sp, _, _, tm, jm = request.getfixturevalue(fixture)
    b = np.random.default_rng(0).standard_normal(sp.shape[0]).astype(np.float32)
    got = tm(torch.from_numpy(b)).numpy()
    want = np.asarray(jm(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **TOL)


def test_amg_cg_five_iterations_match_jax(laplace3d):
    sp, t, j, tm, jm = laplace3d
    b = np.random.default_rng(1).random(sp.shape[0]).astype(np.float32)
    got, info = tl.cg(t, torch.from_numpy(b), tol=1e-7, maxiter=5, M=tm)
    want, _ = jcg(j, jnp.asarray(b), tol=1e-7, maxiter=5, M=jm)
    assert info is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vcycle_contracts_and_beats_plain_cg(poisson):
    sp, t, _, tm, _ = poisson
    rng = np.random.default_rng(0)
    b = torch.from_numpy(sp @ rng.normal(size=sp.shape[0]).astype(np.float32))
    x = torch.zeros_like(b)
    resids = []
    for _ in range(6):
        x = x + tm(b - tt.spmm(t, x, method="gather"))
        resids.append(np.linalg.norm(sp @ x.numpy() - b.numpy()) / np.linalg.norm(b.numpy()))
    assert resids[-1] < 1e-3, resids
    for r0, r1 in zip(resids, resids[1:]):
        assert r1 < 0.6 * r0, resids
    x_amg, _ = tl.cg(t, b, M=tm, tol=0.0, maxiter=10)
    x_plain, _ = tl.cg(t, b, tol=0.0, maxiter=10)

    def res(x_):
        return np.linalg.norm(sp @ x_.numpy() - b.numpy())

    assert res(x_amg) < 1e-2 * res(x_plain)


def test_multivector_matches_jax_and_columns(poisson):
    sp, _, _, tm, jm = poisson
    v = np.random.default_rng(2).standard_normal((sp.shape[0], 3)).astype(np.float32)
    out = tm(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm(jnp.asarray(v))), **TOL)
    for k in range(3):
        np.testing.assert_allclose(out[:, k], tm(torch.from_numpy(v[:, k])).numpy(), **TOL)


def test_galerkin_and_factored_prolongator(poisson):
    sp, _, _, tm, _ = poisson
    lvl = tm.levels[0]
    p = lvl.p.to_dense().double().numpy()
    ac = tm.levels[1].a.to_dense() if hasattr(tm.levels[1].a, "to_dense") else None
    if ac is not None:
        np.testing.assert_allclose(ac.double().numpy(), p.T @ sp.toarray() @ p, rtol=1e-4,
                                   atol=1e-5)
    rng = np.random.default_rng(5)
    e = torch.from_numpy(rng.normal(size=tm.levels[1].a.shape[0]).astype(np.float32))
    np.testing.assert_allclose(lvl.p_fact.mv(e).numpy(), (p @ e.double().numpy()), **TOL)
    r = torch.from_numpy(rng.normal(size=sp.shape[0]).astype(np.float32))
    np.testing.assert_allclose(lvl.p_fact.rmv(r).numpy(), p.T @ r.double().numpy(), **TOL)


def test_chebyshev_matches_jax_and_beats_jacobi():
    sp = _sp_poisson2d(16)
    t, j, tm, jm = _setup_pair(sp, coarse_size=30, smoother="chebyshev")
    _same_hierarchy(tm, jm)
    b = np.random.default_rng(4).standard_normal(sp.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(b)).numpy(), np.asarray(jm(jnp.asarray(b))),
                               **TOL)
    n = sp.shape[0]
    ad = sp.toarray().astype(np.float32)

    def radius(m):
        out = m(torch.from_numpy(ad)).double().numpy()
        return np.abs(np.linalg.eigvals(np.eye(n) - out)).max()

    r_jac = radius(ta.smoothed_aggregation_setup(t, coarse_size=30))
    assert radius(tm) < r_jac < 1.0
    x, _ = tl.cg(t, torch.from_numpy(b), M=tm, tol=1e-7, maxiter=30)
    assert np.linalg.norm(sp @ x.numpy() - b) / np.linalg.norm(b) < 1e-5
    with pytest.raises(ValueError, match="smoother"):
        ta.smoothed_aggregation_setup(t, smoother="sor")


def test_bf16_level_planes_match_jax(laplace3d):
    """level_dtype='bf16' stores the planes in bf16 (equal to JAX's); the
    V-cycle then sums bf16 products in other orders than JAX's, so it is held
    at 1e-2 of scale (a few bf16 ulps), and AMG-CG still converges."""
    sp, t, j, _, _ = laplace3d
    tm = ta.smoothed_aggregation_setup(t, level_dtype="bf16")
    jm = ja.smoothed_aggregation_setup(j, level_dtype="bf16")
    _same_hierarchy(tm, jm)
    assert tm.levels[1].a.dtype == torch.bfloat16
    b = np.random.default_rng(6).standard_normal(sp.shape[0]).astype(np.float32)
    got = tm(torch.from_numpy(b)).numpy()
    want = np.asarray(jm(jnp.asarray(b)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-2
    x, _ = tl.cg(t, torch.from_numpy(b), M=tm, tol=1e-8, maxiter=50)
    assert np.linalg.norm(sp @ x.numpy() - b) / np.linalg.norm(b) < 1e-4


def test_route_level_matches_jax_and_reconstructs():
    rng = np.random.default_rng(2)
    for n, n_scatter in ((64, 40), (4096, 300)):
        a = ssp.diags([rng.random(n - 1), 2 + rng.random(n), rng.random(n - 1)], [-1, 0, 1],
                      format="lil")
        for _ in range(n_scatter):
            i, k = rng.integers(0, n, 2)
            a[i, k] = rng.random() + 0.1
        a = a.tocsr().astype(np.float64)
        a.sort_indices()
        got = ta._route_level(a.indptr, a.indices, a.data, n, np.float32)
        want = ja._route_level(a.indptr, a.indices, a.data, n, np.float32)
        for g_, w_ in zip(got[:2], want[:2]):
            _same(g_, w_, "split")
        assert (got[2] is None) == (want[2] is None)
        dia_host, offs, rem = got
        if rem is not None:
            for g_, w_ in zip(rem, want[2]):
                _same(g_, w_, "remainder")
            op = ta._HybridOp(
                dia=DIA(data=torch.from_numpy(dia_host), offsets=offs, shape=(n, n)),
                rem=tt.CSR(data=torch.from_numpy(rem[2].astype(np.float32)), indices=rem[1],
                           indptr=rem[0], shape=(n, n)),
                shape=(n, n))
            x = rng.normal(size=n).astype(np.float32)
            np.testing.assert_allclose(op.mv(torch.from_numpy(x)).numpy(), a @ x, rtol=1e-4,
                                       atol=1e-4)


def test_routed_csr_levels_match_jax(monkeypatch):
    """All-CSR routing (pinned, as tests/test_amg.py pins it): the levels
    take the executors JAX's router picks, with P and R routed at setup."""
    monkeypatch.setattr(ta, "_route_level", lambda *a, **k: None)
    monkeypatch.setattr(ja, "_route_level", lambda *a, **k: None)
    n = 1500
    g = ssp.random(n, n, density=0.004, random_state=7, format="csr")
    spd = (g @ g.T).tocsr()
    spd = (spd + ssp.identity(n) * (np.abs(spd).sum(axis=1).max() + 1.0)).tocsr()
    spd.sort_indices()
    spd = spd.astype(np.float32)
    t, j, tm, jm = _setup_pair(spd, coarse_size=60)
    _same_hierarchy(tm, jm)
    assert any(isinstance(lv.a, ta._RoutedCSR) for lv in tm.levels)
    b = np.random.default_rng(3).normal(size=n).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(b)).numpy(), np.asarray(jm(jnp.asarray(b))),
                               **TOL)
    x, _ = tl.cg(t, torch.from_numpy(b), tol=1e-8, maxiter=50, M=tm)
    assert np.linalg.norm(spd @ x.numpy() - b) / np.linalg.norm(b) < 1e-4


def test_guards_and_tiny_matrix():
    with pytest.raises(ValueError, match="square"):
        ta.smoothed_aggregation_setup(tt.random_csr(0, (8, 9), 0.5, device="cpu"))
    z = ssp.csr_matrix(np.array([[0.0, 1.0], [1.0, 2.0]], np.float32))
    with pytest.raises(ValueError, match="diagonal"):
        ta.smoothed_aggregation_setup(tt.CSR.from_scipy(z, device="cpu"))
    sp = _sp_poisson2d(3)
    m = ta.amg_preconditioner(tt.CSR.from_scipy(sp, device="cpu"), coarse_size=40)
    assert len(m.levels) == 1
    b = np.random.default_rng(3).normal(size=9).astype(np.float32)
    np.testing.assert_allclose(sp @ m(torch.from_numpy(b)).numpy(), b, rtol=1e-4, atol=1e-5)


def test_theta_decay_disabled_converges(poisson):
    sp, t, _, _, _ = poisson
    m = ta.smoothed_aggregation_setup(t, coarse_size=40, theta_decay=1.0)
    b = np.random.default_rng(0).normal(size=sp.shape[0]).astype(np.float32)
    x, _ = tl.cg(t, torch.from_numpy(b), M=m, tol=1e-6, maxiter=40)
    assert np.linalg.norm(sp @ x.numpy() - b) / np.linalg.norm(b) < 1e-4
