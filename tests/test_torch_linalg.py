"""Parity of the port's sparse linear algebra with the JAX package
(tests/test_linalg.py). Every operator is built with scipy from a numpy
seed and handed to both packages. Where the JAX function is deterministic
(the Krylov solvers from x0 = 0, the triangular solves, ILU(0)/IC(0), lsqr,
minres, expm_multiply, the direct and block solves) the port is held
against it at the fp32 tier, and against scipy's fp64 oracles as the JAX
tests are; the eigensolvers start from random vectors drawn by each
package's own generator, so they are held against scipy, as JAX's tests
hold JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import scipy.sparse.linalg as sla
import torch

import tpusparse as ts
import tpusparse_torch as tt
from tpusparse import linalg as jl
from tpusparse_torch import linalg as tl
from tpusparse_torch.types import DIA

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite


def _sp_spd(seed, n=96, density=0.05):
    """Diagonally dominant symmetric (hence SPD) scipy CSR."""
    b = ssp.random(n, n, density=density, random_state=seed, format="csr", dtype=np.float64)
    s = b + b.T + ssp.identity(n) * (2.0 * n * density + 1.0)
    s = s.tocsr().astype(np.float32)
    s.sort_indices()
    return s


def _sp_nonsym(seed, n=64, density=0.08, boost=8.0):
    b = ssp.random(n, n, density=density, random_state=seed, format="csr", dtype=np.float64)
    s = (b + ssp.identity(n) * boost).tocsr().astype(np.float32)
    s.sort_indices()
    return s


def _pair(sp):
    sp = ssp.csr_matrix(sp)
    sp.sort_indices()
    return tt.CSR.from_scipy(sp, device="cpu"), ts.CSR.from_scipy(sp)


def _solve64(sp, b):
    return sla.spsolve(sp.astype(np.float64).tocsc(), np.asarray(b, np.float64))


def _vec(seed, n, kind="random"):
    rng = np.random.default_rng(seed)
    return (rng.random(n) if kind == "random" else rng.normal(size=n)).astype(np.float32)


def test_speye_and_diagonal():
    np.testing.assert_array_equal(tl.speye(5, device="cpu").to_dense().numpy(),
                                  np.eye(5, dtype=np.float32))
    sp = ssp.random(32, 32, density=0.1, random_state=1, format="csr", dtype=np.float32)
    t, j = _pair(sp)
    np.testing.assert_array_equal(tl.diagonal(t).numpy(), np.asarray(jl.diagonal(j)))
    vals = t.data.clone().requires_grad_()
    (tl.diagonal(tt.CSR(vals, t.indices, t.indptr, t.shape)) ** 2).sum().backward()
    on_diag = t.row_ids() == t.indices
    np.testing.assert_allclose(vals.grad.numpy()[on_diag], 2 * t.data.numpy()[on_diag])
    assert (vals.grad.numpy()[~on_diag] == 0).all()


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_cg_matches_jax_and_scipy(precond):
    sp = _sp_spd(3 if precond is None else 4)
    t, j = _pair(sp)
    b = _vec(0, 96)
    tm = tl.jacobi_preconditioner(t) if precond else None
    jm = jl.jacobi_preconditioner(j) if precond else None
    x, info = tl.cg(t, torch.from_numpy(b), tol=1e-6, maxiter=500, M=tm)
    xj, _ = jl.cg(j, jnp.asarray(b), tol=1e-6, maxiter=500, M=jm)
    assert info is None
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(x.numpy(), _solve64(sp, b), rtol=1e-3, atol=1e-4)


def test_cg_stops_where_jax_stops_whatever_the_check_interval(monkeypatch):
    """The stop flag stays on the device and freezes the iterates: reading
    it every iteration or every 7 gives the same x, bit for bit."""
    sp = _sp_spd(5)
    t, _ = _pair(sp)
    b = torch.from_numpy(_vec(1, 96))
    xs = []
    for every in (1, 7):
        monkeypatch.setattr(tl, "_CHECK_EVERY", every)
        xs.append(tl.cg(t, b, tol=1e-5, maxiter=300)[0].numpy())
    np.testing.assert_array_equal(xs[0], xs[1])


def test_cg_gradient_in_b_is_the_adjoint_solve():
    sp = _sp_spd(6, n=64)
    t, j = _pair(sp)
    b = torch.from_numpy(_vec(2, 64)).requires_grad_()
    g = _vec(3, 64, "normal")
    x, _ = tl.cg(t, b, tol=1e-7, maxiter=300)
    (x * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), _solve64(sp.T, g), rtol=1e-3, atol=1e-4)


def test_bicgstab_matches_jax_and_scipy():
    sp = _sp_nonsym(6)
    t, j = _pair(sp)
    b = _vec(4, 64)
    x, info = tl.bicgstab(t, torch.from_numpy(b), tol=1e-7, maxiter=800)
    xj, _ = jl.bicgstab(j, jnp.asarray(b), tol=1e-7, maxiter=800)
    assert info is None
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(x.numpy(), _solve64(sp, b), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("solve_method", ["batched", "incremental"])
def test_gmres_matches_jax_and_scipy(solve_method):
    sp = _sp_nonsym(7)
    t, j = _pair(sp)
    b = _vec(5, 64)
    x, info = tl.gmres(t, torch.from_numpy(b), tol=1e-7, restart=32, maxiter=200,
                       solve_method=solve_method)
    xj, infoj = jl.gmres(j, jnp.asarray(b), tol=1e-7, restart=32, maxiter=200,
                         solve_method=solve_method)
    assert int(info) == int(infoj) == 0
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(x.numpy(), _solve64(sp, b), rtol=1e-2, atol=1e-3)
    with pytest.raises(ValueError, match="solve_method"):
        tl.gmres(t, torch.from_numpy(b), solve_method="bogus")


def _fault4_case():
    """ROADMAP fault 4's input: a 50x50 fp32 CSR with diagonal 6, -1 on the
    first off-diagonals and ~2 % random entries (symmetric), and b (50, 3)
    standard normal."""
    n = 50
    r = ssp.random(n, n, density=0.02, random_state=11, format="csr", dtype=np.float64)
    s = ssp.diags([-1.0, 6.0, -1.0], [-1, 0, 1], shape=(n, n)) - 0.5 * (r + r.T)
    s = s.tocsr().astype(np.float32)
    s.sort_indices()
    b = np.random.default_rng(12).standard_normal((n, 3)).astype(np.float32)
    return s, b


@pytest.mark.parametrize("solve_method", ["batched", "incremental"])
def test_gmres_takes_a_2d_b_as_jax_does(solve_method):
    sp, b = _fault4_case()
    t, j = _pair(sp)
    x, info = tl.gmres(t, torch.from_numpy(b), solve_method=solve_method)
    xj, infoj = jl.gmres(j, jnp.asarray(b), solve_method=solve_method)
    assert x.shape == b.shape == xj.shape
    assert int(info) == int(infoj) == 0
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(x.numpy(), _solve64(sp, b), rtol=1e-3, atol=1e-4)


def test_gmres_2d_b_gradient_matches_jax():
    sp, b = _fault4_case()
    t, j = _pair(sp)
    g = np.random.default_rng(13).standard_normal(b.shape).astype(np.float32)
    bt = torch.from_numpy(b).requires_grad_()
    x, _ = tl.gmres(t, bt, tol=1e-7)
    (x * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda bb: jnp.sum(jl.gmres(j, bb, tol=1e-7)[0] * jnp.asarray(g)))(
        jnp.asarray(b))
    assert bt.grad.shape == b.shape
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), _solve64(sp.T.tocsr(), g), rtol=1e-3,
                               atol=1e-4)


def test_nonsymmetric_gradients_solve_with_the_transpose():
    sp = _sp_nonsym(8, n=48)
    t, _ = _pair(sp)
    g = _vec(6, 48, "normal")
    for solver in (tl.bicgstab, tl.gmres):
        b = torch.from_numpy(_vec(7, 48)).requires_grad_()
        x, _ = solver(t, b, tol=1e-7, maxiter=400)
        (x * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(b.grad.numpy(), _solve64(sp.T.tocsr(), g), rtol=1e-3,
                                   atol=1e-4)


def test_as_matvec_upgrades_banded_and_guards_shape():
    n = 400
    sp = ssp.diags([-1.0, 4.0, -1.0, -1.0, -1.0], [-20, 0, 1, -1, 20], shape=(n, n),
                   format="csr", dtype=np.float32)
    t, j = _pair(sp)
    assert isinstance(tl._maybe_dia(t), DIA)
    b = _vec(8, n)
    x, _ = tl.cg(t, torch.from_numpy(b), tol=1e-6, maxiter=400)
    np.testing.assert_allclose(x.numpy(), np.asarray(jl.cg(j, jnp.asarray(b), tol=1e-6,
                                                           maxiter=400)[0]), **TOL)
    with pytest.raises(ValueError, match="square"):
        tl.as_matvec(tt.random_csr(11, (8, 12), 0.3, device="cpu"))
    # the transposable form equals the routed one
    v = torch.from_numpy(_vec(9, n))
    np.testing.assert_allclose(tl.as_matvec(t, transposable=True)(v).numpy(),
                               tl.as_matvec(t)(v).numpy(), **TOL)


def test_power_iteration_and_lobpcg_match_scipy():
    sp = _sp_spd(8, n=64, density=0.08)
    t, _ = _pair(sp)
    lam, v = tl.power_iteration(t, iters=300)
    ref = sla.eigsh(sp.astype(np.float64), k=1, which="LM")[0][0]
    np.testing.assert_allclose(float(lam), ref, rtol=1e-3)
    res = sp.astype(np.float64) @ v.double().numpy()
    np.testing.assert_allclose(res, float(lam) * v.double().numpy(), atol=1e-2)
    sp = _sp_spd(9, n=128, density=0.05)
    t, _ = _pair(sp)
    theta, u, it = tl.lobpcg_topk(t, k=3, iters=200)
    ref = np.sort(sla.eigsh(sp.astype(np.float64), k=3, which="LA")[0])[::-1]
    np.testing.assert_allclose(theta.numpy(), ref, rtol=1e-3)
    assert u.shape == (128, 3) and 1 <= it <= 200


@pytest.mark.parametrize("lower", [True, False])
def test_triangular_solves_match_jax_and_scipy(lower):
    rng = np.random.default_rng(10 + lower)
    n = 48
    dense = rng.random((n, n), dtype=np.float32)
    dense = np.tril(dense) if lower else np.triu(dense)
    dense[dense < 0.7] = 0.0
    np.fill_diagonal(dense, rng.random(n, dtype=np.float32) + 1.0)
    t, j = _pair(ssp.csr_matrix(dense))
    b = rng.random(n, dtype=np.float32)
    tf = tl.spsolve_lower_triangular if lower else tl.spsolve_upper_triangular
    jf = jl.spsolve_lower_triangular if lower else jl.spsolve_upper_triangular
    x = tf(t, torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(jf(j, jnp.asarray(b))), **TOL)
    ref = sla.spsolve_triangular(ssp.csr_matrix(dense.astype(np.float64)), b.astype(np.float64),
                                 lower=lower)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-4, atol=1e-5)
    bm = rng.random((n, 3), dtype=np.float32)  # several right-hand sides, column by column
    xm = tf(t, torch.from_numpy(bm)).numpy()
    for c in range(3):
        np.testing.assert_allclose(xm[:, c], tf(t, torch.from_numpy(bm[:, c])).numpy(), **TOL)
    wrong = tt.CSR.from_scipy(ssp.csr_matrix(dense.T), device="cpu")
    with pytest.raises(ValueError, match="above the diagonal" if lower else "below"):
        tf(wrong, torch.ones(n))


def _sp_with_diagonal(seed, n=40, density=0.12):
    b = ssp.random(n, n, density=density, random_state=seed, format="csr", dtype=np.float64)
    s = (b + ssp.identity(n) * (2.0 + n * density)).tocsr().astype(np.float32)
    s.sort_indices()
    return s


def test_ilu0_and_ic0_equal_jax():
    t, j = _pair(_sp_with_diagonal(13))
    (L, U), (jL, jU) = tl.ilu0(t), jl.ilu0(j)
    for got, want in ((L, jL), (U, jU)):
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    t, j = _pair(_sp_spd(15, n=64, density=0.06))
    Lc, jLc = tl.ic0(t), jl.ic0(j)
    np.testing.assert_array_equal(Lc.indices, jLc.indices)
    np.testing.assert_array_equal(Lc.data.numpy(), np.asarray(jLc.data))
    ld = Lc.to_dense().double().numpy()
    ad = t.to_dense().double().numpy()
    mask = (ad != 0) & (np.abs(np.tril(ad)) > 0)
    np.testing.assert_allclose((ld @ ld.T)[mask], ad[mask], rtol=1e-5, atol=1e-6)


def test_ilu0_numpy_pass_equals_native(monkeypatch):
    from tpusparse_torch.runtime import native

    t, _ = _pair(_sp_with_diagonal(14, 32))
    if not native.available():
        pytest.skip("no native toolchain")
    L1, U1 = tl.ilu0(t)
    Lc1 = tl.ic0(_pair(_sp_spd(16, n=32, density=0.1))[0])
    monkeypatch.setattr(native, "available", lambda: False)
    L2, U2 = tl.ilu0(t)
    Lc2 = tl.ic0(_pair(_sp_spd(16, n=32, density=0.1))[0])
    for a, b in ((L1, L2), (U1, U2), (Lc1, Lc2)):
        np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())


def test_factorisation_guards():
    dense = np.zeros((3, 3), np.float32)
    dense[0, 0] = dense[2, 2] = 1.0
    dense[1, 0] = 1.0
    with pytest.raises(ValueError, match="row 1"):
        tl.ilu0(tt.CSR.from_dense(dense, device="cpu"))
    with pytest.raises(ValueError, match="positive"):
        tl.ic0(tt.CSR.from_dense(np.array([[1.0, 2.0], [2.0, 1.0]], np.float32), device="cpu"))


def test_ilu_and_ic_preconditioners_match_jax():
    sp = _sp_with_diagonal(16, 96, 0.08)
    t, j = _pair(sp)
    b = _vec(11, 96)
    x, _ = tl.gmres(t, torch.from_numpy(b), M=tl.ilu_preconditioner(t), tol=1e-6, maxiter=200)
    xj, _ = jl.gmres(j, jnp.asarray(b), M=jl.ilu_preconditioner(j), tol=1e-6, maxiter=200)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(x.numpy(), _solve64(sp, b), rtol=2e-4, atol=2e-5)
    sp = _sp_spd(17, n=96, density=0.05)
    t, j = _pair(sp)
    x, _ = tl.cg(t, torch.from_numpy(b), M=tl.ic_preconditioner(t), tol=1e-6, maxiter=300)
    xj, _ = jl.cg(j, jnp.asarray(b), M=jl.ic_preconditioner(j), tol=1e-6, maxiter=300)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(x.numpy(), _solve64(sp, b), rtol=2e-4, atol=2e-5)


def test_rcm_and_bandwidth_equal_jax():
    rng = np.random.default_rng(5)
    n = 128
    dense = np.zeros((n, n), np.float32)
    for off in range(-3, 4):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.random(idx.size) + 0.1
    hide = rng.permutation(n)
    t, j = _pair(ssp.csr_matrix(dense[hide][:, hide]))
    assert tl.bandwidth(t) == jl.bandwidth(j) > 20
    perm = tl.rcm_permutation(t)
    np.testing.assert_array_equal(perm, jl.rcm_permutation(j))
    assert tl.bandwidth(tt.permute_csr(t, perm, perm)) <= 8
    assert tl.bandwidth(tl.speye(5, device="cpu")) == 0


def test_eigsh_lanczos_matches_scipy_and_guards():
    sp = _sp_spd(11, n=160, density=0.05)
    t, _ = _pair(sp)
    a64 = sp.astype(np.float64)
    dense_vals = np.linalg.eigvalsh(a64.toarray())
    for which, k in (("LA", 4), ("SA", 3), ("LM", 2)):
        vals, vecs = tl.eigsh_lanczos(t, k=k, which=which, iters=70)
        ref = {"LA": dense_vals[::-1][:k], "SA": dense_vals[:k],
               "LM": dense_vals[np.argsort(np.abs(dense_vals))[::-1][:k]]}[which]
        np.testing.assert_allclose(np.sort(vals.numpy()), np.sort(ref), rtol=1e-3, atol=1e-3)
        for i in range(k):
            v = vecs[:, i].double().numpy()
            assert np.linalg.norm(a64 @ v - float(vals[i]) * v) < 2e-2, (which, i)
    with pytest.raises(ValueError, match="square"):
        tl.eigsh_lanczos(tt.random_csr(0, (8, 9), 0.5, device="cpu"))
    with pytest.raises(ValueError, match="which"):
        tl.eigsh_lanczos(t, which="XX")
    with pytest.raises(ValueError, match="at least"):
        tl.eigsh_lanczos(t, k=30, iters=8)


def test_eigsh_lanczos_breakdown_returns_true_extremes():
    t = tt.sp_add(tl.speye(32, device="cpu"), tl.speye(32, device="cpu"))
    for which in ("LA", "SA", "LM"):
        vals, vecs = tl.eigsh_lanczos(t, k=2, which=which, iters=10)
        assert float(vals[0]) == pytest.approx(2.0, rel=1e-5)
        assert np.isnan(vals[1].item())
        assert np.isfinite(vecs[:, 0].numpy()).all()


def test_expm_multiply_matches_jax_and_scipy():
    sp = _sp_spd(21, n=200, density=0.04)
    t, j = _pair(sp)
    v = _vec(12, 200, "normal")
    for tt_ in (0.2, -0.7):
        got = tl.expm_multiply(t, torch.from_numpy(v), tt_, krylov_dim=40).numpy()
        want = np.asarray(jl.expm_multiply(j, jnp.asarray(v), tt_, krylov_dim=40))
        ref = sla.expm_multiply(tt_ * sp.astype(np.float64), v.astype(np.float64))
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(tl.expm_multiply(t, torch.from_numpy(v), 0.0).numpy(), v,
                               rtol=1e-4, atol=1e-5)


def test_block_jacobi_matches_jax():
    rng = np.random.default_rng(3)
    blocks = [rng.normal(size=(16, 16)) for _ in range(4)]
    blocks = [b @ b.T + 16 * np.eye(16) for b in blocks]
    sp = ssp.block_diag(blocks, format="csr").astype(np.float32)
    t, j = _pair(sp)
    m, jm = tl.block_jacobi_preconditioner(t, 16), jl.block_jacobi_preconditioner(j, 16)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(m(torch.from_numpy(v)).numpy(), np.asarray(jm(jnp.asarray(v))),
                               **TOL)
    np.testing.assert_allclose(m(torch.from_numpy(v[:, 0])).numpy(),
                               np.linalg.solve(sp.toarray().astype(np.float64), v[:, 0]),
                               rtol=1e-3, atol=1e-4)
    sp = _sp_spd(23, n=160, density=0.06)  # ragged last block, as a CG preconditioner
    t, _ = _pair(sp)
    b = _vec(13, 160, "normal")
    x, _ = tl.cg(t, torch.from_numpy(b), M=tl.block_jacobi_preconditioner(t, 20), tol=1e-8,
                 maxiter=200)
    assert np.linalg.norm(sp @ x.numpy() - b) / np.linalg.norm(b) < 1e-4


def test_tridiagonal_solve_matches_jax():
    rng = np.random.default_rng(4)
    n = 50
    sp = ssp.diags([rng.random(n - 1), 4 + rng.random(n), rng.random(n - 1)], [-1, 0, 1],
                   format="csr", dtype=np.float32)
    t, j = _pair(sp)
    for b in (rng.random(n).astype(np.float32), rng.random((n, 2)).astype(np.float32)):
        got = tl.tridiagonal_solve(t, torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, np.asarray(jl.tridiagonal_solve(j, jnp.asarray(b))),
                                   **TOL)
    with pytest.raises(ValueError, match="tridiagonal|distinct"):
        tl.tridiagonal_solve(_pair(_sp_spd(3, n=20, density=0.3))[0], torch.ones(20))


def test_svds_matches_scipy():
    for (m, n), k in (((120, 80), 5), ((40, 90), 3)):
        A = ssp.random(m, n, density=0.1, random_state=3, format="csr", dtype=np.float64)
        A.data += 1.0
        t, _ = _pair(A.astype(np.float32))
        u, s, vt = tl.svds(t, k=k, iters=40)
        s_ref = np.sort(sla.svds(A, k=k, return_singular_vectors=False))[::-1]
        np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-4)
        np.testing.assert_allclose(u.numpy().T @ u.numpy(), np.eye(k), atol=1e-4)
        np.testing.assert_allclose(vt.numpy() @ vt.numpy().T, np.eye(k), atol=1e-4)
    d = np.zeros((30, 20), np.float32)
    d[2, 3], d[7, 11] = 5.0, 3.0
    _, s, _ = tl.svds(tt.CSR.from_dense(d, device="cpu"), k=4, iters=16)
    np.testing.assert_allclose(s.numpy()[:2], [5.0, 3.0], rtol=1e-5)
    assert np.isnan(s.numpy()[2:]).all()
    with pytest.raises(ValueError, match="k="):
        tl.svds(tt.random_csr(0, (16, 12), 0.3, device="cpu"), k=10, iters=4)


@pytest.mark.parametrize("damp", [0.0, 0.5])
def test_lsqr_matches_jax_and_lstsq(damp):
    m, n = 150, 60
    B = ssp.random(m, n, density=0.1, random_state=5, format="csr", dtype=np.float64)
    B = (B + ssp.eye(m, n) * 2.0).tocsr()
    b = np.random.default_rng(14).normal(size=m)
    t, j = _pair(B.astype(np.float32))
    x = tl.lsqr(t, torch.from_numpy(b.astype(np.float32)), damp=damp, iters=80).numpy()
    xj = np.asarray(jl.lsqr(j, jnp.asarray(b, jnp.float32), damp=damp, iters=80))
    np.testing.assert_allclose(x, xj, rtol=1e-3, atol=1e-4)
    d = B.toarray()
    x_ref = np.linalg.solve(d.T @ d + damp ** 2 * np.eye(n), d.T @ b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="b must be"):
        tl.lsqr(t, torch.zeros(3))


def test_minres_matches_jax_and_solve():
    n = 100
    C = ssp.random(n, n, density=0.05, random_state=7, format="csr", dtype=np.float64)
    S = ((C + C.T) * 0.5 + ssp.diags(np.concatenate([np.full(n // 2, 3.0),
                                                      np.full(n - n // 2, -3.0)]))).tocsr()
    b = np.random.default_rng(15).normal(size=n)
    t, j = _pair(S.astype(np.float32))
    x_ref = np.linalg.solve(S.toarray(), b)
    dinv = 1.0 / np.abs(S.diagonal()).astype(np.float32)
    for tm, jm in ((None, None), (lambda v: v * torch.from_numpy(dinv),
                                  lambda v: v * jnp.asarray(dinv))):
        x = tl.minres(t, torch.from_numpy(b.astype(np.float32)), M=tm, iters=200).numpy()
        xj = np.asarray(jl.minres(j, jnp.asarray(b, jnp.float32), M=jm, iters=200))
        np.testing.assert_allclose(x, xj, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(x, x_ref, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="square"):
        tl.minres(tt.random_csr(0, (8, 9), 0.5, device="cpu"), torch.zeros(9))
