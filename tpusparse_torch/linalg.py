"""Sparse iterative linear algebra on top of the port's SpMM.

Counterpart of `tpusparse/linalg.py`: `speye`, the operator helpers
(`_as_csr`, `_maybe_dia`, `as_matvec`, `diagonal`,
`jacobi_preconditioner`), the Krylov solvers `cg`, `bicgstab` and `gmres`,
the eigensolvers (`power_iteration`, `lobpcg_topk`, `eigsh_lanczos`,
`svds`), `expm_multiply`, `lsqr`, `minres`, the triangular solves,
`ilu0`/`ic0` with their preconditioners, `bandwidth`, `rcm_permutation`,
`tridiagonal_solve` and `block_jacobi_preconditioner`.

JAX's solvers are the `jax.scipy.sparse.linalg` routines; torch has none,
so `cg`, `bicgstab` and `gmres` are written out here, step for step after
that module's algorithms: the same stop rule `rs > max(tol²·|b|², atol²)`,
GMRES's restarts with both `solve_method`s ('batched' and 'incremental',
whose one classical Gram-Schmidt pass is JAX's), and `info=None` from cg
and bicgstab. A `lax.while_loop` keeps its stop test on the device; here
the loop is a Python loop whose stop flag stays on the device as well:
once it is set, every iterate is frozen (`torch.where`), so the result
equals a loop that stopped exactly there, and the host reads the flag
only every `_CHECK_EVERY` iterations (one synchronisation per check; GMRES
reads it once a restart). The
solutions are differentiable in `b` by an adjoint solve (`A`ᵀ for
bicgstab and gmres), as `lax.custom_linear_solve` gives in JAX; the
gradient with respect to the operator's values is not carried.

The random start vectors (`power_iteration`, `lobpcg_topk`,
`eigsh_lanczos`, `svds`) come from numpy's generator at `seed`: JAX's
come from `jax.random`, so the two packages start from different vectors
and agree on what they converge to. `lobpcg_topk` is a plain block LOBPCG
written here (Rayleigh-Ritz on [X, R, P]); JAX calls
`jax.experimental.sparse.linalg.lobpcg_standard`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import numpy as np
import torch

from tpusparse_torch import ops
from tpusparse_torch.types import (
    BSR,
    COO,
    CSR,
    DIA,
    _host,
    bsr_to_csr,
    coo_to_csr,
    csr_to_dia,
    dia_to_csr,
)
from tpusparse_torch.utils.config import resolve_device

Operator = Union[CSR, BSR, COO, DIA, Callable]

_INT = np.int32
_SPARSE = (CSR, BSR, COO, DIA)
# Krylov iterations between two host reads of the device-side stop flag: a
# read synchronises with the card; iterations past the stop are frozen, so
# the interval changes the time, not x
_CHECK_EVERY = 8


def speye(n: int, dtype=torch.float32, device=None) -> CSR:
    """Sparse identity I_n as CSR, values on `device` (None: the card)."""
    idx = np.arange(n, dtype=_INT)
    return CSR(
        data=torch.ones((n,), dtype=dtype, device=resolve_device(device)),
        indices=idx,
        indptr=np.arange(n + 1, dtype=_INT),
        shape=(n, n),
    )


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


def _as_csr(a: Operator):
    if isinstance(a, BSR):
        return bsr_to_csr(a)
    if isinstance(a, COO):
        return coo_to_csr(a)
    if isinstance(a, DIA):
        return dia_to_csr(a)
    return a


def _maybe_dia(a: CSR, max_offsets: int = 128) -> Operator:
    """A banded CSR as a DIA for matvec-heavy callers (at most
    `max_offsets` diagonals and a 256 MB plane); else `a` unchanged."""
    if not isinstance(a, CSR):
        return a
    pat = ops._dia_pattern(a, max_offsets)
    if pat is None:
        return a
    if int(pat[0].size) * a.shape[0] * a.data.element_size() > 256 * 1024 * 1024:
        return a
    return csr_to_dia(a, max_offsets=max_offsets)


def _square(shape, what="solvers need a square operator"):
    if shape[0] != shape[1]:
        raise ValueError(f"{what}, got {shape}")


def as_matvec(a: Operator, method: str = "auto", transposable: bool = False) -> Callable:
    """v ↦ A·v for (n,) or (n, k) v through `ops.spmm`; callables pass
    through. With method='auto' a banded CSR becomes a DIA first.
    transposable=True returns the gather/segment-sum formulation (JAX's
    form for the nonsymmetric solvers, whose custom_linear_solve transposes
    the operator)."""
    if callable(a) and not isinstance(a, _SPARSE):
        return a
    if isinstance(a, DIA):
        _square(a.shape)
        return partial(ops.spmm, a, method="auto")
    a = _as_csr(a)
    _square(a.shape)
    if not transposable:
        if method == "auto":
            a = _maybe_dia(a)
        return partial(ops.spmm, a, method=method)
    m = a.shape[0]
    dev = a.data.device
    rows = torch.from_numpy(a.row_ids().astype(np.int64)).to(dev)
    idx = torch.from_numpy(a.indices.astype(np.int64)).to(dev)

    def mv(v):
        gathered = v.index_select(0, idx)
        prods = (a.data if v.ndim == 1 else a.data[:, None]) * gathered
        out = torch.zeros((m,) + tuple(v.shape[1:]), dtype=prods.dtype, device=v.device)
        return out.index_add_(0, rows, prods)

    return mv


def _transposed_matvec(a: Operator, method: str) -> Callable:
    """v ↦ Aᵀ·v: the transposed pattern for a sparse operand, the
    vector-Jacobian product of the (linear) callable otherwise."""
    if isinstance(a, DIA):
        return as_matvec(a.transpose(), method)
    if isinstance(a, _SPARSE):
        return as_matvec(ops.transpose_csr(_as_csr(a)), method, transposable=True)

    def mvt(v):
        with torch.enable_grad():
            z = torch.zeros_like(v, requires_grad=True)
            return torch.autograd.grad(a(z), z, v)[0]

    return mvt


def diagonal(a: Operator) -> torch.Tensor:
    """diag(A) as a dense (n,) vector (absent entries 0), by one index-put
    of the stored diagonal entries; differentiable in the values."""
    a = _as_csr(a)
    n = min(a.shape)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a.indptr))
    pos = np.flatnonzero(rows == np.asarray(a.indices))
    dev = a.data.device
    return torch.zeros((n,), dtype=a.dtype, device=dev).index_put(
        (torch.from_numpy(rows[pos]).to(dev),), a.data[torch.from_numpy(pos).to(dev)])


def jacobi_preconditioner(a: Operator, eps: float = 1e-12) -> Callable:
    """M⁻¹ ≈ diag(A)⁻¹; zero or missing diagonal entries scale by 1."""
    d = diagonal(a)
    inv = torch.where(d.abs() > eps, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                      torch.ones_like(d))

    def apply(v):
        return v * inv if v.ndim == 1 else v * inv[:, None]

    return apply


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------


def _vdot(x, y):
    return torch.sum(x * y)


def _identity(x):
    return x


class _LinearSolve(torch.autograd.Function):
    """x = solve(b), differentiable in b by the adjoint solve
    (lax.custom_linear_solve's rule for b)."""

    @staticmethod
    def forward(ctx, b, solve, transpose_solve):
        ctx.transpose_solve = transpose_solve
        with torch.no_grad():
            return solve(b)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return ctx.transpose_solve(g), None, None


def _linear_solve(b, solve, transpose_solve):
    if b.requires_grad:
        return _LinearSolve.apply(b, solve, transpose_solve)
    with torch.no_grad():
        return solve(b)


def _freeze(active, new, old):
    return torch.where(active, new, old)


def _cg_solve(A, M, b, x0, *, maxiter, tol, atol):
    """jax/_src/scipy/sparse/linalg.py `_cg_solve`, with the iterates frozen
    on the device once the stop test fails."""
    bs = _vdot(b, b)
    atol2 = torch.maximum(tol ** 2 * bs, torch.as_tensor(atol ** 2, dtype=bs.dtype,
                                                         device=bs.device))
    r = b - A(x0)
    p = z = M(r)
    dtype = p.dtype
    gamma = _vdot(r, z).to(dtype)
    x = x0
    for k in range(maxiter):
        rs = gamma if M is _identity else _vdot(r, r)
        active = rs > atol2
        if k % _CHECK_EVERY == 0 and not bool(active):
            break
        ap = A(p)
        alpha = gamma / _vdot(p, ap).to(dtype)
        x_ = x + alpha * p
        r_ = r - alpha * ap
        z_ = M(r_)
        gamma_ = _vdot(r_, z_).to(dtype)
        beta = gamma_ / gamma
        p_ = z_ + beta * p
        x, r, p = _freeze(active, x_, x), _freeze(active, r_, r), _freeze(active, p_, p)
        gamma = _freeze(active, gamma_, gamma)
    return x


def _default_maxiter(b, maxiter):
    return 10 * b.numel() if maxiter is None else int(maxiter)


def cg(a: Operator, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *, tol: float = 1e-5,
       atol: float = 0.0, maxiter: Optional[int] = None, M: Optional[Callable] = None,
       method: str = "auto"):
    """Conjugate gradient for SPD A. Returns (x, None) as jax.scipy's cg.
    The stop flag stays on the device and is read every `_CHECK_EVERY`
    iterations."""
    A = as_matvec(a, method)
    M = _identity if M is None else M
    x0 = torch.zeros_like(b) if x0 is None else x0
    solve = partial(_cg_solve, A, M, x0=x0, maxiter=_default_maxiter(b, maxiter), tol=tol,
                    atol=atol)
    return _linear_solve(b, solve, solve), None


def _bicgstab_solve(A, M, b, x0, *, maxiter, tol, atol):
    """jax/_src/scipy/sparse/linalg.py `_bicgstab_solve`, frozen on the
    device as `_cg_solve`; k turns -10 or -11 on breakdown, as in JAX."""
    bs = _vdot(b, b)
    atol2 = torch.maximum(tol ** 2 * bs, torch.as_tensor(atol ** 2, dtype=bs.dtype,
                                                         device=bs.device))
    r0 = b - A(x0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, r, rhat, alpha, omega, rho, p, q = x0, r0, r0, one, one, one, r0, r0
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for it in range(maxiter):
        active = (_vdot(r, r) > atol2) & (k < maxiter) & (k >= 0)
        if it % _CHECK_EVERY == 0 and not bool(active):
            break
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / _vdot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = _vdot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega_ = _vdot(t, s) / _vdot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * phat, x + (alpha_ * phat + omega_ * shat))
        r_ = torch.where(exit_early, s, s - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        x, r, p, q = (_freeze(active, x_, x), _freeze(active, r_, r), _freeze(active, p_, p),
                      _freeze(active, q_, q))
        alpha, omega, rho = (_freeze(active, alpha_, alpha), _freeze(active, omega_, omega),
                             _freeze(active, rho_, rho))
        k = _freeze(active, k_, k)
    return x


def bicgstab(a: Operator, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
             tol: float = 1e-5, atol: float = 0.0, maxiter: Optional[int] = None,
             M: Optional[Callable] = None, method: str = "auto"):
    """BiCGSTAB for general A. Returns (x, None) as jax.scipy's bicgstab;
    the gradient in b solves with Aᵀ."""
    A = as_matvec(a, method, transposable=True)
    At = _transposed_matvec(a, method)
    M = _identity if M is None else M
    x0 = torch.zeros_like(b) if x0 is None else x0
    kw = dict(x0=x0, maxiter=_default_maxiter(b, maxiter), tol=tol, atol=atol)
    return _linear_solve(b, partial(_bicgstab_solve, A, M, **kw),
                         partial(_bicgstab_solve, At, M, **kw)), None


def _safe_normalize(x, thresh=None):
    """(x / |x|, |x|), or (0, 0) where |x| <= thresh (default: the dtype's
    eps)."""
    norm = torch.sqrt(_vdot(x, x))
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    return torch.where(use, x / norm, torch.zeros_like(x)), torch.where(use, norm,
                                                                        torch.zeros_like(norm))


def _arnoldi(k, A, M, V, H):
    """JAX's `_kth_arnoldi_iteration`: V[:, k+1] and H[k, :] from
    M(A(V[:, k])) with one classical Gram-Schmidt pass (JAX's
    `_iterative_classical_gram_schmidt` at max_iterations=2 stops after
    one)."""
    eps = torch.finfo(V.dtype).eps
    v = M(A(V[:, k]))
    _, v_norm_0 = _safe_normalize(v)
    h = V.transpose(0, 1) @ v
    v = v - V @ h
    unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
    V = V.clone()
    V[:, k + 1] = unit_v
    h = h.clone()
    h[k + 1] = v_norm_1
    H = H.clone()
    H[k, :] = h
    return V, H, v_norm_1 == 0


def _rotate(H, i, cs, sn):
    x1, y1 = H[i], H[i + 1]
    H = H.clone()
    H[i] = cs * x1 - sn * y1
    H[i + 1] = sn * x1 + cs * y1
    return H


def _givens(a, b):
    b_zero = b.abs() == 0
    a_lt_b = a.abs() < b.abs()
    t = -torch.where(a_lt_b, a, b) / torch.where(a_lt_b, b, a)
    r = torch.rsqrt(1 + t.abs() ** 2)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    cs = torch.where(b_zero, one, torch.where(a_lt_b, r * t, r))
    sn = torch.where(b_zero, zero, torch.where(a_lt_b, r, r * t))
    return cs, sn


def _gmres_start(unit_residual, restart):
    V = torch.zeros((unit_residual.shape[0], restart + 1), dtype=unit_residual.dtype,
                    device=unit_residual.device)
    V[:, 0] = unit_residual
    return V


def _gmres_end(A, M, b, x0, V, y):
    x = x0 + V[:, :-1] @ y
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def _gmres_incremental(A, M, b, x0, unit_residual, residual_norm, ptol, restart):
    """JAX's `_gmres_incremental`: Arnoldi with Givens rotations, stopping
    inside the restart once |beta[k+1]| <= ptol (frozen on the device)."""
    V = _gmres_start(unit_residual, restart)
    dt, dev = b.dtype, b.device
    R = torch.eye(restart, restart + 1, dtype=dt, device=dev)
    givens = torch.zeros((restart, 2), dtype=dt, device=dev)
    beta_vec = torch.zeros((restart + 1,), dtype=dt, device=dev)
    beta_vec[0] = residual_norm
    err = residual_norm
    active = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(restart):
        active = active & (err > ptol)
        V_, H, _ = _arnoldi(k, A, M, V, R)
        row = H[k, :]
        for i in range(k):
            row = _rotate(row, i, givens[i, 0], givens[i, 1])
        cs, sn = _givens(row[k], row[k + 1])
        g_ = givens.clone()
        g_[k, 0], g_[k, 1] = cs, sn
        row = _rotate(row, k, cs, sn)
        R_ = R.clone()
        R_[k, :] = row
        beta_ = _rotate(beta_vec, k, cs, sn)
        V, R = _freeze(active, V_, V), _freeze(active, R_, R)
        givens, beta_vec = _freeze(active, g_, givens), _freeze(active, beta_, beta_vec)
        err = _freeze(active, beta_vec[k + 1].abs(), err)
    # R[:, :-1] is lower triangular: solve its transpose (upper)
    y = torch.linalg.solve_triangular(R[:, :-1].transpose(0, 1), beta_vec[:-1, None],
                                      upper=True)[:, 0]
    return _gmres_end(A, M, b, x0, V, y)


def _gmres_batched(A, M, b, x0, unit_residual, residual_norm, ptol, restart):
    """JAX's `_gmres_batched`: the Arnoldi process to `restart` steps or a
    breakdown, then the least-squares problem by the normal equations
    (Cholesky; NaN where it fails, as XLA's)."""
    V = _gmres_start(unit_residual, restart)
    dt, dev = b.dtype, b.device
    H = torch.eye(restart, restart + 1, dtype=dt, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(restart):
        V_, H_, breakdown = _arnoldi(k, A, M, V, H)
        V, H = _freeze(active, V_, V), _freeze(active, H_, H)
        active = active & ~breakdown
    beta_vec = torch.zeros((restart + 1,), dtype=dt, device=dev)
    beta_vec[0] = residual_norm
    a2 = H @ H.transpose(0, 1)
    b2 = H @ beta_vec
    L, info = torch.linalg.cholesky_ex(a2)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    y = torch.cholesky_solve(b2[:, None], L)[:, 0]
    return _gmres_end(A, M, b, x0, V, y)


def _gmres_solve(A, M, b, x0, *, atol, ptol, restart, maxiter, gmres_func):
    """JAX's `_gmres_solve`: restarts while k < maxiter and the residual
    norm > atol, frozen on the device."""
    x = x0
    unit_residual, residual_norm = _safe_normalize(M(b - A(x0)))
    for k in range(maxiter):
        active = residual_norm > atol
        if k % _CHECK_EVERY == 0 and not bool(active):
            break
        x_, u_, n_ = gmres_func(A, M, b, x, unit_residual, residual_norm, ptol, restart)
        x, unit_residual = _freeze(active, x_, x), _freeze(active, u_, unit_residual)
        residual_norm = _freeze(active, n_, residual_norm)
    return x


def _flat(f: Callable, shape) -> Callable:
    """f on vectors flattened from `shape`: v (size,) ↦ f(v as shape), flat."""
    return lambda v: f(v.reshape(shape)).reshape(-1)


def gmres(a: Operator, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: Optional[int] = None, M: Optional[Callable] = None,
          solve_method: str = "batched", method: str = "auto"):
    """GMRES(restart) for general A. b of any shape is one vector, as in
    jax.scipy's gmres (its tree vdot): the Arnoldi loop runs on b and x0
    flattened, and the operator and M see b's shape. Returns (x, info),
    x of b's shape, info a 0-d int tensor, -1 where x is NaN, else 0."""
    if solve_method == "incremental":
        gmres_func = _gmres_incremental
    elif solve_method == "batched":
        gmres_func = _gmres_batched
    else:
        raise ValueError(f"invalid solve_method {solve_method}, must be either "
                         "'incremental' or 'batched'")
    shape = b.shape
    A = _flat(as_matvec(a, method, transposable=True), shape)
    At = _flat(_transposed_matvec(a, method), shape)
    M = _identity if M is None else _flat(M, shape)
    x0 = torch.zeros_like(b) if x0 is None else x0
    b, x0 = b.reshape(-1), x0.reshape(-1)
    size = b.numel()
    maxiter = 10 * size if maxiter is None else int(maxiter)
    restart = min(restart, size)
    with torch.no_grad():
        b_norm = torch.sqrt(_vdot(b, b))
        atol_ = torch.maximum(tol * b_norm, torch.as_tensor(atol, dtype=b_norm.dtype,
                                                           device=b.device))
        mb = M(b)
        ptol = torch.sqrt(_vdot(mb, mb)) * torch.clamp(atol_ / b_norm, max=1.0)
    kw = dict(x0=x0, atol=atol_, ptol=ptol, restart=restart, maxiter=maxiter,
              gmres_func=gmres_func)
    x = _linear_solve(b, partial(_gmres_solve, A, M, **kw), partial(_gmres_solve, At, M, **kw))
    failed = torch.isnan(torch.sqrt(_vdot(x, x)))
    return x.reshape(shape), torch.where(failed, -1, 0)


# ---------------------------------------------------------------------------
# Eigensolvers, expm_multiply, lsqr, minres
# ---------------------------------------------------------------------------


def _normal(seed: int, shape, dtype, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(device=device, dtype=dtype)


def _csr_of(a: Operator, opname: str) -> CSR:
    csr = _as_csr(a)
    if not isinstance(csr, CSR):
        raise TypeError(f"{opname} needs a sparse operand (CSR/BSR/COO/DIA)")
    return csr


def power_iteration(a: Operator, *, iters: int = 100, seed: int = 0, method: str = "auto"):
    """Dominant eigenpair estimate by power iteration: (xᵀAx, unit x)."""
    if not isinstance(a, _SPARSE):
        raise ValueError("power_iteration needs a sparse operator (for n)")
    csr = _as_csr(a)
    mv = as_matvec(a, method)
    v = _normal(seed, (csr.shape[0],), csr.dtype, csr.data.device)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = mv(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return _vdot(v, mv(v)), v


def lobpcg_topk(a: Operator, k: int = 4, *, iters: int = 100, tol: Optional[float] = None,
                oversample: int = 4, seed: int = 0, method: str = "auto"):
    """Top-k eigenpairs of symmetric A by block LOBPCG: the block of k +
    `oversample` vectors advances by Rayleigh-Ritz over [X, R, P] with one
    SpMM a step. Returns (eigenvalues (k,), eigenvectors (n, k),
    iterations run); it stops once every pair of the block has
    |A v - λ v| < tol·10·n·(λ + |A v|) (tol defaults to the dtype's eps),
    lobpcg_standard's test."""
    csr = _csr_of(a, "lobpcg_topk")
    n = csr.shape[0]
    mv = as_matvec(csr, method)
    kb = min(k + max(oversample, 0), max(n // 2 - 1, k))
    dt, dev = csr.dtype, csr.data.device
    x, _ = torch.linalg.qr(_normal(seed, (n, kb), dt, dev))
    ax = mv(x)
    theta, s = torch.linalg.eigh(x.transpose(0, 1) @ ax)
    x, ax = x @ s, ax @ s
    p = None
    it = 0
    tol = torch.finfo(dt).eps if tol is None else tol
    for it in range(1, iters + 1):
        r = ax - x * theta
        reltol = (torch.linalg.norm(ax, dim=0) + theta) * n * 10
        if bool((torch.linalg.norm(r, dim=0) < tol * reltol).all()):
            break
        basis = [x, r] if p is None else [x, r, p]
        q, _ = torch.linalg.qr(torch.cat(basis, dim=1))
        aq = mv(q)
        t, s = torch.linalg.eigh(q.transpose(0, 1) @ aq)
        sel = torch.argsort(t, descending=True)[:kb]
        s = s[:, sel]
        x_new, theta = q @ s, t[sel]
        p = x_new - x @ (x.transpose(0, 1) @ x_new)
        x, ax = x_new, aq @ s
    order = torch.argsort(theta, descending=True)[:k]
    return theta[order], x[:, order], it


def _lanczos(mv, v0, m, dt):
    """m Lanczos steps with full reorthogonalisation (two classical
    Gram-Schmidt passes a step; a zero vector after a breakdown)."""
    n = v0.shape[0]
    V = torch.zeros((m + 1, n), dtype=dt, device=v0.device)
    V[0] = v0
    alphas = torch.zeros((m,), dtype=dt, device=v0.device)
    betas = torch.zeros((m,), dtype=dt, device=v0.device)
    for j in range(m):
        v = V[j]
        w = mv(v)
        alpha = _vdot(v, w)
        w = w - alpha * v
        for _ in range(2):
            w = w - V.transpose(0, 1) @ (V @ w)
        beta = torch.linalg.norm(w)
        ok = beta > 1e-7
        V[j + 1] = torch.where(ok, w / torch.where(ok, beta, torch.ones_like(beta)),
                               torch.zeros_like(w))
        alphas[j] = alpha
        betas[j] = torch.where(ok, beta, torch.zeros_like(beta))
    return V, alphas, betas


def eigsh_lanczos(a: Operator, k: int = 6, *, which: str = "LA", iters: Optional[int] = None,
                  seed: int = 0, method: str = "auto"):
    """Top or bottom k eigenpairs of symmetric A by the Lanczos process with
    full reorthogonalisation; which: 'LA', 'SA' or 'LM'. Returns
    (eigenvalues (k,), eigenvectors (n, k)); slots past an exhausted Krylov
    space are NaN."""
    csr = _as_csr(a)
    n = csr.shape[0]
    _square(csr.shape, "eigsh needs square A")
    if which not in ("LA", "SA", "LM"):
        raise ValueError(f"unknown which {which!r} (LA/SA/LM)")
    m = min(n, iters if iters is not None else max(2 * k + 8, 24))
    if k > m:
        raise ValueError(f"k={k} needs at least k Lanczos steps, got m={m}")
    mv = as_matvec(csr, method)
    dt, dev = csr.dtype, csr.data.device
    v0 = _normal(seed, (n,), dt, dev)
    V, alphas, betas = _lanczos(mv, v0 / torch.linalg.norm(v0), m, dt)
    nzb = betas[: m - 1] > 0
    j_valid = torch.where(nzb.all(), m, torch.argmin(nzb.to(torch.int32)) + 1)
    invalid = torch.arange(m, device=dev) >= j_valid
    sentinel = {"LA": -1e30, "SA": 1e30, "LM": 0.0}[which]
    T = (torch.diag(torch.where(invalid, torch.full_like(alphas, sentinel), alphas))
         + torch.diag(betas[: m - 1], 1) + torch.diag(betas[: m - 1], -1))
    theta, s = torch.linalg.eigh(T)
    if which == "LA":
        order = torch.arange(m - 1, m - 1 - k, -1, device=dev)
    elif which == "SA":
        order = torch.arange(k, device=dev)
    else:
        order = torch.argsort(theta.abs(), descending=True)[:k]
    u = V[:m].transpose(0, 1) @ s[:, order]
    u = u / torch.clamp(torch.linalg.norm(u, dim=0, keepdim=True), min=1e-30)
    surplus = torch.arange(k, device=dev) >= j_valid
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    return torch.where(surplus, nan, theta[order]), torch.where(surplus[None, :], nan, u)


def expm_multiply(a: Operator, v: torch.Tensor, t: float = 1.0, *, krylov_dim: int = 30,
                  method: str = "auto") -> torch.Tensor:
    """exp(t·A)·v for symmetric A by the Lanczos approximation
    ‖v‖·V·exp(t·T)·e₁ over a `krylov_dim`-dimensional Krylov space."""
    csr = _as_csr(a)
    _square(csr.shape, "expm_multiply needs square A")
    m = min(int(krylov_dim), csr.shape[0])
    mv = as_matvec(csr, method)
    dt = torch.promote_types(csr.dtype, v.dtype)
    nrm = torch.linalg.norm(v)
    v0 = (v / torch.clamp(nrm, min=1e-30)).to(dt)
    V, alphas, betas = _lanczos(mv, v0, m, dt)
    T = torch.diag(alphas) + torch.diag(betas[: m - 1], 1) + torch.diag(betas[: m - 1], -1)
    evals, evecs = torch.linalg.eigh(T)
    exp_t_e1 = evecs @ (torch.exp(t * evals) * evecs[0, :])
    return (nrm * (V[:m].transpose(0, 1) @ exp_t_e1)).to(v.dtype)


def svds(a: Operator, k: int = 6, *, iters: Optional[int] = None, seed: int = 0,
         method: str = "auto"):
    """Top k singular triplets of (rectangular) sparse A by Golub-Kahan-
    Lanczos bidiagonalisation with full reorthogonalisation on both sides.
    Returns (u (m, k), s (k,) descending, vt (k, n)); NaN in the slots past
    the rank."""
    csr = _csr_of(a, "svds")
    m_rows, n_cols = csr.shape
    s_steps = min(min(m_rows, n_cols), iters if iters is not None else max(2 * k + 8, 24))
    if k > s_steps:
        raise ValueError(f"k={k} needs at least k GKL steps, got {s_steps}")
    mv = partial(ops.spmm, csr, method=method)
    mvt = partial(ops.spmm, ops.transpose_csr(csr), method=method)
    dt, dev = csr.dtype, csr.data.device
    v0 = _normal(seed, (n_cols,), dt, dev)
    U = torch.zeros((s_steps, m_rows), dtype=dt, device=dev)
    V = torch.zeros((s_steps + 1, n_cols), dtype=dt, device=dev)
    V[0] = v0 / torch.linalg.norm(v0)
    alphas = torch.zeros((s_steps,), dtype=dt, device=dev)
    betas = torch.zeros((s_steps,), dtype=dt, device=dev)
    for j in range(s_steps):
        u = mv(V[j])
        for _ in range(2):
            u = u - U.transpose(0, 1) @ (U @ u)
        alpha = torch.linalg.norm(u)
        ok_a = alpha > 1e-7
        u = torch.where(ok_a, u / torch.where(ok_a, alpha, torch.ones_like(alpha)),
                        torch.zeros_like(u))
        U[j] = u
        w = mvt(u)
        for _ in range(2):
            w = w - V.transpose(0, 1) @ (V @ w)
        beta = torch.linalg.norm(w)
        ok_b = beta > 1e-7
        V[j + 1] = torch.where(ok_b, w / torch.where(ok_b, beta, torch.ones_like(beta)),
                               torch.zeros_like(w))
        alphas[j] = torch.where(ok_a, alpha, torch.zeros_like(alpha))
        betas[j] = torch.where(ok_b, beta, torch.zeros_like(beta))
    nza = alphas > 0
    j_valid = torch.where(nza.all(), s_steps, torch.argmin(nza.to(torch.int32)))
    B = torch.diag(alphas) + torch.diag(betas[: s_steps - 1], 1)
    P, sigma, QT = torch.linalg.svd(B)
    u_out = U.transpose(0, 1) @ P[:, :k]
    v_out = V[:s_steps].transpose(0, 1) @ QT[:k, :].transpose(0, 1)
    u_out = u_out / torch.clamp(torch.linalg.norm(u_out, dim=0, keepdim=True), min=1e-30)
    v_out = v_out / torch.clamp(torch.linalg.norm(v_out, dim=0, keepdim=True), min=1e-30)
    surplus = torch.arange(k, device=dev) >= j_valid
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    return (torch.where(surplus[None, :], nan, u_out), torch.where(surplus, nan, sigma[:k]),
            torch.where(surplus[None, :], nan, v_out).transpose(0, 1))


def lsqr(a: Operator, b: torch.Tensor, *, damp: float = 0.0, iters: int = 50,
         method: str = "auto") -> torch.Tensor:
    """min ‖A x − b‖² (+ damp²‖x‖²) by Paige-Saunders LSQR, `iters` fixed
    steps (scipy's lsqr recurrence, damping included). Returns x (n,)."""
    csr = _csr_of(a, "lsqr")
    m_rows, n_cols = csr.shape
    if tuple(b.shape) != (m_rows,):
        raise ValueError(f"b must be ({m_rows},), got {tuple(b.shape)}")
    mv = partial(ops.spmm, csr, method=method)
    mvt = partial(ops.spmm, ops.transpose_csr(csr), method=method)
    dt = torch.promote_types(csr.dtype, b.dtype)
    damp = torch.as_tensor(damp, dtype=dt, device=b.device)
    eps = 1e-30
    beta1 = torch.linalg.norm(b)
    u = b.to(dt) / torch.clamp(beta1, min=eps)
    av = mvt(u)
    alpha = torch.linalg.norm(av)
    v = av / torch.clamp(alpha, min=eps)
    x = torch.zeros((n_cols,), dtype=dt, device=b.device)
    w, phibar, rhobar = v, beta1.to(dt), alpha
    for _ in range(int(iters)):
        uu = mv(v) - alpha * u
        beta = torch.linalg.norm(uu)
        u = uu / torch.clamp(beta, min=eps)
        vv = mvt(u) - beta * v
        alpha = torch.linalg.norm(vv)
        v = vv / torch.clamp(alpha, min=eps)
        rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)
        cs1 = rhobar / torch.clamp(rhobar1, min=eps)
        phibar = cs1 * phibar
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        cs = rhobar1 / torch.clamp(rho, min=eps)
        sn = beta / torch.clamp(rho, min=eps)
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        x = x + (phi / torch.clamp(rho, min=eps)) * w
        w = v - (theta / torch.clamp(rho, min=eps)) * w
    return x.to(b.dtype)


def minres(a: Operator, b: torch.Tensor, *, M: Optional[Callable] = None, iters: int = 100,
           method: str = "auto") -> torch.Tensor:
    """A x = b for symmetric (possibly indefinite) A by MINRES: a 3-term
    Lanczos recurrence and two Givens rotations a step, `iters` fixed
    steps; M an SPD preconditioner v ↦ M⁻¹v."""
    mv = as_matvec(a, method)
    if isinstance(a, _SPARSE):
        _square(_as_csr(a).shape, "minres needs square A")
    Minv = M if M is not None else _identity
    dt, dev = b.dtype, b.device
    eps = 1e-30

    def s(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    r1 = r2 = b
    y = Minv(b)
    beta = torch.sqrt(torch.clamp(_vdot(r1, y), min=0.0))
    x = w = w2 = torch.zeros_like(b)
    oldb, dbar, epsln, phibar, cs, sn = s(0.0), s(0.0), s(0.0), beta, s(-1.0), s(0.0)
    for _ in range(int(iters)):
        v = y / torch.clamp(beta, min=eps)
        yy = mv(v)
        factor = torch.where(oldb > 0, beta / torch.clamp(oldb, min=eps), s(0.0))
        yy = yy - factor * r1
        alfa = _vdot(v, yy)
        yy = yy - (alfa / torch.clamp(beta, min=eps)) * r2
        r1, r2 = r2, yy
        y = Minv(yy)
        oldb = beta
        beta = torch.sqrt(torch.clamp(_vdot(r2, y), min=0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar ** 2 + beta ** 2), min=eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
    return x


# ---------------------------------------------------------------------------
# Triangular solves, incomplete factorisations, orderings, direct solves
# ---------------------------------------------------------------------------


def _rows(a: CSR) -> np.ndarray:
    return np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a.indptr))


def spsolve_lower_triangular(a: CSR, b: torch.Tensor, *,
                             unit_diagonal: bool = False) -> torch.Tensor:
    """Exact forward substitution for lower-triangular CSR A. The strict
    lower part is padded to ELL rows as JAX's is; the rows are solved one
    dependency level at a time (all rows whose entries only reach solved
    rows at once), each row's ELL dot in slot order. Differentiable in the
    values and b."""
    n = a.shape[0]
    _square(a.shape, "triangular solve needs square A")
    rows = _rows(a)
    indices = np.asarray(a.indices).astype(np.int64)
    if (indices > rows).any():
        raise ValueError("matrix has entries above the diagonal")
    dev = b.device
    data = a.data.to(dev)
    diag_mask = indices == rows
    if not unit_diagonal:
        diag_pos = np.full(n, -1, np.int64)
        diag_pos[rows[diag_mask]] = np.flatnonzero(diag_mask)
        if (diag_pos < 0).any():
            raise ValueError("missing diagonal entry (pass unit_diagonal=True?)")
        dvals = data[torch.from_numpy(diag_pos).to(dev)]
    else:
        dvals = torch.ones((n,), dtype=a.dtype, device=dev)
    strict = np.flatnonzero(~diag_mask)
    srows = rows[strict]
    counts = np.bincount(srows, minlength=n)
    width = max(int(counts.max()) if srows.size else 0, 1)
    slot = np.arange(srows.size, dtype=np.int64) - (np.cumsum(counts) - counts)[srows]
    ell_col = np.zeros((n, width), np.int64)
    ell_pos = np.full((n, width), -1, np.int64)
    ell_col[srows, slot] = indices[strict]
    ell_pos[srows, slot] = strict
    ell_vals = (data[torch.from_numpy(np.maximum(ell_pos, 0)).to(dev)]
                * torch.from_numpy(ell_pos >= 0).to(device=dev, dtype=a.dtype))
    # dependency levels: a row's level is one past the deepest row it reads
    level = np.zeros(n, np.int64)
    for i in range(n):
        deps = indices[a.indptr[i]:a.indptr[i + 1]]
        deps = deps[deps < i]
        if deps.size:
            level[i] = level[deps].max() + 1
    dt = torch.promote_types(a.dtype, b.dtype)
    bb = b.to(dt)
    x = torch.zeros(b.shape, dtype=dt, device=dev)
    cols_t = torch.from_numpy(ell_col).to(dev)
    for lv in range(int(level.max()) + 1 if n else 0):
        sel = torch.from_numpy(np.flatnonzero(level == lv)).to(dev)
        vals = ell_vals[sel].to(dt)
        gathered = x[cols_t[sel]]
        acc = (vals * gathered).sum(1) if b.ndim == 1 else (vals[..., None] * gathered).sum(1)
        xi = (bb[sel] - acc) / (dvals[sel].to(dt) if b.ndim == 1 else dvals[sel, None].to(dt))
        x = x.index_put((sel,), xi)
    return x


def _reversed_pattern(a: CSR):
    """(indptr, indices, perm) of J·A·J (J the index reversal), sorted;
    values follow as a.data[perm]."""
    n, m = a.shape
    counts = np.diff(a.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    new_rows = n - 1 - rows
    new_cols = m - 1 - np.asarray(a.indices).astype(np.int64)
    perm = np.lexsort((new_cols, new_rows))
    new_indptr = np.concatenate([[0], np.cumsum(counts[::-1])]).astype(_INT)
    return new_indptr, new_cols[perm].astype(_INT), perm


def spsolve_upper_triangular(a: CSR, b: torch.Tensor, *,
                             unit_diagonal: bool = False) -> torch.Tensor:
    """Exact backward substitution for upper-triangular CSR A, as the
    reversal-conjugated lower solve."""
    _square(a.shape, "triangular solve needs square A")
    if (np.asarray(a.indices) < _rows(a)).any():
        raise ValueError("matrix has entries below the diagonal")
    new_indptr, new_indices, perm = _reversed_pattern(a)
    a_rev = CSR(data=a.data[torch.from_numpy(perm).to(a.data.device)], indices=new_indices,
                indptr=new_indptr, shape=a.shape)
    return spsolve_lower_triangular(a_rev, b.flip(0), unit_diagonal=unit_diagonal).flip(0)


def _ilu0_numpy(indptr, indices, v) -> int:
    """The numpy ILU(0) value pass (the native runtime's ts_ilu0 contract:
    0, or -(row + 1) on a missing diagonal or a zero pivot)."""
    n = indptr.shape[0] - 1
    pos_of = np.full(n, -1, np.int64)
    epoch = np.full(n, -1, np.int64)
    diag = np.full(n, -1, np.int64)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            pos_of[indices[p]] = p
            epoch[indices[p]] = i
        if epoch[i] != i:
            return -(i + 1)
        diag[i] = pos_of[i]
        for p in range(indptr[i], indptr[i + 1]):
            k = indices[p]
            if k >= i:
                break
            pivot = v[diag[k]]
            if pivot == 0.0:
                return -(k + 1)
            lik = v[p] / pivot
            v[p] = lik
            for q in range(diag[k] + 1, indptr[k + 1]):
                j = indices[q]
                if epoch[j] == i:
                    v[pos_of[j]] -= lik * v[q]
    return 0


def _ic0_numpy(indptr, indices, v) -> int:
    """The numpy IC(0) value pass (ts_ic0's contract)."""
    n = indptr.shape[0] - 1
    pos_of = np.full(n, -1, np.int64)
    epoch = np.full(n, -1, np.int64)
    diag = np.full(n, -1, np.int64)
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            pos_of[indices[p]] = p
            epoch[indices[p]] = i
        if epoch[i] != i:
            return -(i + 1)
        dsum = 0.0
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j >= i:
                break
            s = 0.0
            for q in range(indptr[j], diag[j]):
                k = indices[q]
                if epoch[k] == i:
                    s += v[pos_of[k]] * v[q]
            lij = (v[p] - s) / v[diag[j]]
            v[p] = lij
            dsum += lij * lij
        diag[i] = pos_of[i]
        d = v[diag[i]] - dsum
        if d <= 0.0:
            return -(i + 1)
        v[diag[i]] = np.sqrt(d)
    return 0


def _factorize(kind: str, indptr, indices, v64) -> int:
    from tpusparse_torch.runtime import native

    if native.available():
        return native.factorize_inplace(kind, indptr, indices, v64)
    return (_ilu0_numpy if kind == "ilu0" else _ic0_numpy)(indptr, indices, v64)


def _split_rows(indptr, indices, mask):
    """The CSR pattern restricted to masked entries: (indptr, positions)."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = np.flatnonzero(mask)
    counts = np.bincount(rows[keep], minlength=n)
    return np.concatenate([[0], np.cumsum(counts)]).astype(_INT), keep


def _host_values(a: CSR) -> np.ndarray:
    return np.array(_host(a.data), np.float64)


def ilu0(a: Operator) -> tuple:
    """Zero-fill incomplete LU, A ≈ L·U on A's pattern (host fp64 value
    pass, native when available). Returns (L strict lower with an implied
    unit diagonal, U upper with the diagonal), values on A's device."""
    a = _as_csr(a)
    _square(a.shape, "ilu0 needs square A")
    indptr, indices = np.asarray(a.indptr), np.asarray(a.indices)
    v = _host_values(a)
    status = _factorize("ilu0", indptr, indices, v)
    if status != 0:
        raise ValueError(f"ilu0 breakdown at row {-status - 1}: missing diagonal or zero pivot")
    lower = indices < _rows(a)
    dev = a.data.device

    def part(mask):
        ip, pos = _split_rows(indptr, indices, mask)
        return CSR(data=torch.from_numpy(v[pos]).to(device=dev, dtype=a.dtype),
                   indices=indices[pos].astype(_INT), indptr=ip, shape=a.shape)

    return part(lower), part(~lower)


def ic0(a: Operator) -> CSR:
    """Zero-fill incomplete Cholesky of an SPD matrix, L·Lᵀ ≈ A on tril(A)'s
    pattern; raises on a non-positive pivot."""
    a = _as_csr(a)
    _square(a.shape, "ic0 needs square A")
    indptr, indices = np.asarray(a.indptr), np.asarray(a.indices)
    l_indptr, l_pos = _split_rows(indptr, indices, indices <= _rows(a))
    v = _host_values(a)[l_pos]
    status = _factorize("ic0", l_indptr, indices[l_pos], v)
    if status != 0:
        raise ValueError(
            f"ic0 breakdown at row {-status - 1}: missing diagonal or "
            "non-positive pivot (is A symmetric positive definite?)")
    return CSR(data=torch.from_numpy(v).to(device=a.data.device, dtype=a.dtype),
               indices=indices[l_pos].astype(_INT), indptr=l_indptr, shape=a.shape)


def ilu_preconditioner(a: Operator) -> Callable:
    """M ≈ A⁻¹ from ILU(0): v ↦ U⁻¹ L⁻¹ v."""
    L, U = ilu0(a)

    def apply(v):
        return spsolve_upper_triangular(U, spsolve_lower_triangular(L, v, unit_diagonal=True))

    return apply


def ic_preconditioner(a: Operator) -> Callable:
    """M ≈ A⁻¹ from IC(0): v ↦ L⁻ᵀ L⁻¹ v."""
    L = ic0(a)
    Lt = ops.transpose_csr(L)

    def apply(v):
        return spsolve_upper_triangular(Lt, spsolve_lower_triangular(L, v))

    return apply


def bandwidth(a: Operator) -> int:
    """max |i - j| over the stored entries (0 for an empty matrix)."""
    a = _as_csr(a)
    if np.asarray(a.indices).size == 0:
        return 0
    return int(np.abs(_rows(a) - np.asarray(a.indices).astype(np.int64)).max())


def rcm_permutation(a: Operator, symmetric_mode: bool = False) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (scipy), scipy's convention:
    `permute_csr(a, perm, perm)` clusters the entries at the diagonal."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = _as_csr(a)
    _square(a.shape, "rcm needs square A")
    return np.asarray(reverse_cuthill_mckee(a.to_scipy(), symmetric_mode=symmetric_mode),
                      dtype=np.int64)


def tridiagonal_solve(a: Operator, b: torch.Tensor) -> torch.Tensor:
    """A x = b for tridiagonal A (offsets within {-1, 0, 1}); b (n,) or
    (n, k). JAX calls XLA's Thomas solver; the port solves the dense
    matrix built from the three diagonals by `torch.linalg.lu_factor` /
    `lu_solve` (partial pivoting), so n is bounded by an n² matrix.
    Differentiable."""
    if isinstance(a, DIA):
        d = a
    else:
        csr = _as_csr(a)
        _square(csr.shape, "tridiagonal solve needs square A")
        d = csr_to_dia(csr, max_offsets=3)
    if not set(d.offsets.tolist()) <= {-1, 0, 1}:
        raise ValueError(f"matrix is not tridiagonal (offsets {d.offsets.tolist()}); "
                         "use cg/gmres or spsolve_*_triangular")
    _square(d.shape, "tridiagonal solve needs square A")
    dense = d.to_dense().to(b.device)
    rhs = b if b.ndim == 2 else b[:, None]
    dt = torch.promote_types(dense.dtype, b.dtype)
    lu, piv = torch.linalg.lu_factor(dense.to(dt))
    x = torch.linalg.lu_solve(lu, piv, rhs.to(dt))
    return x if b.ndim == 2 else x[:, 0]


def block_jacobi_preconditioner(a: Operator, block_size: int = 32,
                                eps: float = 1e-12) -> Callable:
    """M⁻¹ ≈ blockdiag(A)⁻¹ with dense `block_size` blocks, LU-factored
    once as one batch (`torch.linalg.lu_factor`) and applied by a batched
    `lu_solve`; zero diagonal slots of a block are set to 1."""
    a = _as_csr(a)
    n = a.shape[0]
    _square(a.shape, "block jacobi needs square A")
    bs = int(block_size)
    nb = -(-n // bs)
    n_pad = nb * bs
    rows = _rows(a)
    indices = np.asarray(a.indices).astype(np.int64)
    pos = np.flatnonzero(rows // bs == indices // bs)
    blocks = np.zeros((nb, bs, bs), np.float64)
    br, bc = rows[pos], indices[pos]
    blocks[br // bs, br % bs, bc % bs] = _host_values(a)[pos]
    di = np.arange(bs)
    blocks[:, di, di] = np.where(blocks[:, di, di] == 0.0, 1.0, blocks[:, di, di])
    lu, piv = torch.linalg.lu_factor(torch.from_numpy(blocks).to(device=a.data.device,
                                                                 dtype=a.dtype))

    def apply(v):
        vv = v if v.ndim == 2 else v[:, None]
        vp = torch.nn.functional.pad(vv, (0, 0, 0, n_pad - n)).reshape(nb, bs, -1)
        out = torch.linalg.lu_solve(lu, piv, vp).reshape(n_pad, -1)[:n]
        return out if v.ndim == 2 else out[:, 0]

    return apply
