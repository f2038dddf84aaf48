"""Algebraic multigrid (smoothed aggregation) preconditioner.

Counterpart of `tpusparse/amg.py`: the strength graph, the greedy
aggregation (`runtime.native.aggregate` where it builds, else the Python
pass), the spectral-radius estimate, the level operators (`_HybridOp`,
`_RoutedCSR` through `_routed_csr`, `PackedDIA` and `DIA`), the factored
prolongator `_FactoredP`, `AMGPreconditioner` (Jacobi and Chebyshev
smoothers, `grid_complexity`, `report`), the host value algebra
(`_h_spgemm` on `runtime.native.spgemm_symbolic`, else scipy; `_h_sub`,
`_h_transpose`), the per-diagonal format router `_route_level`, and
`smoothed_aggregation_setup` / `amg_preconditioner`.

Setup runs on the host over concrete values and is deterministic: every
array of the hierarchy (level sizes and formats, offsets in plane order,
planes, dinv, agg, w, omega, rho, the adopted window plans) equals JAX's.
The arrays are pushed once to the device of A's values. The V-cycle runs
on the port's ops: the wide levels (more than 128 diagonals) on the
wide-DIA kernel (`kernels.dia`), the factored prolongators' expand and
reduce on the windowed gather and segment-sum kernels (`kernels.windowed`)
where a plan is adopted, narrow DIA levels on `ops.dia_spmm`'s unrolled
sum, and the coarse solve by `torch.linalg.lu_solve`.

The routing constants of `_route_level` (`_SCAN_STEP_S`, `_SCAN_U`,
`_DIA_KERNEL_BW`) are JAX's, fitted on a TPU v5e; they are kept so that
the hierarchy equals JAX's, and are not times of the CUDA kernels. JAX's
`calibrate` does not fit them, so neither does the port's. The router's
constants (`ops.get_cost_constants`) are JAX's too, unless a `calibrate`
fit for the card applies to a hierarchy built on it. The pytree
registrations are JAX artefacts and are not carried.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpusparse_torch import dense, ops
from tpusparse_torch.kernels.dia import PackedDIA, pack_dia_operator
from tpusparse_torch.kernels.windowed import (
    modeled_cost_s,
    windowed_gather,
    windowed_gather_plan,
    windowed_segment_plan,
    windowed_segment_sum,
    xla_index_cost_s,
)
from tpusparse_torch.linalg import Operator, _as_csr
from tpusparse_torch.plan import build_plan
from tpusparse_torch.types import CSR, DIA, _host

__all__ = ["AMGPreconditioner", "smoothed_aggregation_setup", "amg_preconditioner"]

_INT = np.int32


def _strength_graph(indptr, indices, vals, theta: float):
    """(rows, strong): the keep-mask of strong off-diagonal connections
    |a_ij| >= theta·sqrt(|a_ii a_jj|)."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag = np.zeros(n, np.float64)
    on_diag = rows == indices
    diag[rows[on_diag]] = np.abs(vals[on_diag])
    scale = np.sqrt(np.maximum(diag[rows] * diag[indices], 1e-300))
    strong = (np.abs(vals) >= theta * scale) & ~on_diag
    return rows, strong


def _aggregate(indptr, indices, rows, strong, n: int):
    """Greedy aggregation over the strength graph: roots with their strong
    neighbourhoods, then attachment to a neighbour's aggregate, then
    singletons. Returns (agg (n,) int64, n_agg); the native pass where it
    builds, which gives the same result."""
    from tpusparse_torch.runtime import native

    if native.available():
        return native.aggregate(indptr, indices, strong)
    agg = np.full(n, -1, np.int64)
    n_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        if (agg[nbrs] != -1).any():
            continue
        agg[i] = n_agg
        agg[nbrs] = n_agg
        n_agg += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl][strong[sl]]
        hit = nbrs[agg[nbrs] != -1]
        if hit.size:
            agg[i] = agg[hit[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _rho_dinv_a(a_sp, dinv: np.ndarray, iters: int = 15) -> float:
    """Power-iteration estimate of ρ(D⁻¹A) on the host in fp64."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=a_sp.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (a_sp @ v)
        nw = np.linalg.norm(w)
        if nw == 0.0:
            return 1.0
        lam = float(v @ w)
        v = w / nw
    return abs(lam)


@dataclass
class _HybridOp:
    """A level operator split as DIA (the kept diagonals) + CSR (the
    remainder, on the gather path: `spmm(method='gather')`'s product, with
    the remainder's index arrays put on the device once)."""

    dia: object  # DIA or PackedDIA
    rem: CSR
    shape: Tuple[int, int]

    def __post_init__(self):
        dev = self.rem.data.device
        self._cols = torch.from_numpy(self.rem.indices.astype(np.int64)).to(dev)
        self._rows = torch.from_numpy(self.rem.row_ids().astype(np.int64)).to(dev)

    def mv(self, x):
        dia_y = self.dia.mv(x) if isinstance(self.dia, PackedDIA) else ops.dia_spmm(self.dia, x)
        x2 = x[:, None] if x.ndim == 1 else x
        rem_y = ops._GatherSpmm.apply(self.shape[0], self.rem.data, self._cols, self._rows, x2)
        return dia_y + (rem_y[:, 0] if x.ndim == 1 else rem_y)


class _HostPattern:
    """A host CSR triple (introspection and tests)."""

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr)
        self.indices = np.asarray(indices)
        self.data = np.asarray(data)
        self.shape = tuple(shape)

    def to_dense(self):
        m, k = self.shape
        out = np.zeros((m, k), self.data.dtype)
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out


@dataclass
class _RoutedCSR:
    """A CSR applied through the executor resolved at setup:
      'blocks' -- inspector plan + packed block values (spmm_blocks);
      'gather' -- values, column indices and row ids (index_select and
                  index_add_);
      'dense'  -- the dense operand;
      'op'     -- a DIA or PackedDIA the router promoted."""

    kind: str
    shape: Tuple[int, int]
    nnz: int = 0
    plan: object = None
    host: object = None
    bv: object = None
    dense: object = None
    data: object = None
    indices: object = None
    rows: object = None
    op: object = None

    def mv(self, x):
        one_d = x.ndim == 1
        x2 = x[:, None] if one_d else x
        if self.kind == "blocks":
            y = ops.spmm_blocks(self.plan, self.bv, x2)
        elif self.kind == "dense":
            y = dense.matmul(self.dense, x2)
        elif self.kind == "op":
            y = _op_mv(self.op, x2)
        else:  # gather
            g = self.data[:, None] * x2.index_select(0, self.indices)
            y = torch.zeros((self.shape[0], x2.shape[1]), dtype=g.dtype,
                            device=x.device).index_add_(0, self.rows, g)
        return y[:, 0] if one_d else y


def _routed_csr(ip, ix, d, shape, dtype, device) -> _RoutedCSR:
    """Resolve a CSR's executor at setup with `ops._route_spmm` on a
    one-column probe, as JAX does; `ip`, `ix`, `d` are host numpy."""
    ip, ix = np.asarray(ip), np.asarray(ix)
    d = np.asarray(d).astype(dtype)
    m, k = shape
    host = _HostPattern(ip, ix, d, shape)
    csr = CSR(data=torch.from_numpy(d).to(device), indices=np.asarray(ix, np.int32),
              indptr=np.asarray(ip, np.int32), shape=shape)
    method = ops._route_spmm(csr, torch.zeros((k, 1), device=device), None)
    nnz = int(ip[-1])
    if method == "dense" and m * k * 4 <= 128e6:
        return _RoutedCSR(kind="dense", shape=shape, nnz=nnz, host=host,
                          dense=torch.from_numpy(host.to_dense()).to(device))
    if method == "dia":
        from tpusparse_torch.types import csr_to_dia

        dia = csr_to_dia(csr)
        op = pack_dia_operator(dia.data, dia.offsets, shape) if dia.offsets.size > 128 else dia
        return _RoutedCSR(kind="op", shape=shape, nnz=nnz, host=host, op=op)
    if method in ("tiled", "resident", "naive", "reference"):
        plan = build_plan(csr)
        return _RoutedCSR(kind="blocks", shape=shape, nnz=nnz, host=host, plan=plan,
                          bv=plan.pack_values(csr.data))
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ip))
    return _RoutedCSR(
        kind="gather", shape=shape, nnz=nnz, host=host, data=csr.data,
        indices=torch.from_numpy(ix.astype(np.int64)).to(device),
        rows=torch.from_numpy(rows).to(device))


def _op_mv(a, x):
    """Matvec of a level operator in any of its formats; None for a CSR
    (the caller takes ops.spmm with its method)."""
    if isinstance(a, (_HybridOp, PackedDIA, _RoutedCSR)):
        return a.mv(x)
    if isinstance(a, DIA):
        return ops.dia_spmm(a, x)
    return None


@dataclass
class _FactoredP:
    """P = (I − ω·D⁻¹A)·P_t applied in factored form:
      P·e  = t − ω·(D⁻¹A)·t            with t = w ⊙ e[agg]
      Pᵀ·r = segment_sum(w ⊙ y, agg)   with y = r − ω·(D⁻¹A)ᵀ·r
    The expand and the reduce of a 1-D vector run through their window
    plans (the windowed kernels) where setup adopted one."""

    agg: torch.Tensor
    w: torch.Tensor
    dinv_a: object
    dinv_a_t: object
    omega: float
    shape: Tuple[int, int]
    gplan: object = None
    splan: object = None

    def _expand(self, e):
        if self.gplan is not None and e.ndim == 1:
            return windowed_gather(e, self.gplan)
        return e.index_select(0, self.agg)

    def mv(self, e):
        t = (self.w if e.ndim == 1 else self.w[:, None]) * self._expand(e)
        return t - self.omega * _op_mv(self.dinv_a, t)

    def rmv(self, r):
        y = r - self.omega * _op_mv(self.dinv_a_t, r)
        y = (self.w if r.ndim == 1 else self.w[:, None]) * y
        if self.splan is not None and y.ndim == 1:
            return windowed_segment_sum(y, self.splan)
        out = torch.zeros((self.shape[1],) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
        return out.index_add_(0, self.agg, y)


@dataclass
class _Level:
    a: object                   # the level operator (DIA, PackedDIA, hybrid or routed CSR)
    dinv: torch.Tensor          # 1 / diag(A) for Jacobi smoothing
    nnz: int = 0                # structural nnz of the level's CSR
    rho: float = 0.0            # ρ(D⁻¹A) estimate (Chebyshev interval)
    p: Optional[CSR] = None     # prolongator, values on the host
    r: Optional[CSR] = None     # restriction = pᵀ, values on the host
    p_fact: Optional[_FactoredP] = None  # factored apply (DIA levels)
    p_op: Optional[_RoutedCSR] = None    # routed P apply (CSR levels)
    r_op: Optional[_RoutedCSR] = None    # routed R apply


@dataclass(eq=False)
class AMGPreconditioner:
    """v ↦ one V-cycle of smoothed-aggregation AMG applied to v ((n,) or
    (n, k)); pass as `M=` to `linalg.cg`."""

    levels: List[_Level]
    coarse_lu: Tuple[torch.Tensor, torch.Tensor]
    jacobi_omega: float
    presmooth: int
    postsmooth: int
    method: str = "auto"
    smoother: str = "jacobi"
    cheb_alpha: float = 8.0

    def _amv(self, lvl: _Level, x):
        y = _op_mv(lvl.a, x)
        return ops.spmm(lvl.a, x, method=self.method) if y is None else y

    def _smooth(self, lvl: _Level, b, x, sweeps: int):
        if sweeps <= 0:
            return x
        d = lvl.dinv if b.ndim == 1 else lvl.dinv[:, None]
        if self.smoother == "chebyshev":
            return self._chebyshev(lvl, b, x, sweeps, d)
        for _ in range(sweeps):
            x = x + self.jacobi_omega * d * (b - self._amv(lvl, x))
        return x

    def _chebyshev(self, lvl: _Level, b, x, degree: int, d):
        """Degree-`degree` Chebyshev smoother on D⁻¹A over [ρ/α, ρ] (ρ with a
        1.1 safety margin), the standard 3-term recurrence."""
        lmax = 1.1 * max(lvl.rho, 1e-12)
        lmin = lmax / self.cheb_alpha
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho_k = 1.0 / sigma
        res = d * (b - self._amv(lvl, x))
        dk = res / theta
        x = x + dk
        for _ in range(degree - 1):
            rho_next = 1.0 / (2.0 * sigma - rho_k)
            res = d * (b - self._amv(lvl, x))
            dk = rho_next * rho_k * dk + (2.0 * rho_next / delta) * res
            x = x + dk
            rho_k = rho_next
        return x

    def _cycle(self, i: int, b):
        lvl = self.levels[i]
        if lvl.p is None:  # coarsest
            lu, piv = self.coarse_lu
            flat = b if b.ndim == 2 else b[:, None]
            x = torch.linalg.lu_solve(lu, piv, flat)
            return x if b.ndim == 2 else x[:, 0]
        x = self._smooth(lvl, b, torch.zeros_like(b), self.presmooth)
        r = b - self._amv(lvl, x)
        if lvl.p_fact is not None:
            ec = self._cycle(i + 1, lvl.p_fact.rmv(r))
            x = x + lvl.p_fact.mv(ec)
        else:
            rc = lvl.r_op.mv(r) if lvl.r_op is not None else ops.spmm(lvl.r, r,
                                                                        method=self.method)
            ec = self._cycle(i + 1, rc)
            pe = lvl.p_op.mv(ec) if lvl.p_op is not None else ops.spmm(lvl.p, ec,
                                                                        method=self.method)
            x = x + pe
        return self._smooth(lvl, b, x, self.postsmooth)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, v)

    @property
    def grid_complexity(self) -> float:
        """Σ nnz(A_l) / nnz(A_0)."""
        return sum(lv.nnz for lv in self.levels) / max(self.levels[0].nnz, 1)

    def report(self) -> str:
        lines = ["AMG hierarchy (smoothed aggregation):"]
        for i, lv in enumerate(self.levels):
            if isinstance(lv.a, (DIA, PackedDIA)):
                fmt = f"dia:{lv.a.offsets.size}"
            elif isinstance(lv.a, _HybridOp):
                fmt = f"dia:{lv.a.dia.offsets.size}+csr:{lv.a.rem.nnz}"
            else:
                fmt = "csr"
            lines.append(f"  level {i}: n={lv.a.shape[0]:>8d} nnz={lv.nnz:>10d} [{fmt}]"
                         + ("  [coarse: dense LU]" if lv.p is None else ""))
        lines.append(f"  grid complexity {self.grid_complexity:.2f}, "
                     f"Jacobi omega {self.jacobi_omega:.3f}")
        return "\n".join(lines)


# ---- host value algebra over the SpGEMM schedules --------------------------


def _h_spgemm(aip, aix, ad, bip, bix, bd, m, n):
    """C = A @ B on the host: the native symbolic schedule and a bincount of
    the products, else scipy's product (the same structural pattern)."""
    from tpusparse_torch.runtime import native

    if native.available():
        res = native.spgemm_symbolic(aip, aix, bip, bix, m, n)
        if res is not None:
            c_indptr, c_indices, a_pos, b_pos, c_pos = res
            cd = np.bincount(c_pos, weights=ad[a_pos] * bd[b_pos], minlength=c_indices.shape[0])
            return c_indptr, c_indices, cd
    import scipy.sparse as ssp

    k = bip.shape[0] - 1
    c = (ssp.csr_matrix((ad, aix, aip), shape=(m, k))
         @ ssp.csr_matrix((bd, bix, bip), shape=(k, n))).tocsr()
    c.sort_indices()
    return c.indptr.astype(_INT), c.indices.astype(_INT), c.data


def _h_sub(aip, aix, ad, bip, bix, bd, m, n):
    """A - B on the host (the union pattern)."""
    ra = np.repeat(np.arange(m, dtype=np.int64), np.diff(aip))
    rb = np.repeat(np.arange(m, dtype=np.int64), np.diff(bip))
    fa = ra * n + aix.astype(np.int64)
    fb = rb * n + bix.astype(np.int64)
    uniq = np.union1d(fa, fb)
    cd = np.zeros(uniq.size, np.float64)
    np.add.at(cd, np.searchsorted(uniq, fa), ad)
    np.subtract.at(cd, np.searchsorted(uniq, fb), bd)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount((uniq // n).astype(np.int64), minlength=m), out=indptr[1:])
    return indptr.astype(_INT), (uniq % n).astype(_INT), cd


def _h_transpose(ip, ix, d, m, n):
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ip))
    perm = np.argsort(ix, kind="stable")
    t_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(ix, minlength=n), out=t_indptr[1:])
    return t_indptr.astype(_INT), rows[perm].astype(_INT), d[perm]


# JAX's TPU-fitted constants of the per-diagonal routing (tpusparse/amg.py:
# 580-582): the fixed cost of one scan step on a v5e, the scan's chunk width,
# and the effective rate of the TPU's wide-DIA kernel. Kept so that the
# hierarchy equals JAX's; not times of the CUDA kernels.
_SCAN_STEP_S = 20e-6
_SCAN_U = 32
_DIA_KERNEL_BW = 500e9


def _route_level(cur_ip, cur_ix, cur_d, n: int, dtype, device=None):
    """Per-diagonal format routing of a level operator (tpusparse/amg.py:
    585-714): keep each diagonal whose padded streaming costs less than
    gathering its entries, priced at the rate of the path it will take,
    within a 256 MB plane budget; past 128 kept diagonals the split must
    also beat the gather floor and, at n <= 8192, the block-executor
    estimate. Returns None (all CSR) or (dia_host (K, n), offsets (K,),
    remainder None or a host CSR triple). The router's constants are those
    of `device`, the hierarchy's."""
    c = ops.get_cost_constants(device)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(cur_ip))
    offs_all = cur_ix.astype(np.int64) - rows
    u, inv = np.unique(offs_all, return_inverse=True)
    cnt = np.bincount(inv, minlength=u.size)
    keep_n = cnt * c["gather_per_nnz_floor"] > n * 3 * 4.0 / c["dia_bw"]
    keep_w = cnt * c["gather_per_nnz_floor"] > n * 4.0 / _DIA_KERNEL_BW
    if int(keep_n.sum()) <= 128:
        keep = keep_n
    elif int(keep_w.sum()) > 128:
        keep = keep_w
    else:
        order = np.argsort(-cnt)
        sel = np.zeros(u.size, bool)
        sel[order[:128]] = True
        keep = keep_n & sel
    budget = (256 * 1024 * 1024) // max(n * np.dtype(dtype).itemsize, 1)
    if int(keep.sum()) > budget:
        order = np.argsort(-cnt)
        sel = np.zeros(u.size, bool)
        sel[order[:budget]] = True
        keep &= sel
    nd_kept = int(keep.sum())
    if nd_kept > 128:
        rem_nnz = float(cur_ip[-1]) - float(cnt[keep].sum())
        t_dia = nd_kept * n * 4.0 / _DIA_KERNEL_BW + rem_nnz * c["gather_per_nnz_floor"]
        alts = [float(cur_ip[-1]) * c["gather_per_nnz_floor"]]
        if n <= 8192:
            blocks = np.unique((rows // 128) * (1 + n // 128)
                               + cur_ix.astype(np.int64) // 128).size
            alts.append(blocks * c["tiled_slot_overhead"] + _SCAN_STEP_S)
        if t_dia >= min(alts):
            return None
    if not keep.any():
        return None
    kept = np.flatnonzero(keep)
    slot = np.full(u.size, -1, np.int64)
    slot[kept] = np.arange(kept.size)
    in_dia = keep[inv]
    dia_host = np.zeros((kept.size, n), dtype)
    dia_host[slot[inv[in_dia]], rows[in_dia]] = cur_d[in_dia].astype(dtype)
    dia_offs = u[kept]
    if bool(in_dia.all()):
        return dia_host, dia_offs, None
    rem_ip = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[~in_dia], minlength=n), out=rem_ip[1:])
    return dia_host, dia_offs, (rem_ip.astype(_INT), cur_ix[~in_dia].astype(_INT),
                                cur_d[~in_dia])


def _dia_op(plane: torch.Tensor, offsets: np.ndarray, n: int):
    """A square DIA level part: a PackedDIA (the wide-DIA kernel) past 128
    diagonals, else a DIA (the unrolled sum)."""
    if offsets.size > 128:
        return pack_dia_operator(plane, offsets, (n, n))
    return DIA(data=plane, offsets=offsets, shape=(n, n))


def smoothed_aggregation_setup(
    a: Operator,
    *,
    theta: float = 0.08,
    theta_decay: float = 0.5,
    max_levels: int = 10,
    coarse_size: int = 200,
    presmooth: int = 2,
    postsmooth: int = 2,
    jacobi_omega: float = 2.0 / 3.0,
    method: str = "auto",
    smoother: str = "jacobi",
    cheb_alpha: float = 8.0,
    level_dtype: str | None = None,
) -> AMGPreconditioner:
    """Build the AMG hierarchy of (near-)SPD A on the host (tpusparse/amg.py:
    717-996), on the device of A's values. θ is the strength threshold; it
    decays by `theta_decay` while a level fails to halve (down to θ·decay⁸),
    and the reached θ carries to the coarser levels. `coarse_size` is the
    dense direct-solve cutoff. level_dtype='bf16' stores the DIA planes
    (the level operators' and the factored prolongators' D⁻¹A) in bf16;
    indices, dinv, P/R values and CSR remainders stay fp32."""
    a = _as_csr(a)
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"amg needs square A, got {a.shape}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r} (jacobi/chebyshev)")
    if level_dtype not in (None, "bf16", "bfloat16"):
        raise ValueError(f"unknown level_dtype {level_dtype!r}")
    device = a.data.device
    plane_dtype = torch.bfloat16 if level_dtype else None
    host_vals = _host(a.data)
    dtype = host_vals.dtype

    def push(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    def push_plane(v):
        t = push(v)
        return t.to(plane_dtype) if plane_dtype is not None else t

    levels: List[_Level] = []
    cur_ip = np.asarray(a.indptr)
    cur_ix = np.asarray(a.indices)
    cur_d = host_vals.astype(np.float64)
    theta_eff = theta
    import scipy.sparse as ssp

    while True:
        n = cur_ip.shape[0] - 1
        dvec = np.zeros(n, np.float64)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(cur_ip))
        on_diag = rows == cur_ix
        dvec[rows[on_diag]] = cur_d[on_diag]
        if (dvec == 0).any():
            raise ValueError("amg needs a structurally present nonzero diagonal "
                             f"(first missing at row {int(np.argmin(dvec != 0))})")
        dinv = 1.0 / dvec
        split = _route_level(cur_ip, cur_ix, cur_d, n, dtype, device)
        dia_host = dia_offs = rem_host = None
        if split is None:
            a_level = _routed_csr(cur_ip, cur_ix, cur_d, (n, n), dtype, device)
        else:
            dia_host, dia_offs, rem_host = split
            dia_part = _dia_op(push_plane(dia_host), dia_offs, n)
            if rem_host is None:
                a_level = dia_part
            else:
                rem_ip, rem_ix, rem_d = rem_host
                a_level = _HybridOp(
                    dia=dia_part,
                    rem=CSR(data=push(rem_d.astype(dtype)), indices=rem_ix, indptr=rem_ip,
                            shape=(n, n)),
                    shape=(n, n))
        lvl = _Level(a=a_level, dinv=push(dinv.astype(dtype)), nnz=int(cur_ip[-1]))
        levels.append(lvl)
        if n <= coarse_size or len(levels) >= max_levels:
            break
        while True:  # decay on stall
            _, strong = _strength_graph(cur_ip, cur_ix, cur_d, theta_eff)
            agg, n_agg = _aggregate(cur_ip, cur_ix, rows, strong, n)
            if n_agg <= 0.5 * n or theta_eff <= theta * theta_decay ** 8:
                break
            theta_eff *= theta_decay
        if n_agg >= n:  # coarsening stalled even at the θ floor
            break
        sizes = np.bincount(agg, minlength=n_agg).astype(np.float64)
        pt_d = (1.0 / np.sqrt(sizes))[agg]
        pt_ip = np.arange(n + 1, dtype=_INT)
        pt_ix = agg.astype(_INT)
        a_sp = ssp.csr_matrix((cur_d, cur_ix, cur_ip), shape=(n, n))
        rho = _rho_dinv_a(a_sp, dinv)
        lvl.rho = float(rho)
        omega = (4.0 / 3.0) / max(rho, 1e-12)
        da_d = cur_d * dinv[rows]
        ap_ip, ap_ix, ap_d = _h_spgemm(cur_ip, cur_ix, da_d, pt_ip, pt_ix, pt_d, n, n_agg)
        p_ip, p_ix, p_d = _h_sub(pt_ip, pt_ix, pt_d, ap_ip, ap_ix, omega * ap_d, n, n_agg)
        r_ip, r_ix, r_d = _h_transpose(p_ip, p_ix, p_d, n, n_agg)
        if dia_host is not None:
            # DIA or hybrid level: P in factored form, D⁻¹A and its
            # transpose built on the host and pushed once each
            dinva_host = dia_host * dinv[None, :].astype(dtype)
            nd = dia_offs.size
            t_host = np.zeros_like(dinva_host)
            for d_i in range(nd - 1, -1, -1):
                off = int(dia_offs[d_i])
                t_lo, t_hi = max(0, off), min(n, n + off)
                if t_hi > t_lo:
                    t_host[nd - 1 - d_i, t_lo:t_hi] = dinva_host[d_i, t_lo - off:t_hi - off]
            dinv_a = _dia_op(push_plane(dinva_host), dia_offs, n)
            dinv_a_t = _dia_op(push_plane(t_host), np.sort(-dia_offs[::-1]), n)
            del dinva_host, t_host
            if rem_host is not None:
                rem_ip, rem_ix, rem_d = rem_host
                rem_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rem_ip))
                rda = rem_d * dinv[rem_rows]
                rt_ip, rt_ix, rt_d = _h_transpose(rem_ip, rem_ix, rda, n, n)
                dinv_a = _HybridOp(
                    dia=dinv_a,
                    rem=CSR(data=push(rda.astype(dtype)), indices=rem_ix, indptr=rem_ip,
                            shape=(n, n)),
                    shape=(n, n))
                dinv_a_t = _HybridOp(
                    dia=dinv_a_t,
                    rem=CSR(data=push(rt_d.astype(dtype)), indices=rt_ix, indptr=rt_ip,
                            shape=(n, n)),
                    shape=(n, n))
            gplan = windowed_gather_plan(agg, n_agg)
            if modeled_cost_s(gplan) > 0.67 * xla_index_cost_s(n):
                gplan = None
            splan = windowed_segment_plan(agg, n_agg, cap=16384)
            if modeled_cost_s(splan) > 0.67 * xla_index_cost_s(n):
                splan = None
            lvl.p_fact = _FactoredP(
                agg=push(agg.astype(np.int64)), w=push(pt_d.astype(dtype)), dinv_a=dinv_a,
                dinv_a_t=dinv_a_t, omega=float(omega), shape=(n, n_agg), gplan=gplan,
                splan=splan)
        else:
            lvl.p_op = _routed_csr(p_ip, p_ix, p_d, (n, n_agg), dtype, device)
            lvl.r_op = _routed_csr(r_ip, r_ix, r_d, (n_agg, n), dtype, device)
        # P and R keep their values on the host: the V-cycle applies them
        # through p_fact or p_op/r_op
        lvl.p = CSR(data=torch.from_numpy(p_d.astype(dtype)), indices=p_ix, indptr=p_ip,
                    shape=(n, n_agg))
        lvl.r = CSR(data=torch.from_numpy(r_d.astype(dtype)), indices=r_ix, indptr=r_ip,
                    shape=(n_agg, n))
        ra_ip, ra_ix, ra_d = _h_spgemm(r_ip, r_ix, r_d, cur_ip, cur_ix, cur_d, n_agg, n)
        cur_ip, cur_ix, cur_d = _h_spgemm(ra_ip, ra_ix, ra_d, p_ip, p_ix, p_d, n_agg, n_agg)
    nc = levels[-1].a.shape[0]
    rows_c = np.repeat(np.arange(nc, dtype=np.int64), np.diff(cur_ip))
    coarse64 = np.zeros((nc, nc), np.float64)
    coarse64[rows_c, cur_ix] = cur_d
    coarse_lu = torch.linalg.lu_factor(torch.from_numpy(coarse64.astype(np.float32)).to(device))
    return AMGPreconditioner(
        levels=levels, coarse_lu=coarse_lu, jacobi_omega=jacobi_omega, presmooth=presmooth,
        postsmooth=postsmooth, method=method, smoother=smoother, cheb_alpha=cheb_alpha)


def amg_preconditioner(a: Operator, **kwargs) -> Callable:
    """M ≈ A⁻¹ as one smoothed-aggregation V-cycle, for `linalg.cg`."""
    return smoothed_aggregation_setup(a, **kwargs)
