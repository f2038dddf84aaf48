"""SpGEMM: C = A @ B with both operands sparse (CSR) and a sparse result.

Counterpart of `tpusparse/spgemm.py`. A host symbolic pass (the native
inspector `runtime/native.py` where it is built, else numpy; cached by the
pair of pattern fingerprints) computes C's CSR pattern and a flat
multiplication schedule: (a_pos, b_pos, c_pos) triples that enumerate every
scalar product A[i, k]·B[k, j] and the C slot it adds into, sorted by c_pos.
The numeric pass on the device is two gathers, one multiply and one sorted
segment sum.

Sorting by c_pos makes three of those index operations local enough for a
window plan (`kernels/windowed.py`): the accumulation into C's slots, the
gather of A's values and, in the backward, the gather of dC. At schedule
time `_windowed_schedule_plans` adopts a plan for each where JAX's rule
does (l.137-194); past the residency budget the accumulation is split at
segment boundaries into several plans (`_chunk_segment_plans`, l.197-228).
An adopted plan runs on the CUDA kernels of `csrc/windowed.cu`; the rest
takes the stock torch ops. The adoption constants, the residency budget and
the router's constants are JAX's, kept so that the port adopts the same
plans and routes as JAX does; they are constants of a cost model fitted on
a TPU, not times of this port, and the CUDA kernels have no residency
limit.

C keeps one slot per structurally reachable (i, j), as scipy does: a
product that cancels to 0.0 keeps its slot, so the pattern never depends on
the values. `spgemm` is differentiable in both operands' values, with
gradients restricted to each operand's pattern:
dA[p] = sum over the products with a_pos == p of dC[c_pos]·B[b_pos], and
dB[q] likewise with A[a_pos].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from tpusparse_torch.elementwise import _host_pattern, _pair_key
from tpusparse_torch.kernels.windowed import (
    gather_forward,
    modeled_cost_s,
    segsum_forward,
    windowed_gather_plan,
    windowed_segment_plan,
    xla_index_cost_s,
)
from tpusparse_torch.plan import _device_copy
from tpusparse_torch.types import CSR, Shape2

_INT = np.int32

# JAX's residency test of a windowed plan: half of its `vmem_limit_bytes`
# (tpusparse/utils/config.py:44, 64 MiB), a TPU budget that decides where
# JAX adopts a plan and where it chunks the accumulation. The CUDA kernels
# have no such limit; the port keeps the budget so that it adopts JAX's plans.
_RESIDENT_BUDGET = 64 * 1024 * 1024 // 2
# past this many products JAX adopts no windowed plan (spgemm.py:157)
_MAX_WINDOWED_PRODUCTS = 10_000_000
# a plan is adopted where its modeled cost is at most this share of the
# stock operation's (spgemm.py:161-181)
_ADOPT_SHARE = 0.67
# products per chunk of a chunked accumulation (spgemm.py:197)
_CHUNK_TARGET = 2_000_000

# JAX's cost model of the SpGEMM routes (tpusparse/spgemm.py:416-438 and
# the `_COST_DEFAULTS` of tpusparse/ops.py:967-991), fitted on a TPU; kept
# so that 'auto' routes as JAX does. ROADMAP queue 1, item 7 (`calibrate`)
# refits them on the card.
_SCHEDULE_MULTS_PER_S = 430e6
_GATHER_PER_ELEM = 6.7e-9
_DENSE_FP32_FLOPS = 43e12
_DENSIFY_PER_NNZ = 9e-9


@dataclass(frozen=True)
class SpGEMMPlan:
    """Host-built multiplication schedule for one (A pattern, B pattern)
    pair. ``nmul`` is the schedule length: the sum over A's nonzeros (i, k)
    of the nonzeros in B's row k."""

    a_pos: np.ndarray      # (nmul,) int32: index into A.data
    b_pos: np.ndarray      # (nmul,) int32: index into B.data
    c_pos: np.ndarray      # (nmul,) int32: index into C.data, nondecreasing
    c_indices: np.ndarray  # (c_nnz,) int32: C's CSR column ids
    c_indptr: np.ndarray   # (m+1,) int32: C's CSR row offsets
    a_shape: Shape2
    b_shape: Shape2
    # windowed plans (kernels/windowed.py), adopted at schedule time by
    # JAX's rule; None = that operation takes the stock torch op
    ws_c: object = None   # WindowedSegmentPlan for the c_pos accumulation
    wg_a: object = None   # WindowedGatherPlan for a_data[a_pos]
    wg_b: object = None   # WindowedGatherPlan for b_data[b_pos]
    wg_c: object = None   # WindowedGatherPlan for g[c_pos] (backward)
    # the accumulation split at segment boundaries where one plan does not
    # fit the residency budget: tuples (lo, hi, seg_base, nseg, plan) whose
    # outputs concatenate
    ws_c_chunks: object = None
    _on_device: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def nmul(self) -> int:
        return int(self.a_pos.shape[0])

    @property
    def c_nnz(self) -> int:
        return int(self.c_indices.shape[0])

    @property
    def c_shape(self) -> Shape2:
        return (self.a_shape[0], self.b_shape[1])

    def tensor(self, name: str, device) -> torch.Tensor:
        """`a_pos`, `b_pos` or `c_pos` as an int64 tensor on `device`,
        copied there once and kept with the plan."""
        return _device_copy(self._on_device, name, getattr(self, name), device, np.int64)

    def report(self) -> dict:
        """Schedule statistics: work per output nonzero and the compression
        the sparse product achieves over a densified one."""
        m, k = self.a_shape
        n = self.b_shape[1]
        dense_mults = float(m) * k * n
        return {
            "nmul": self.nmul,
            "c_nnz": self.c_nnz,
            "mults_per_c_nnz": self.nmul / max(self.c_nnz, 1),
            "c_density": self.c_nnz / float(m * n),
            "dense_mult_ratio": dense_mults / max(self.nmul, 1),
            "schedule_bytes": 3 * 4 * self.nmul,
        }


_PLAN_CACHE: dict = {}


def _windowed_schedule_plans(a_pos, b_pos, c_pos, a_nnz, b_nnz, c_nnz):
    """The windowed plans of the schedule's index operations, each adopted
    only where its modeled cost beats the stock operation's decisively and
    its arrays fit JAX's residency budget: (ws_c, wg_a, wg_b, wg_c,
    ws_c_chunks)."""
    nmul = int(np.asarray(a_pos).shape[0])
    if nmul > _MAX_WINDOWED_PRODUCTS:
        return None, None, None, None, None

    def gather(idx, table_len):
        p = windowed_gather_plan(np.asarray(idx), table_len)
        fits = (table_len + p.window + 256) * 4 + 8 * p.window * 4 <= _RESIDENT_BUDGET
        if fits and modeled_cost_s(p) <= _ADOPT_SHARE * xla_index_cost_s(nmul):
            return p
        return None

    def segment(seg, num_segments):
        seg = np.asarray(seg)
        n_in = int(seg.shape[0])
        p = windowed_segment_plan(seg, num_segments)
        if _seg_fits(p, n_in) and (
            modeled_cost_s(p) <= _ADOPT_SHARE * xla_index_cost_s(n_in)
        ):
            return p, None
        if not _seg_fits(p, n_in):
            chunks = _chunk_segment_plans(seg, num_segments, _seg_fits)
            if chunks is not None and (
                sum(modeled_cost_s(c[4]) for c in chunks)
                <= _ADOPT_SHARE * xla_index_cost_s(n_in)
            ):
                return None, tuple(chunks)
        return None, None

    ws_c, ws_chunks = segment(c_pos, c_nnz)
    return (
        ws_c,
        gather(a_pos, a_nnz),
        gather(b_pos, b_nnz),
        gather(c_pos, c_nnz),
        ws_chunks,
    )


def _seg_fits(p, n_in) -> bool:
    """JAX's residency test of a segment plan (spgemm.py:166-167)."""
    return 2 * (n_in + p.window + 256) * 4 + 16 * p.window * 4 <= _RESIDENT_BUDGET


def _chunk_segment_plans(seg, num_segments, seg_fits, target=_CHUNK_TARGET):
    """Split a SORTED segment map at segment boundaries into chunks of about
    `target` entries, one windowed plan each. Chunk i covers segment ids
    [base_i, base_{i+1}); empty ids inside a chunk's range sum to zero in
    its kernel, so concatenating the chunk outputs gives the whole segment
    sum. Returns [(lo, hi, base, nseg, plan)], or None if a chunk still
    does not fit (one segment larger than the budget)."""
    n_in = int(seg.shape[0])
    nchunk = -(-n_in // target)
    if nchunk <= 1:
        return None
    cuts = [0]
    for i in range(1, nchunk):
        pos = i * n_in // nchunk
        pos = int(np.searchsorted(seg, seg[pos], side="right"))
        cuts.append(min(pos, n_in))
    cuts.append(n_in)
    cuts = sorted(set(cuts))
    bases = [0] + [int(seg[lo]) for lo in cuts[1:-1]] + [int(num_segments)]
    chunks = []
    for (lo, hi), (b0, b1) in zip(zip(cuts[:-1], cuts[1:]), zip(bases[:-1], bases[1:])):
        if lo >= hi:
            return None  # degenerate cut (one huge segment)
        p = windowed_segment_plan(seg[lo:hi] - b0, b1 - b0)
        if not seg_fits(p, hi - lo):
            return None
        chunks.append((lo, hi, b0, b1 - b0, p))
    return chunks


def _check_shapes(a: CSR, b: CSR) -> None:
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"spgemm shape mismatch: {a.shape} @ {b.shape} "
            f"(need a.shape[1] == b.shape[0])"
        )


def _symbolic_numpy(a_indptr, a_indices, b_indptr, b_indices, m, n):
    """The numpy symbolic pass: (c_indptr, c_indices, a_pos, b_pos, c_pos),
    equal to the native pass's arrays."""
    a_nnz = int(a_indices.shape[0])
    b_deg = np.diff(b_indptr.astype(np.int64))  # nnz per B row
    per_a = b_deg[a_indices]  # products spawned by each A nonzero
    nmul = int(per_a.sum())
    if nmul >= np.iinfo(_INT).max:
        raise ValueError(f"spgemm schedule has {nmul} products: exceeds int32 indexing")
    # a_pos: each A nonzero repeated by its product count
    a_pos = np.repeat(np.arange(a_nnz, dtype=np.int64), per_a)
    # b_pos: for A nonzero p with column k, the run b_indptr[k] : b_indptr[k+1]
    first = np.cumsum(per_a) - per_a  # schedule offset of each A nonzero
    offs = np.arange(nmul, dtype=np.int64) - np.repeat(first, per_a)
    b_pos = np.repeat(b_indptr[a_indices].astype(np.int64), per_a) + offs
    # C coordinates of each product
    a_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a_indptr))
    flat = a_rows[a_pos] * np.int64(n) + b_indices[b_pos]
    uniq, inv = np.unique(flat, return_inverse=True)  # sorted == CSR order
    # the schedule sorted by destination slot: the accumulation is a sorted
    # segment sum
    order = np.argsort(inv, kind="stable")
    c_indptr = np.zeros(m + 1, dtype=_INT)
    c_indptr[1:] = np.cumsum(np.bincount((uniq // n).astype(np.int64), minlength=m))
    return (c_indptr, (uniq % n).astype(_INT), a_pos[order].astype(_INT),
            b_pos[order].astype(_INT), inv.reshape(-1)[order].astype(_INT))


def spgemm_plan(a: CSR, b: CSR) -> SpGEMMPlan:
    """Build (or fetch from the cache) the multiplication schedule of A @ B.

    Host-only; cached by the pair of pattern fingerprints, never by object
    identity. Takes the native symbolic pass where the library is built and
    the numpy one otherwise; both give the same schedule.
    """
    from tpusparse_torch.runtime import native

    _check_shapes(a, b)
    a_indptr, a_indices = _host_pattern(a, "spgemm")
    b_indptr, b_indices = _host_pattern(b, "spgemm")
    key = _pair_key(a, b, "spgemm")
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    m, n = a.shape[0], b.shape[1]
    if native.available():
        res = native.spgemm_symbolic(a_indptr, a_indices, b_indptr, b_indices, m, n)
        if res is None:
            raise ValueError(
                f"spgemm schedule exceeds int32 indexing (shapes {a.shape} @ {b.shape})"
            )
    else:
        res = _symbolic_numpy(a_indptr, a_indices, b_indptr, b_indices, m, n)
    c_indptr, c_indices, a_pos, b_pos, c_pos = res
    ws_c, wg_a, wg_b, wg_c, ws_cc = _windowed_schedule_plans(
        a_pos, b_pos, c_pos, int(a_indices.shape[0]), int(b_indices.shape[0]),
        int(c_indices.shape[0]),
    )
    plan = SpGEMMPlan(
        a_pos=a_pos, b_pos=b_pos, c_pos=c_pos, c_indices=c_indices, c_indptr=c_indptr,
        a_shape=tuple(a.shape), b_shape=tuple(b.shape),
        ws_c=ws_c, wg_a=wg_a, wg_b=wg_b, wg_c=wg_c, ws_c_chunks=ws_cc,
    )
    _PLAN_CACHE[key] = plan
    return plan


def _gather(x: torch.Tensor, plan: SpGEMMPlan, wplan, name: str) -> torch.Tensor:
    """x[plan.<name>]: through its windowed kernel where the plan adopted
    one, else by indexing."""
    if wplan is not None:
        return gather_forward(x, wplan)
    return x[plan.tensor(name, x.device)]


def _accumulate(prods: torch.Tensor, plan: SpGEMMPlan) -> torch.Tensor:
    """segment_sum(prods, c_pos): whole, chunked or stock."""
    if plan.ws_c is not None:
        return segsum_forward(prods, plan.ws_c)
    if plan.ws_c_chunks is not None:
        return torch.cat([segsum_forward(prods[lo:hi], p)
                          for (lo, hi, _base, _nseg, p) in plan.ws_c_chunks])
    out = torch.zeros((plan.c_nnz,), dtype=prods.dtype, device=prods.device)
    return out.index_add_(0, plan.tensor("c_pos", prods.device), prods)


class _SpGEMMData(torch.autograd.Function):
    """C's values from A's and B's (the value pass, spgemm.py:341-410)."""

    @staticmethod
    def forward(ctx, plan, a_data, b_data):
        ctx.plan = plan
        ctx.save_for_backward(a_data, b_data)
        av = _gather(a_data, plan, plan.wg_a, "a_pos")
        bv = _gather(b_data, plan, plan.wg_b, "b_pos")
        return _accumulate(av * bv, plan)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        a_data, b_data = ctx.saved_tensors
        g = g.contiguous()
        gm = _gather(g, plan, plan.wg_c, "c_pos")
        av = _gather(a_data, plan, plan.wg_a, "a_pos")
        bv = _gather(b_data, plan, plan.wg_b, "b_pos")
        # scatter-adds: a_pos and b_pos are unsorted after the c_pos sort
        da = torch.zeros_like(a_data).index_add_(
            0, plan.tensor("a_pos", g.device), (gm * bv).to(a_data.dtype))
        db = torch.zeros_like(b_data).index_add_(
            0, plan.tensor("b_pos", g.device), (gm * av).to(b_data.dtype))
        return None, da, db


def _spgemm_data(plan: SpGEMMPlan, a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
    return _SpGEMMData.apply(plan, a_data, b_data)


def _count_products(a: CSR, b: CSR) -> int:
    """nmul without building the schedule (a cheap host pass)."""
    b_deg = np.diff(np.asarray(b.indptr).astype(np.int64))
    return int(b_deg[np.asarray(a.indices)].sum())


def _route_spgemm(a: CSR, b: CSR) -> str:
    """'schedule' or 'dense', by JAX's cost model (spgemm.py:441-463)."""
    nmul = _count_products(a, b)
    m, k = a.shape
    n = b.shape[1]
    t_sched = nmul / _SCHEDULE_MULTS_PER_S
    # c_nnz is unknown before the pattern build; nmul bounds it from above
    # and is tight where the dense route competes (few collisions)
    c_nnz_bound = min(nmul, m * n)
    t_dense = (
        2.0 * m * k * n / _DENSE_FP32_FLOPS
        + (a.nnz + b.nnz) * _DENSIFY_PER_NNZ
        + c_nnz_bound * _GATHER_PER_ELEM
    )
    return "schedule" if t_sched <= t_dense else "dense"


_PATTERN_CACHE: dict = {}


def _c_pattern(a: CSR, b: CSR):
    """C's CSR pattern only, for the dense route: (indices, indptr, rows),
    by scipy's boolean product, cached by the pair of fingerprints."""
    key = _pair_key(a, b, "spgemm")
    hit = _PATTERN_CACHE.get(key)
    if hit is not None:
        return hit
    import scipy.sparse as ssp

    (ap, ai), (bp, bi) = _host_pattern(a, "spgemm"), _host_pattern(b, "spgemm")
    sa = ssp.csr_matrix((np.ones(ai.size, np.int8), ai, ap), shape=a.shape)
    sb = ssp.csr_matrix((np.ones(bi.size, np.int8), bi, bp), shape=b.shape)
    pat = (sa.astype(bool) @ sb.astype(bool)).tocsr()
    pat.sort_indices()
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(pat.indptr))
    hit = (pat.indices.astype(_INT), pat.indptr.astype(_INT), rows.astype(_INT))
    _PATTERN_CACHE[key] = hit
    return hit


def spgemm(a: CSR, b: CSR, plan: SpGEMMPlan | None = None, method: str = "auto") -> CSR:
    """Sparse × sparse product: C = A @ B as a CSR, on the values' device.

    methods: 'schedule' (the host-planned gathers and sorted segment sum,
    on the windowed kernels where the plan adopted them), 'dense' (densify
    both operands, one dense product, gather C's structural slots) and
    'auto' (JAX's cost model picks one). Every method is differentiable in
    both operands' values and gives the same structural pattern. Passing
    ``plan`` forces 'schedule'.
    """
    _check_shapes(a, b)
    if plan is not None:
        method = "schedule"
    elif method == "auto":
        method = _route_spgemm(a, b)
    if method == "dense":
        from tpusparse_torch import dense

        c_indices, c_indptr, c_rows = _c_pattern(a, b)
        cd = dense.matmul(a.to_dense(), b.to_dense())
        n = b.shape[1]
        flat = c_rows.astype(np.int64) * n + c_indices.astype(np.int64)
        c_data = cd.reshape(-1)[torch.from_numpy(flat).to(cd.device)]
        return CSR(data=c_data, indices=c_indices, indptr=c_indptr, shape=(a.shape[0], n))
    if method != "schedule":
        raise ValueError(f"unknown spgemm method {method!r}")
    plan = plan or spgemm_plan(a, b)
    if plan.a_shape != tuple(a.shape) or plan.b_shape != tuple(b.shape):
        raise ValueError(
            f"plan built for {plan.a_shape} @ {plan.b_shape}, got {a.shape} @ {b.shape}"
        )
    c_data = _spgemm_data(plan, a.data, b.data)
    return CSR(data=c_data, indices=plan.c_indices, indptr=plan.c_indptr, shape=plan.c_shape)


def spgemm_reference(a: CSR, b: CSR) -> np.ndarray:
    """Host float64 oracle: the dense product of the two operands."""
    ad = a.to_dense().detach().cpu().numpy().astype(np.float64)
    bd = b.to_dense().detach().cpu().numpy().astype(np.float64)
    return ad @ bd
