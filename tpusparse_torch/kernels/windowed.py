"""Windowed gather and segment sum: index operations through a window plan.

Counterpart of `tpusparse/kernels/windowed.py`: the host planners
`windowed_gather_plan` (l.106-145) and `windowed_segment_plan` (l.270-311)
with `_pick_window` (l.75-84) and the cost model `modeled_cost_s` and
`xla_index_cost_s` (l.59-72), whose arrays equal JAX's; the plans
`WindowedGatherPlan` (l.87-103) and `WindowedSegmentPlan` (l.253-267); and
the TPU kernels `_gather_kernel` (l.148, pallas_call l.175) and
`_segsum_kernel` (l.314, pallas_call l.348), which become the CUDA kernels
of `csrc/windowed.cu` behind `windowed_gather_kernel` and
`windowed_segsum_kernel`.

A plan splits an index map into 128-position spans, gives each span a
128-aligned start and a window of W entries, and sends the entries that
fall outside their span's window down an exception path (a COO of
positions and indices). The kernels handle the windowed part; the wrappers
apply the exceptions after the kernel with stock torch ops, as JAX applies
them with XLA outside the `pallas_call` (l.201-202, l.376-379). So both
operations are exact for any index map.

The window is chosen, and a plan adopted by its callers, from JAX's cost
model: `_CHUNK_COST_S` and `_EXC_COST_S` are the TPU-fitted constants of
that model, kept so that the port picks the same window and adopts the
same plans as JAX. They are not times of the CUDA kernels.

`windowed_gather` and `windowed_segment_sum` are the public,
differentiable entry points (l.207-243, l.383-412). As in JAX, the backward
of each is the stock operation over the original map: `index_add_` over
`idx` for the gather, indexing by `seg` for the segment sum.

A kernel wrapper given CPU tensors runs its plain PyTorch version
(`_gather_plain`, `_segsum_plain`), which repeats the kernel's arithmetic:
the gather bit for bit, the segment sum in the kernel's order (ascending
position within each segment, in fp32), so bit for bit as well. Given CUDA
tensors it launches the kernel or raises. It counts its launches
(`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from tpusparse_torch.plan import _device_copy
from tpusparse_torch.utils.config import round_up

__all__ = [
    "WindowedGatherPlan",
    "WindowedSegmentPlan",
    "windowed_gather_plan",
    "windowed_gather",
    "windowed_gather_kernel",
    "windowed_segment_plan",
    "windowed_segment_sum",
    "windowed_segsum_kernel",
    "modeled_cost_s",
    "xla_index_cost_s",
]

KERNEL = "windowed"
_SPAN = 128          # indices per span (one window each)
_BLOCK_SPANS = 8     # spans per TPU grid cell: plans pad to 1024 positions
# JAX's cost model of the TPU kernels (tpusparse/kernels/windowed.py:55-57)
_CHUNK_COST_S = 50e-9  # per span and 128-entry chunk of its window
_EXC_COST_S = 20e-9    # per exception
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LAUNCHES = {"windowed_gather": 0, "windowed_segsum": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def modeled_cost_s(plan) -> float:
    """JAX's modeled time of a windowed plan: the span sweeps plus the
    exception path; callers compare it with `xla_index_cost_s` before
    adopting a plan."""
    return (
        plan.starts.size * (plan.window // _SPAN) * _CHUNK_COST_S
        + plan.exc_pos.size * _EXC_COST_S
    )


def xla_index_cost_s(n: int) -> float:
    """JAX's modeled time of a stock gather or segment sum of n entries."""
    return n * 10e-9


def _pick_window(widths: np.ndarray, nspan: int, cap: int) -> int:
    """The window (a multiple of 128 up to `cap`) of least modeled cost:
    every span sweeps W/128 chunks, entries beyond W take the exception
    path."""
    flat = np.sort(widths.reshape(-1))
    cand = np.arange(1, max(int(cap) // _SPAN, 1) + 1) * _SPAN
    exc = flat.size - np.searchsorted(flat, cand, side="right")
    cost = nspan * (cand // _SPAN) * _CHUNK_COST_S + exc * _EXC_COST_S
    return int(cand[int(np.argmin(cost))])


@dataclass(frozen=True, eq=False)
class WindowedGatherPlan:
    """Host plan for out = table[idx] with per-span windows."""

    idx: np.ndarray         # (n,) int32 original indices (the backward's map)
    starts: np.ndarray      # (nspan,) int32, 128-aligned window starts
    rel: np.ndarray         # (nb, 8, 128) int32, idx - start (W marks pad)
    exc_pos: np.ndarray     # (ne,) int64 positions of the exceptions
    exc_idx: np.ndarray     # (ne,) int32 their table indices
    n: int                  # logical output length
    table_len: int          # logical table length
    window: int             # W, multiple of 128
    nb: int                 # 1024-position blocks of the padded map
    _on_device: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def exception_fraction(self) -> float:
        return self.exc_pos.size / max(self.n, 1)

    def tensor(self, name: str, device) -> torch.Tensor:
        """An index array of the plan, flattened, as a tensor on `device`
        (the kernel's int32 maps as int32, the exceptions' and the
        backward's as int64), copied there once and kept with the plan."""
        wide = name in ("idx", "exc_pos", "exc_idx")
        return _device_copy(self._on_device, name, getattr(self, name), device,
                            np.int64 if wide else None)


def windowed_gather_plan(idx, table_len: int, cap: int = 2048) -> WindowedGatherPlan:
    """Plan out = table[idx] (idx (n,) int, a host array).

    W = the per-128-span spread rounded up to 128, capped at `cap`, chosen
    by the cost model; entries outside their span's window become
    exceptions. A plan is always returned: callers weigh its cost
    (`modeled_cost_s`) before using it.
    """
    idx = np.asarray(idx)
    n = idx.shape[0]
    npad = round_up(max(n, 1), _SPAN * _BLOCK_SPANS)
    nspan = npad // _SPAN
    nb = nspan // _BLOCK_SPANS
    ip = np.zeros(npad, idx.dtype)
    ip[:n] = idx
    ip[n:] = idx[-1] if n else 0
    spans = ip.reshape(nspan, _SPAN).astype(np.int64)
    lo = spans.min(axis=1)
    start = np.maximum(lo - (lo % _SPAN), 0).astype(np.int64)  # 128-aligned
    rel = spans - start[:, None]
    W = _pick_window(rel + 1, nspan, cap) if n else _SPAN
    inside = rel < W
    flat_in = inside.reshape(-1)[:n]
    exc_pos = np.flatnonzero(~flat_in).astype(np.int64)
    exc_idx = idx[exc_pos].astype(np.int32)
    rel = np.where(inside, rel, W)  # pad marker: selects nothing
    return WindowedGatherPlan(
        idx=idx.astype(np.int32),
        starts=start.astype(np.int32),
        rel=rel.reshape(nb, _BLOCK_SPANS, _SPAN).astype(np.int32),
        exc_pos=exc_pos,
        exc_idx=exc_idx,
        n=n,
        table_len=int(table_len),
        window=W,
        nb=nb,
    )


@dataclass(frozen=True, eq=False)
class WindowedSegmentPlan:
    """Host plan for segment_sum(y, seg) with per-span windows of y."""

    seg: np.ndarray         # (n_in,) int32 original segment ids (the backward's map)
    starts: np.ndarray      # (nspan,) int32, 128-aligned y-window starts
    seg_masked: np.ndarray  # (n_in,) int32: segment ids, -1 on exceptions
    exc_pos: np.ndarray     # (ne,) int64 y positions of the exceptions
    exc_seg: np.ndarray     # (ne,) int32 their segment ids
    mask: np.ndarray        # (n_in,) bool: y entries handled by the kernel
    n_in: int
    num_segments: int
    window: int
    nb: int
    _on_device: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def exception_fraction(self) -> float:
        return self.exc_pos.size / max(self.n_in, 1)

    def tensor(self, name: str, device) -> torch.Tensor:
        """An index array of the plan as a tensor on `device` (`seg_masked`
        and `starts` as int32 for the kernel, the rest as int64), copied
        there once and kept with the plan."""
        wide = name in ("seg", "exc_pos", "exc_seg")
        return _device_copy(self._on_device, name, getattr(self, name), device,
                            np.int64 if wide else None)


def windowed_segment_plan(seg, num_segments: int, cap: int = 4096) -> WindowedSegmentPlan:
    """Plan segment_sum(y, seg) where each 128-segment span draws its
    contributions from a bounded window of y (seg a host array)."""
    seg = np.asarray(seg).astype(np.int64)
    n_in = seg.shape[0]
    npad = round_up(max(num_segments, 1), _SPAN * _BLOCK_SPANS)
    nspan = npad // _SPAN
    nb = nspan // _BLOCK_SPANS
    # y-window per 128-segment span: [min, max] position of contributions
    first = np.full(npad, n_in, np.int64)
    last = np.full(npad, -1, np.int64)
    np.minimum.at(first, seg, np.arange(n_in))
    np.maximum.at(last, seg, np.arange(n_in))
    f_span = first.reshape(nspan, _SPAN).min(axis=1)
    l_span = last.reshape(nspan, _SPAN).max(axis=1)
    f_span = np.where(f_span > l_span, 0, f_span)  # empty spans
    start = np.maximum(f_span - (f_span % _SPAN), 0)
    # each y entry's offset within its segment-span's window
    span_of = seg // _SPAN
    widths = np.arange(n_in) - start[span_of] + 1
    W = _pick_window(widths[widths > 0], nspan, cap) if n_in else _SPAN
    pos = np.arange(n_in)
    inside = (pos >= start[span_of]) & (pos < start[span_of] + W)
    exc_pos = np.flatnonzero(~inside).astype(np.int64)
    exc_seg = seg[exc_pos].astype(np.int32)
    return WindowedSegmentPlan(
        seg=seg.astype(np.int32),
        starts=start.astype(np.int32),
        seg_masked=np.where(inside, seg, -1).astype(np.int32),
        exc_pos=exc_pos,
        exc_seg=exc_seg,
        mask=inside,
        n_in=n_in,
        num_segments=int(num_segments),
        window=W,
        nb=nb,
    )


# ---------------------------------------------------------------------------
# The kernels' entry points and their plain versions
# ---------------------------------------------------------------------------


def windowed_gather_kernel(
    table: torch.Tensor, rel: torch.Tensor, starts: torch.Tensor, *, n: int, window: int
) -> torch.Tensor:
    """out[p] = table[starts[p // 128] + rel[p]] where 0 <= rel[p] < window
    and that index lies in the table, else 0, for p < n; summed from 0.0 in
    fp32 and cast to the table's dtype, so -0.0 comes out as +0.0.

    table: (T,) fp32, bf16 or fp16; rel: (>= n,) int32; starts:
    (>= ceil(n / 128),) int32, all on one device. Returns (n,) in the
    table's dtype."""
    _check_kernel_args(table, rel, starts, window, "table")
    if rel.numel() < n or starts.numel() * _SPAN < n:
        raise ValueError(f"rel ({rel.numel()}) or starts ({starts.numel()}) too short for n {n}")
    if table.device.type == "cpu":
        return _gather_plain(table, rel, starts, n=n, window=window)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    out = torch.empty((n,), dtype=table.dtype, device=table.device)
    if n:
        rc = _kernel_fns()["windowed_gather"](
            table.data_ptr(), rel.data_ptr(), starts.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[table.dtype], n, table.shape[0], window, table.device.index or 0,
            torch.cuda.current_stream(table.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"windowed_gather launch failed: CUDA error {rc}")
        _LAUNCHES["windowed_gather"] += 1
    return out


def windowed_segsum_kernel(
    y: torch.Tensor, seg_masked: torch.Tensor, starts: torch.Tensor, *, num_segments: int,
    window: int,
) -> torch.Tensor:
    """out[o] = sum of y[j] over j in [starts[o // 128], + window), j < n_in,
    with seg_masked[j] == o, summed from 0.0 in fp32 in ascending j and cast
    to y's dtype, for o < num_segments.

    y: (n_in,) fp32, bf16 or fp16; seg_masked: (n_in,) int32, -1 for
    entries the kernel skips; starts: (>= ceil(num_segments / 128),) int32,
    all on one device. Returns (num_segments,) in y's dtype."""
    _check_kernel_args(y, seg_masked, starts, window, "y")
    if seg_masked.numel() != y.shape[0] or starts.numel() * _SPAN < num_segments:
        raise ValueError(
            f"seg_masked ({seg_masked.numel()}) must match y ({y.shape[0]}) and starts "
            f"({starts.numel()}) cover {num_segments} segments")
    if y.device.type == "cpu":
        return _segsum_plain(y, seg_masked, starts, num_segments=num_segments, window=window)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    out = torch.empty((num_segments,), dtype=y.dtype, device=y.device)
    if num_segments:
        rc = _kernel_fns()["windowed_segsum"](
            y.data_ptr(), seg_masked.data_ptr(), starts.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[y.dtype], y.shape[0], num_segments, window, y.device.index or 0,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"windowed_segsum launch failed: CUDA error {rc}")
        _LAUNCHES["windowed_segsum"] += 1
    return out


def _check_kernel_args(x, index, starts, window, name) -> None:
    if x.ndim != 1 or index.ndim != 1 or starts.ndim != 1:
        raise ValueError(f"{name}, its index map and starts must be 1-D")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} dtype {x.dtype} not supported (float32, bfloat16, float16)")
    if index.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("the index map and starts must be int32")
    if window <= 0 or window % _SPAN:
        raise ValueError(f"window {window} must be a positive multiple of {_SPAN}")
    for t in (x, index, starts):
        if t.device != x.device:
            raise ValueError(f"{name} on {x.device} and an index array on {t.device}: "
                             "same device needed")
        if not t.is_contiguous():
            raise ValueError("the kernel's arguments must be contiguous")


@functools.cache
def _kernel_fns() -> dict:
    """The C entry points of csrc/windowed.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # x, index map, starts, out, dtype, n, length, window, device, stream
    args = [p] * 4 + [i] * 5 + [p]
    return _build.bind(KERNEL, {"windowed_gather": args, "windowed_segsum": args})


def _gather_plain(table, rel, starts, *, n, window):
    """Plain PyTorch version of the gather kernel, on the inputs' device."""
    dev = table.device
    r = rel[:n].long()
    t = starts.long().repeat_interleave(_SPAN)[:n] + r
    inside = (r >= 0) & (r < window) & (t < table.shape[0])
    vals = table[torch.where(inside, t, 0)] if table.shape[0] else torch.zeros(n, device=dev)
    acc = torch.zeros((n,), dtype=torch.float32, device=dev)
    return (acc + torch.where(inside, vals.float(), 0.0)).to(table.dtype)


def _segsum_plain(y, seg_masked, starts, *, num_segments, window):
    """Plain PyTorch version of the segment-sum kernel, on the inputs'
    device, in the kernel's order: each segment's entries in ascending
    position, added one rank at a time (the r-th entry of every segment in
    step r), from 0.0 in fp32."""
    dev = y.device
    seg = seg_masked.long()
    pos = torch.arange(y.shape[0], device=dev)
    span = torch.div(seg.clamp_min(0), _SPAN, rounding_mode="floor")
    st = starts.long()[span.clamp_max(starts.numel() - 1)]
    keep = (seg >= 0) & (seg < num_segments) & (pos >= st) & (pos < st + window)
    k_seg, order = torch.sort(seg[keep], stable=True)
    vals = y[pos[keep][order]].float()
    rank = torch.arange(k_seg.numel(), device=dev) - torch.searchsorted(k_seg, k_seg)
    acc = torch.zeros((num_segments,), dtype=torch.float32, device=dev)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        acc[k_seg[sel]] += vals[sel]  # one entry per segment: no collisions
    return acc.to(y.dtype)


# ---------------------------------------------------------------------------
# The public, differentiable operations
# ---------------------------------------------------------------------------


def gather_forward(table: torch.Tensor, plan: WindowedGatherPlan) -> torch.Tensor:
    """table[idx] through the plan's kernel, then its exceptions."""
    dev = table.device
    out = windowed_gather_kernel(table.contiguous(), plan.tensor("rel", dev),
                                 plan.tensor("starts", dev), n=plan.n, window=plan.window)
    if plan.exc_pos.size:
        out[plan.tensor("exc_pos", dev)] = table[plan.tensor("exc_idx", dev)]
    return out


def segsum_forward(y: torch.Tensor, plan: WindowedSegmentPlan) -> torch.Tensor:
    """segment_sum(y, seg) through the plan's kernel, then its exceptions,
    added in y's dtype."""
    dev = y.device
    out = windowed_segsum_kernel(y.contiguous(), plan.tensor("seg_masked", dev),
                                 plan.tensor("starts", dev), num_segments=plan.num_segments,
                                 window=plan.window)
    if plan.exc_pos.size:
        exc = torch.zeros((plan.num_segments,), dtype=y.dtype, device=dev).index_add_(
            0, plan.tensor("exc_seg", dev), y[plan.tensor("exc_pos", dev)])
        out = out + exc
    return out


class _WindowedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        return gather_forward(table, plan)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        dt = torch.zeros((plan.table_len,), dtype=g.dtype, device=g.device)
        return dt.index_add_(0, plan.tensor("idx", g.device), g), None


class _WindowedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, plan):
        ctx.plan = plan
        return segsum_forward(y, plan)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.plan.tensor("seg", g.device)], None


def windowed_gather(table: torch.Tensor, plan: WindowedGatherPlan) -> torch.Tensor:
    """out = table[idx] for the planned idx; exact for any index map.
    Differentiable in `table`: the backward is a segment sum (`index_add_`)
    over the original indices."""
    if table.ndim != 1:
        raise ValueError(f"windowed_gather takes a 1-D table, got {tuple(table.shape)}")
    if table.shape[0] != plan.table_len:
        raise ValueError(f"table length {table.shape[0]} != plan's {plan.table_len}")
    return _WindowedGather.apply(table, plan)


def windowed_segment_sum(y: torch.Tensor, plan: WindowedSegmentPlan) -> torch.Tensor:
    """segment_sum(y, seg) for the planned seg; exact for any map.
    Differentiable in `y`: the backward gathers over the original ids."""
    if y.ndim != 1 or y.shape[0] != plan.n_in:
        raise ValueError(f"y shape {tuple(y.shape)} != plan n_in {plan.n_in}")
    return _WindowedSegmentSum.apply(y, plan)
