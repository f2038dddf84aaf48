"""Wide-DIA SpMV: y = A·x for a banded operator with many diagonals.

Counterpart of `tpusparse/kernels/dia.py`: the TPU kernel `_dia_spmv_kernel`
(l.57; `_dia_spmv_jit` l.113, pallas_call l.123) becomes the CUDA kernel
`csrc/dia_spmv.cu` behind `dia_spmv_kernel`; `_pack_dia` (l.152-193),
`dia_spmv_pallas` (l.217), the differentiable `dia_spmv` (l.302),
`PackedDIA` (l.325-371) and `pack_dia_operator` (l.405) are carried.

The plane order is a contract. `_pack_dia` permutes the diagonals as JAX's
does, `np.lexsort((offsets, (offsets + lo) % 128))`: by lane remainder,
then by offset. The TPU kernel needed that order to build one shifted copy
of x per remainder; here it only fixes the summation order, so that the
sums run as JAX's do. `PackedDIA.offsets` reports the offsets in that
order, unsorted. The TPU layout (the (ndp, mq/128, 128) padding, the
m-tile, the x window and its slack) is not carried: the plane is a plain
(nd, m) tensor.

The forward runs the kernel; the backward is plain torch, as JAX's is XLA
(the VJP of `_dia_spmv_scan_ref`, l.254-299): d_data[d, i] = g[i]·x[i +
off_d] and dx the scatter-add of data·g. The pytree registration and the
jit-argument machinery of `PackedDIA` are JAX artefacts and are not
carried.

A kernel wrapper given CPU tensors runs `_dia_spmv_plain`, the plain
PyTorch version: the same products in the same order, each product and
each add rounded on its own, so the two are bitwise equal. Given CUDA
tensors it launches the kernel or raises. It counts its launches
(`launch_counts`).

The tile list (`dia_tile_list`, `DiaTiles`) has no JAX counterpart: it is
how the CUDA kernel skips the plane's padding. For each 32-row tile of the
plane it lists, in plane order, the rows whose 32 entries there are not
all ±0, and keeps those tiles' values in a compact copy (at laplace3d_64's
level 1, 24 MB beside the 268 MB plane). A `PackedDIA` builds it on the
device at its first CUDA `mv` and keeps it while its plane is the same
tensor, at the same address and shape, with the same version counter (an
in-place change gets a new list). The kernel then reads only those tiles
and stays bitwise equal to the plain version (csrc/dia_spmv.cu says why).
`dia_spmv` and `ops.dia_spmm`, which see a new plane on every call, walk
every diagonal, and so does a `PackedDIA` whose plane requires grad (a
trainer may write it through `.data`, which leaves its version counter
as it was). With a list the C entry launches two kernels: the nonfinite
check of x (`dia_nonfinite_kernel` launches it alone), then the walk; each
is counted under its own name ('dia_nonfinite', 'dia_spmv').
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["DiaTiles", "PackedDIA", "dia_nonfinite_kernel", "dia_spmv", "dia_spmv_kernel",
           "dia_tile_list", "pack_dia_operator"]

KERNEL = "dia_spmv"
_LANES = 128  # the TPU lane width that the plane order groups by
TILE_ROWS = 32  # rows of a tile of the list: one warp of the kernel
_FLAGS = 32  # the kernel's scratch: one nonfinite flag per slice of x, at most
_CHECK_SLICE = 1024  # x entries a slice of the nonfinite check holds, at least
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"dia_spmv": 0, "dia_nonfinite": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def plane_order(offsets: np.ndarray) -> np.ndarray:
    """JAX's plane order of a set of offsets (`_pack_dia`): by lane
    remainder (offset + lo) % 128, then by offset."""
    offsets = np.asarray(offsets, np.int64)
    lo = int(max(0, -offsets.min(initial=0)))
    return np.lexsort((offsets, (offsets + lo) % _LANES))


def _pack_dia(data: torch.Tensor, offsets: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
    """(plane, offsets) with the rows in plane order."""
    order = plane_order(offsets)
    if np.array_equal(order, np.arange(order.size)):
        return data, offsets
    return data[torch.from_numpy(order).to(data.device)], offsets[order]


def _offsets_tensor(offsets: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(offsets, np.int32)).to(device)


# ---------------------------------------------------------------------------
# The kernel's entry point and its plain version
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiaTiles:
    """The tile list of a (nd, m) plane: for each 32-row tile t, the plane
    rows d, ascending, whose entries data[d, 32t : 32t + 32] are not all
    ±0 (NaN and Inf count), as CSR (int32), with each entry's offset and
    its 32 values (a compact copy of the occupied tiles, the last tile
    zero-padded past m), all on the plane's device."""

    ptr: torch.Tensor   # (ceil(m / 32) + 1,) int32
    rows: torch.Tensor  # (nocc,) int32 plane rows
    offs: torch.Tensor  # (nocc,) int32 offsets[rows]
    vals: torch.Tensor  # (nocc, 32) the plane's dtype: data[rows, 32 t + lane]

    @property
    def nocc(self) -> int:
        """Occupied tiles: the (row, tile) pairs the kernel reads."""
        return int(self.rows.shape[0])


def dia_tile_list(data: torch.Tensor, offsets: torch.Tensor) -> DiaTiles:
    """The tile list of a (nd, m) plane with its (nd,) int32 offsets, built
    on the plane's device with torch ops (one read of the plane, and one
    `nonzero`, which waits for the device)."""
    nd, m = data.shape
    nfull, ntiles = m // TILE_ROWS, -(-m // TILE_ROWS)
    occ = torch.empty((ntiles, nd), dtype=torch.bool, device=data.device)
    if nfull:
        occ[:nfull] = (data[:, :nfull * TILE_ROWS].reshape(nd, nfull, TILE_ROWS) != 0).any(-1).t()
    if ntiles > nfull:
        occ[nfull] = (data[:, nfull * TILE_ROWS:] != 0).any(-1)
    ptr = torch.zeros((ntiles + 1,), dtype=torch.int64, device=data.device)
    torch.cumsum(occ.sum(1), 0, out=ptr[1:])
    tile, rows = occ.nonzero().unbind(1)  # row-major: by tile, then by plane row
    cols = tile[:, None] * TILE_ROWS + torch.arange(TILE_ROWS, device=data.device)
    vals = data[rows[:, None], cols.clamp(max=m - 1)]
    vals = torch.where(cols < m, vals, torch.zeros((), dtype=data.dtype, device=data.device))
    return DiaTiles(ptr=ptr.int(), rows=rows.int(), offs=offsets[rows].int(), vals=vals)


def dia_spmv_kernel(data: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor,
                    tiles: Optional[DiaTiles] = None) -> torch.Tensor:
    """y[i] = sum over the rows d of `data`, in their order, of data[d, i] ·
    x[i + offsets[d]] (a zero where that index is outside x), each product
    rounded to bf16 when data and x are both bf16, summed in fp32 from 0.

    data: (nd, m) fp32 or bf16; offsets: (nd,) int32; x: (k,) fp32 or bf16;
    all on one device, contiguous. `tiles`, the plane's `dia_tile_list`,
    lets the CUDA kernel read only the occupied tiles, with the same
    result; the caller keeps it in step with `data`. Returns (m,) fp32."""
    if data.ndim != 2 or offsets.ndim != 1 or x.ndim != 1:
        raise ValueError(f"dia_spmv_kernel takes (nd, m) data, (nd,) offsets and (k,) x; got "
                         f"{tuple(data.shape)}, {tuple(offsets.shape)}, {tuple(x.shape)}")
    if offsets.shape[0] != data.shape[0]:
        raise ValueError(f"offsets {tuple(offsets.shape)} != data rows {data.shape[0]}")
    if data.dtype not in _DTYPE_CODE or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"data {data.dtype} and x {x.dtype}: float32 or bfloat16 needed")
    if offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32")
    for t in (offsets, x):
        if t.device != data.device:
            raise ValueError(f"data on {data.device} and an operand on {t.device}: "
                             "same device needed")
    if not (data.is_contiguous() and offsets.is_contiguous() and x.is_contiguous()):
        raise ValueError("the kernel's arguments must be contiguous")
    if data.device.type == "cpu":
        return _dia_spmv_plain(data, offsets, x)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    nd, m = data.shape
    lists = (None,) * 5
    if tiles is not None:
        nocc = tiles.rows.shape[0]
        if (tiles.ptr.shape[0] != -(-m // TILE_ROWS) + 1 or tiles.offs.shape != (nocc,)
                or tiles.vals.shape != (nocc, TILE_ROWS)):
            raise ValueError(f"tile list of {tiles.ptr.shape[0] - 1} tiles does not fit a plane "
                             f"of {m} rows")
        for t in (tiles.ptr, tiles.rows, tiles.offs, tiles.vals):
            if t.device != data.device or not t.is_contiguous():
                raise ValueError("the tile list must be contiguous on the plane's device")
        if tiles.vals.dtype != data.dtype or any(
                t.dtype != torch.int32 for t in (tiles.ptr, tiles.rows, tiles.offs)):
            raise ValueError("the tile list must be int32, its values in the plane's dtype")
        flags = torch.empty((_FLAGS,), dtype=torch.int32, device=data.device)
        lists = (tiles.ptr.data_ptr(), tiles.rows.data_ptr(), tiles.offs.data_ptr(),
                 tiles.vals.data_ptr(), flags.data_ptr())
    y = torch.empty((m,), dtype=torch.float32, device=data.device)
    if not x.shape[0]:  # every slot is past the edge: a zero x of one gives the same products
        x = torch.zeros((1,), dtype=x.dtype, device=x.device)
    if m:
        rc = _kernel_fns()["dia_spmv"](
            data.data_ptr(), offsets.data_ptr(), x.data_ptr(), y.data_ptr(),
            _DTYPE_CODE[data.dtype], _DTYPE_CODE[x.dtype], nd, m, x.shape[0], *lists,
            data.device.index or 0, torch.cuda.current_stream(data.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"dia_spmv launch failed: CUDA error {rc}")
        _LAUNCHES["dia_spmv"] += 1
        _LAUNCHES["dia_nonfinite"] += tiles is not None
    return y


def _check_slices(k: int) -> Tuple[int, int]:
    """(slices, entries a slice) of the nonfinite check of a (k,) x, k >= 1:
    min(32, ceil(k / 1024)) slices of ceil(k / slices) entries, the last
    one short."""
    n = min(_FLAGS, -(-k // _CHECK_SLICE))
    return n, -(-k // n)


def dia_nonfinite_kernel(x: torch.Tensor) -> torch.Tensor:
    """The check `dia_spmv_kernel` runs on x before it walks a tile list,
    alone: flags[b] = 1 when slice b of x (`_check_slices`) holds a NaN or
    an Inf, else 0. x: (k,) fp32 or bf16, k >= 1, contiguous. Returns
    (slices,) int32."""
    if x.ndim != 1 or not x.shape[0]:
        raise ValueError(f"dia_nonfinite_kernel takes a non-empty (k,) x, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x {x.dtype}: float32 or bfloat16 needed")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return _nonfinite_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    flags = torch.empty((_check_slices(x.shape[0])[0],), dtype=torch.int32, device=x.device)
    rc = _kernel_fns()["dia_x_nonfinite"](
        x.data_ptr(), _DTYPE_CODE[x.dtype], x.shape[0], flags.data_ptr(), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dia_x_nonfinite launch failed: CUDA error {rc}")
    _LAUNCHES["dia_nonfinite"] += 1
    return flags


def _nonfinite_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the nonfinite check, on x's device."""
    n, per = _check_slices(x.shape[0])
    xp = torch.nn.functional.pad(x.float(), (0, n * per - x.shape[0]))
    return (~torch.isfinite(xp.view(n, per))).any(1).int()


@functools.cache
def _kernel_fns() -> dict:
    """The C entry points of csrc/dia_spmv.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # dia_spmv: data, offsets, x, y, data dtype, x dtype, nd, m, k, tile_ptr,
    # tile_rows, tile_offs, tile_vals, flags, device, stream;
    # dia_x_nonfinite: x, x dtype, k, flags, device, stream
    return _build.bind(KERNEL, {"dia_spmv": [p] * 4 + [i] * 5 + [p] * 5 + [i, p],
                                "dia_x_nonfinite": [p, i, i, p, i, p]})


def _padded(x: torch.Tensor, offsets: np.ndarray, m: int) -> Tuple[torch.Tensor, int]:
    """(x zero-padded so that every x[i + off] of the plane is in range, lo):
    xp[lo + j] = x[j]."""
    lo = int(max(0, -offsets.min(initial=0)))
    hi = int(max(0, offsets.max(initial=0) + m - x.shape[0]))
    return torch.nn.functional.pad(x, (lo, hi)), lo


def _dia_spmv_plain(data: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the inputs' device: the
    products of one diagonal at a time, added to an fp32 sum from 0 in the
    plane's row order."""
    offs = offsets.cpu().numpy().astype(np.int64)
    nd, m = data.shape
    acc = torch.zeros((m,), dtype=torch.float32, device=data.device)
    if nd == 0:
        return acc
    xp, lo = _padded(x, offs, m)
    for d in range(nd):
        s = lo + int(offs[d])
        acc = acc + (data[d] * xp[s:s + m]).float()
    return acc


# ---------------------------------------------------------------------------
# The differentiable product
# ---------------------------------------------------------------------------


def _dia_spmv_grads(needs, data, offsets: np.ndarray, x, g):
    """(d_data, dx) of y = A·x: d_data[d, i] = g[i]·x[i + off_d] (0 past the
    edge), dx = the scatter-add of data[d, i]·g[i] into x[i + off_d]."""
    nd, m = data.shape
    xp, lo = _padded(x, offsets, m)
    pos = torch.from_numpy(lo + offsets[:, None] + np.arange(m, dtype=np.int64)[None, :]).to(
        data.device)
    g = g.float()
    d_data = dx = None
    if needs[0]:
        d_data = (g[None, :] * xp[pos].float()).to(data.dtype)
    if needs[1]:
        dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
        dxp.index_add_(0, pos.reshape(-1), (data.float() * g[None, :]).reshape(-1))
        dx = dxp[lo:lo + x.shape[0]].to(x.dtype)
    return d_data, dx


class _DiaSpmv(torch.autograd.Function):
    """y = A·x on the kernel (the plane in `offsets`' row order); backward
    in plain torch."""

    @staticmethod
    def forward(ctx, data, offsets, offs_dev, x, tiles=None):
        ctx.offsets = offsets
        ctx.save_for_backward(data, x)
        return dia_spmv_kernel(data.contiguous(), offs_dev, x.contiguous(), tiles)

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        d_data, dx = _dia_spmv_grads(
            (ctx.needs_input_grad[0], ctx.needs_input_grad[3]), data, ctx.offsets, x, g)
        return d_data, None, None, dx, None


def dia_spmv(data: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a DIA plane (data (nd, m), host offsets (nd,) in any
    order) and x (k,): the plane is permuted to JAX's plane order and the
    kernel sums in it. Returns (m,) fp32; differentiable in data and x."""
    offsets = np.asarray(offsets).astype(np.int64)
    if offsets.ndim != 1 or offsets.shape[0] != data.shape[0]:
        raise ValueError(f"offsets {offsets.shape} != data rows {data.shape[0]}")
    if x.ndim != 1:
        raise ValueError(f"dia_spmv takes a 1-D x, got {tuple(x.shape)}")
    plane, offs = _pack_dia(data, offsets)
    return _DiaSpmv.apply(plane, offs, _offsets_tensor(offs, data.device), x)


class PackedDIA:
    """A wide-DIA matvec operator stored once in plane order.

    data: the (nd, m) plane, its rows in JAX's plane order; `offsets` the
    offsets of those rows (unsorted); `shape` the operator's (m, k). Same
    value convention as `types.DIA`.

    On the card `mv` walks the plane's tile list (`tiles`), which keeps a
    copy of the occupied tiles' values and is rebuilt only when the plane's
    identity, address, shape or version counter changes. A write that
    leaves the counter as it was (through `.data`, DLPack or a raw pointer)
    needs `drop_tiles()` before the next `mv`. A plane that requires grad
    or is an inference tensor gets no list: `mv` walks every diagonal."""

    def __init__(self, data: torch.Tensor, offsets, shape):
        self.data = data
        self.offsets_t = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)
        self._offs_dev = {}
        self._tiles = None  # (the plane, its data_ptr, shape, version), DiaTiles
        # made once, not on every matvec: a wide plane has thousands of offsets
        self._offsets = np.asarray(self.offsets_t, np.int64)
        self._offsets.setflags(write=False)

    @property
    def offsets(self) -> np.ndarray:
        """The offsets in plane order (read-only)."""
        return self._offsets

    @property
    def dtype(self):
        return self.data.dtype

    def unpack_data(self) -> torch.Tensor:
        """The (nd, m) plane, rows in plane order."""
        return self.data

    def _offsets_on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._offs_dev.get(key)
        if t is None:
            t = self._offs_dev[key] = _offsets_tensor(self.offsets, device)
        return t

    def tiles(self) -> Optional[DiaTiles]:
        """The plane's tile list, built at the first call and rebuilt when
        `data` is another tensor, moved, reshaped or changed in place. None
        for an inference tensor, which keeps no version counter, and for a
        plane that requires grad, whose optimiser may write it through
        `.data`: the kernel then walks every diagonal."""
        data = self.data
        if data.is_inference() or data.requires_grad:
            return None
        key = (data.data_ptr(), tuple(data.shape), data._version)
        if self._tiles is None or self._tiles[0][0] is not data or self._tiles[0][1:] != key:
            self._tiles = ((data, *key), dia_tile_list(data, self._offsets_on(data.device)))
        return self._tiles[1]

    def drop_tiles(self) -> None:
        """Forget the tile list: the next `mv` builds it anew from the plane
        (after a write that left the plane's version counter as it was)."""
        self._tiles = None

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            if x.shape[0] != self.shape[1]:
                raise ValueError(f"x shape {tuple(x.shape)} incompatible with {self.shape}")
            dev = self.data.device
            tiles = self.tiles() if dev.type == "cuda" else None
            return _DiaSpmv.apply(self.data, self.offsets, self._offsets_on(dev), x, tiles)
        # multivector: the chunked-scan SpMM of ops.dia_spmm on the plane
        # re-sorted by offset (types.DIA wants sorted offsets)
        from tpusparse_torch import ops
        from tpusparse_torch.types import DIA

        offs = self.offsets
        order = np.argsort(offs)
        data = self.data[torch.from_numpy(order).to(self.data.device)]
        return ops.dia_spmm(DIA(data=data, offsets=offs[order], shape=self.shape), x)

    def __call__(self, x):
        return self.mv(x)


def pack_dia_operator(data: torch.Tensor, offsets, shape) -> PackedDIA:
    """A PackedDIA from a (nd, m) plane and its offsets (in the plane's row
    order, sorted or not); `shape` is the operator's (m, k)."""
    plane, offs = _pack_dia(data, np.asarray(offsets, np.int64))
    return PackedDIA(plane, offs, shape)
