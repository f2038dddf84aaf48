"""Block-ELL SpMM executor: C = A @ B with A given by (Plan, packed values).

Counterpart of `tpusparse/kernels/tiled_spmm.py:43-403`. The two TPU
kernels there, `_executor_kernel` (behind `tiled_spmm_pallas`) and
`_resident_kernel` (behind `resident_spmm_pallas`), become one CUDA kernel,
`csrc/block_ell_spmm.cu`. Both entry points below launch it, so they give
bitwise-equal output, as the JAX pair does (tiled_spmm.py:286-288).

Precision contract (the port of `tpusparse/kernels/mxu.py:28-103`):
'high' and 'highest' are fp32-class, never plain TF32 (3xTF32 on the tensor
cores in `block_ell_spmm.cuh`'s body, fp32 FFMA in the grouped and
footprint executors);
'default' rounds both operands to bf16 (round to nearest even) and sums in
fp32. The TPU's 3-pass bf16 split is a workaround for its matrix unit and
is not ported; 3xTF32 is the H100's counterpart.

The int8 executors of the serving tier (`tiled_spmm.py:643-1019`,
`_resident_int8_kernel` behind `resident_spmm_int8_pallas` and
`_tiled_int8_kernel` behind `tiled_spmm_int8_pallas`) become one CUDA
kernel too, `csrc/block_ell_spmm_int8.cu`, behind
`resident_spmm_int8_kernel` and `tiled_spmm_int8_kernel`: bitwise equal, as
the JAX pair is. Their contract: C = (Σ_l s_a[l] · float(Qa[l] @ Qb[col_l]))
∘ t, int8 operands, an exact int32 product per slot, the fp32 sum in slot
order. The s8 tensor cores read B K-major, so each call first writes b_q
(k, n) as bt (n, ldt), zero-padded along k, with a kernel of its own
(`int8_kmajor_kernel`, counted as 'int8_kmajor'); `quantize_columns` keeps
JAX's (k, n) layout. The TPU's VMEM fit check (`resident_int8_vmem_bytes`)
has no counterpart, as for the float executor.

The batched executor (`_resident_batched_kernel`, l.420, behind
`resident_spmm_batched_pallas`) becomes `csrc/block_ell_spmm_batched.cu`
behind `resident_spmm_batched_kernel`: C[g] = A @ B[g] for a 3-D B, the
batch on the grid. The executors of the derived plans become one CUDA
kernel each: `compact_spmm_kernel` (`_compact_kernel`, l.1029;
`csrc/block_ell_spmm_compact.cu`), `grouped_spmm_kernel`
(`_grouped_kernel`, l.1186; `csrc/block_ell_spmm_grouped.cu`) and
`footprint_spmm_kernel` (`_footprint_kernel`, l.1344;
`csrc/block_ell_spmm_footprint.cu`). The 2-D, batched and compact
executors are one tensor-core body (`csrc/block_ell_spmm.cuh`) on the
ELL and compact walks of a row-block's slots, with one tile chooser, so on
the same A and B they are bitwise equal: the batched kernel, which folds
the batch into columns in place, and the compact one on its plan give
`tiled_spmm_kernel`'s bits on the folded B and on the base plan.
Row-blocks of at most 48 rows take its n-major tile (C's transpose, n on
the tensor cores' 64-row side). All three start the
row-blocks with the most slots first (`heaviest_first` of the plan). The
grouped and footprint executors add the same slots in the same order
through one FFMA chain (`csrc/window_tiles.cuh`): bitwise equal to each
other, within the tier of the tensor-core three.

A wrapper given CPU tensors runs the plain PyTorch version of the same
function (`_block_exec_plain`, `_block_exec_batched_plain`,
`_compact_plain`, `_grouped_plain`, `_footprint_plain`,
`_block_exec_int8_plain`, `_int8_kmajor_plain`). Given CUDA tensors it launches the kernel or
raises. Each entry point counts its launches (`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpusparse_torch.plan import CompactPlan, FootprintPlan, GroupedPlan, Plan
from tpusparse_torch.utils.config import cdiv, fp32_matmul, resolve_precision

KERNEL = "block_ell_spmm"
KERNEL_INT8 = "block_ell_spmm_int8"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = {"tiled_spmm": 0, "resident_spmm": 0, "tiled_spmm_int8": 0,
             "resident_spmm_int8": 0, "resident_spmm_batched": 0, "compact_spmm": 0,
             "grouped_spmm": 0, "footprint_spmm": 0, "int8_kmajor": 0}


def launch_counts() -> dict:
    """Kernel launches per entry point since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def tiled_spmm_kernel(
    plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """C = A @ B, A described by (plan, block_vals).

    block_vals: (plan.num_slots, bm, bk) from plan.pack_values(csr.data).
    b: (k, n) dense. Returns (m, n) in `out_dtype` (default: the result
    type of block_vals and b). The TPU kernel's `block_n` tile knob is not
    carried: the CUDA kernel tiles n itself.
    """
    return _run("tiled_spmm", plan, block_vals, b, out_dtype, precision)


def resident_spmm_kernel(
    plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Same contract and same kernel as `tiled_spmm_kernel` (the TPU's
    resident-B-panel variant; its VMEM fit check has no CUDA counterpart)."""
    return _run("resident_spmm", plan, block_vals, b, out_dtype, precision)


def _check(plan, block_vals: torch.Tensor, b: torch.Tensor, out_dtype, num_slots=None,
           b_ndim: int = 2):
    m, k = plan.shape
    bm, bk = plan.blocksize
    num_slots = plan.num_slots if num_slots is None else num_slots
    if b.ndim != b_ndim or b.shape[-2] != k:
        raise ValueError(f"b shape {tuple(b.shape)} incompatible with plan k={k}")
    if tuple(block_vals.shape) != (num_slots, bm, bk):
        raise ValueError(
            f"block_vals shape {tuple(block_vals.shape)} != plan's "
            f"{(num_slots, bm, bk)}"
        )
    for name, t in (("block_vals", block_vals), ("b", b)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype} not supported (float32, bfloat16)")
    if block_vals.device != b.device:
        raise ValueError(
            f"block_vals on {block_vals.device} and b on {b.device}: same device needed"
        )


def _run(entry, plan, block_vals, b, out_dtype, precision):
    out_dtype = out_dtype or torch.result_type(block_vals, b)
    _check(plan, block_vals, b, out_dtype)
    tier = resolve_precision(precision)
    if b.device.type == "cpu":
        return _block_exec_plain(
            plan, block_vals, b, out_dtype=out_dtype, precision=tier
        )
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    c = _launch(plan, block_vals, b, out_dtype, round_bf16=tier == "default")
    _LAUNCHES[entry] += 1
    return c


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/block_ell_spmm.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # vals, vals_dtype, b, b_dtype, c, c_dtype, block_cols, nslots, order, m, k,
    # n, bm, bk, nbr, L, round_bf16, device, stream
    return _build.bind(KERNEL, {"block_ell_spmm": [p, i, p, i, p, i, p, p, p] + [i] * 9 + [p]})[
        "block_ell_spmm"]


def _launch(plan, block_vals, b, out_dtype, round_bf16: bool) -> torch.Tensor:
    m, k = plan.shape
    bm, bk = plan.blocksize
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    dev = b.device
    rc = _kernel_fn()(
        block_vals.data_ptr(), _DTYPE_CODE[block_vals.dtype],
        b.data_ptr(), _DTYPE_CODE[b.dtype],
        c.data_ptr(), _DTYPE_CODE[out_dtype],
        plan.index_tensor("block_cols", dev).data_ptr(),
        plan.index_tensor("nslots", dev).data_ptr(),
        plan.index_tensor("heaviest_first", dev).data_ptr(),
        m, k, n, bm, bk, plan.num_row_blocks, plan.ell_width,
        int(round_bf16), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    return c


def _block_exec_plain(
    plan: Plan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the executor, on the inputs' device.

    Zero-pads B to (nbc*bk, n), gathers the (nbr, L, bk, n) tiles at
    block_cols, masks the slots at or past nslots and contracts in fp32,
    with TF32 off so that on the card it is a true fp32 yardstick. The
    'default' tier rounds both operands to bf16 first, as the kernel does.
    """
    m, k = plan.shape
    bm, bk = plan.blocksize
    nbr, nbc, L = plan.num_row_blocks, plan.num_col_blocks, plan.ell_width
    n = b.shape[1]
    dev = b.device
    out_dtype = out_dtype or torch.result_type(block_vals, b)
    tier = resolve_precision(precision)
    vf, bf = _tiered(block_vals, tier), _tiered(b, tier)
    bp = torch.zeros((nbc * bk, n), dtype=torch.float32, device=dev)
    bp[:k] = bf
    cols = plan.index_tensor("block_cols", dev).reshape(nbr, L).long()
    tiles = bp.reshape(nbc, bk, n)[cols]  # (nbr, L, bk, n)
    valid = plan.slot_valid_mask(dev).bool()[..., None, None]
    vals4 = torch.where(valid, vf.reshape(nbr, L, bm, bk), 0.0)
    with fp32_matmul():
        out = torch.einsum("ilmk,ilkn->imn", vals4, tiles)
    return out.reshape(nbr * bm, n)[:m].to(out_dtype)


def _tiered(x: torch.Tensor, tier: str) -> torch.Tensor:
    """x in fp32, rounded through bf16 first in the 'default' tier."""
    x = x.float()
    return x.to(torch.bfloat16).float() if tier == "default" else x


# ----------------------------------------------------------------------------
# Batched executor: a 3-D B under one plan
# ----------------------------------------------------------------------------


def resident_spmm_batched_kernel(
    plan: Plan, block_vals: torch.Tensor, b3: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """C[g] = A @ B[g] for b3 (batch, k, n); returns (batch, m, n).

    The counterpart of `resident_spmm_batched_pallas`
    (tpusparse/kernels/tiled_spmm.py:508-526): the batch on the grid, B and
    C read and written in place. The TPU kernel's VMEM fit check and its
    `block_n` and `unroll` knobs have no counterpart. The kernel's tiles
    run over b3 folded to (k, batch·n) in place, so C is bitwise equal to
    `resident_spmm_kernel` on that folded operand (one kernel body, one
    tile chooser) with no transposing copy.
    """
    out_dtype = out_dtype or torch.result_type(block_vals, b3)
    _check(plan, block_vals, b3, out_dtype, b_ndim=3)
    tier = resolve_precision(precision)
    if b3.device.type == "cpu":
        return _block_exec_batched_plain(plan, block_vals, b3, out_dtype=out_dtype,
                                         precision=tier)
    if b3.device.type != "cuda":
        raise ValueError(f"unsupported device {b3.device}")
    m, k = plan.shape
    bm, bk = plan.blocksize
    batch, _, n = b3.shape
    c = torch.empty((batch, m, n), dtype=out_dtype, device=b3.device)
    if batch == 0 or m == 0 or n == 0:
        return c
    args = (
        block_vals.data_ptr(), _DTYPE_CODE[block_vals.dtype], b3.data_ptr(),
        _DTYPE_CODE[b3.dtype], c.data_ptr(), _DTYPE_CODE[out_dtype],
        plan.index_tensor("block_cols", b3.device).data_ptr(),
        plan.index_tensor("nslots", b3.device).data_ptr(),
        plan.index_tensor("heaviest_first", b3.device).data_ptr(),
        batch, m, k, n, bm, bk, plan.num_row_blocks, plan.ell_width,
        int(tier == "default"), b3.device.index or 0,
        torch.cuda.current_stream(b3.device).cuda_stream,
    )
    _launch_c("resident_spmm_batched", args)
    return c


def _block_exec_batched_plain(
    plan: Plan, block_vals: torch.Tensor, b3: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the batched executor: `_block_exec_plain`
    on the batch folded into columns, (k, batch·n), unfolded after."""
    batch, k, n = b3.shape
    out = _block_exec_plain(plan, block_vals, b3.transpose(0, 1).reshape(k, batch * n),
                            out_dtype=out_dtype, precision=precision)
    return out.reshape(out.shape[0], batch, n).transpose(0, 1)


# ----------------------------------------------------------------------------
# Executors of the derived plans: compact, grouped, footprint
# ----------------------------------------------------------------------------


def compact_spmm_kernel(
    cplan: CompactPlan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """C = A @ B for a CompactPlan; block_vals (cplan.nblocks, bm, bk) from
    `cplan.pack_values`. The counterpart of `compact_spmm_pallas`
    (tpusparse/kernels/tiled_spmm.py:1091); its `block_n` knob and its
    TPU-only bk % 128 rule are not carried. Bitwise equal to
    `tiled_spmm_kernel` on the plan `cplan` derives from (one kernel
    body)."""
    return _run_derived("compact_spmm", cplan, block_vals, b, out_dtype, precision,
                        cplan.nblocks)


def grouped_spmm_kernel(
    gplan: GroupedPlan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """C = A @ B for a GroupedPlan; block_vals (gplan.num_slots, bm, bk) from
    `gplan.pack_values`. The counterpart of `grouped_spmm_pallas`
    (tpusparse/kernels/tiled_spmm.py:1243), with fp32 sums where the TPU
    kernel added each slot into its output block in the output's type (the
    two differ for a bf16 C only). Bitwise equal to `footprint_spmm_kernel`
    on the plan `gplan` derives from (one FFMA chain), within the tier of
    `tiled_spmm_kernel`. A thread block owns a window of one row-block
    (`grouped_tile`)."""
    return _run_derived("grouped_spmm", gplan, block_vals, b, out_dtype, precision,
                        gplan.num_slots)


def footprint_spmm_kernel(
    fplan: FootprintPlan, block_vals: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
    precision: str | None = None,
) -> torch.Tensor:
    """C = A @ B for a FootprintPlan; block_vals (fplan.num_slots, bm, bk)
    from `fplan.pack_values`. The counterpart of `footprint_spmm_pallas`
    (tpusparse/kernels/tiled_spmm.py:1418). Takes every plan: a thread block
    owns a 128-row window of a super-row (`footprint_tile`). Bitwise equal
    to `grouped_spmm_kernel` on the plan `fplan` derives from (one FFMA
    chain), within the tier of `tiled_spmm_kernel`."""
    return _run_derived("footprint_spmm", fplan, block_vals, b, out_dtype, precision,
                        fplan.num_slots)


# the footprint kernel's geometry: a thread block of FOOTPRINT_THREADS owns a
# window of FOOTPRINT_ROWS of a super's rows and FOOTPRINT_NTILE columns of C,
# its accumulators in registers
FOOTPRINT_ROWS, FOOTPRINT_NTILE, FOOTPRINT_THREADS = 128, 64, 256


def footprint_tile(fplan: FootprintPlan) -> int:
    """Thread blocks (FOOTPRINT_ROWS-row windows) of a super-row in the
    footprint kernel. Any rows_per_super and any width of B fit: the grid
    covers n in FOOTPRINT_NTILE-column tiles."""
    return cdiv(fplan.rows_per_super * fplan.blocksize[0], FOOTPRINT_ROWS)


# the grouped kernel's windows, by row-block height: (largest bm, window rows,
# n-tile columns); the CPU's copy of window_rows in
# csrc/block_ell_spmm_grouped.cu. A block of 256 threads owns one window of
# one row-block (a slice of a row-block taller than 128)
GROUPED_TILES = ((8, 8, 256), (None, 128, 64))


def grouped_tile(gplan: GroupedPlan, n: int) -> dict:
    """The grouped kernel's geometry for B of width n: the window's rows and
    n-tile columns, windows a row-block (`slices`) and the grid (thread
    blocks over the row-blocks and their slices, over the n-tiles). Any
    blocksize and any width of B fit."""
    bm = gplan.blocksize[0]
    rows, cols = next((r, c) for top, r, c in GROUPED_TILES if top is None or bm <= top)
    slices = cdiv(bm, rows)
    return {"rows": rows, "cols": cols, "slices": slices,
            "grid": (gplan.num_row_blocks * slices, cdiv(n, cols))}


def _run_derived(entry, dplan, block_vals, b, out_dtype, precision, num_slots):
    out_dtype = out_dtype or torch.result_type(block_vals, b)
    _check(dplan, block_vals, b, out_dtype, num_slots=num_slots)
    tier = resolve_precision(precision)
    if b.device.type == "cpu":
        return _PLAIN[entry](dplan, block_vals, b, out_dtype=out_dtype, precision=tier)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    m, k = dplan.shape
    bm, bk = dplan.blocksize
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    dev = b.device
    idx = lambda name: dplan.index_tensor(name, dev).data_ptr()  # noqa: E731
    head = (block_vals.data_ptr(), _DTYPE_CODE[block_vals.dtype], b.data_ptr(),
            _DTYPE_CODE[b.dtype], c.data_ptr(), _DTYPE_CODE[out_dtype])
    nbr = cdiv(m, bm)
    if entry == "compact_spmm":
        args = (idx("cols"), idx("row_base"), idx("heaviest_first"), m, k, n, bm, bk, nbr)
    elif entry == "grouped_spmm":
        args = (idx("block_cols"), idx("local_rb"), idx("nslots"), m, k, n, bm, bk, nbr,
                dplan.group_size, dplan.ell_width)
    else:
        args = (idx("ucols"), idx("nslots"), idx("lrow"), idx("bslot"),
                m, k, n, bm, bk, nbr, dplan.rows_per_super, dplan.ell_width,
                dplan.u_width, footprint_tile(dplan))
    tail = (int(tier == "default"), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _launch_c(entry, head + args + tail)
    return c


_P, _I = ctypes.c_void_p, ctypes.c_int
# values, B, C pointers with their dtype codes ... round_bf16, device, stream
_HEAD, _TAIL = [_P, _I, _P, _I, _P, _I], [_I, _I, _P]
# entry point -> (csrc/<source>.cu, its C function, the function's argtypes:
# the plan's index pointers, then its ints)
_C_ENTRY = {
    "resident_spmm_batched": ("block_ell_spmm_batched", "block_ell_spmm_batched",
                              _HEAD + [_P] * 3 + [_I] * 8 + _TAIL),
    "compact_spmm": ("block_ell_spmm_compact", "compact_spmm", _HEAD + [_P] * 3 + [_I] * 6 + _TAIL),
    "grouped_spmm": ("block_ell_spmm_grouped", "grouped_spmm", _HEAD + [_P] * 3 + [_I] * 8 + _TAIL),
    "footprint_spmm": ("block_ell_spmm_footprint", "footprint_spmm",
                       _HEAD + [_P] * 4 + [_I] * 10 + _TAIL),
}


@functools.cache
def _c_function(entry: str):
    """The C function behind `entry`, its source built on first use."""
    from tpusparse_torch.kernels import _build

    source, name, argtypes = _C_ENTRY[entry]
    return _build.bind(source, {name: argtypes})[name]


def _launch_c(entry: str, args: tuple) -> None:
    """Call `entry`'s C function, raise if the launch failed, count it."""
    rc = _c_function(entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{_C_ENTRY[entry][0]} launch failed: CUDA error {rc}")
    _LAUNCHES[entry] += 1


def _slots_plain(shape, blocksize, vals, cols, rbs, b, out_dtype, tier):
    """Σ over the given slots of vals[s] @ B[cols[s]*bk : +bk] into the
    rows of row-block rbs[s], on the inputs' device: whole-tile products in
    fp32 (TF32 off), added per row-block with `index_add_`."""
    m, k = shape
    bm, bk = blocksize
    nbr, nbc = cdiv(m, bm), cdiv(k, bk)
    n = b.shape[1]
    dev = b.device
    bp = torch.zeros((nbc * bk, n), dtype=torch.float32, device=dev)
    bp[:k] = _tiered(b, tier)
    tiles = bp.reshape(nbc, bk, n)[torch.as_tensor(cols, dtype=torch.long, device=dev)]
    with fp32_matmul():
        prods = torch.bmm(_tiered(vals, tier), tiles)
    out = torch.zeros((nbr, bm, n), dtype=torch.float32, device=dev)
    out.index_add_(0, torch.as_tensor(rbs, dtype=torch.long, device=dev), prods)
    return out.reshape(nbr * bm, n)[:m].to(out_dtype)


def _compact_plain(cplan: CompactPlan, block_vals, b, *, out_dtype=None, precision=None):
    """Plain PyTorch version of the compact executor."""
    rbs = np.repeat(np.arange(cplan.num_row_blocks), np.diff(np.asarray(cplan.row_base)))
    return _slots_plain(cplan.shape, cplan.blocksize, block_vals, np.asarray(cplan.cols), rbs,
                        b, out_dtype or torch.result_type(block_vals, b),
                        resolve_precision(precision))


def _grouped_plain(gplan: GroupedPlan, block_vals, b, *, out_dtype=None, precision=None):
    """Plain PyTorch version of the grouped executor (valid slots only)."""
    g_ids, l_ids = np.nonzero(np.arange(gplan.ell_width)[None, :]
                              < np.asarray(gplan.nslots)[:, None])
    slots = g_ids * gplan.ell_width + l_ids
    rbs = g_ids * gplan.group_size + np.asarray(gplan.local_rb)[g_ids, l_ids]
    vals = block_vals[torch.as_tensor(slots, dtype=torch.long, device=block_vals.device)]
    return _slots_plain(gplan.shape, gplan.blocksize, vals,
                        np.asarray(gplan.block_cols)[g_ids, l_ids], rbs, b,
                        out_dtype or torch.result_type(block_vals, b),
                        resolve_precision(precision))


def _footprint_plain(fplan: FootprintPlan, block_vals, b, *, out_dtype=None, precision=None):
    """Plain PyTorch version of the footprint executor (valid slots only)."""
    s_ids, l_ids = np.nonzero(np.arange(fplan.ell_width)[None, :]
                              < np.asarray(fplan.nslots)[:, None])
    slots = s_ids * fplan.ell_width + l_ids
    rbs = s_ids * fplan.rows_per_super + np.asarray(fplan.lrow)[s_ids, l_ids]
    cols = np.asarray(fplan.ucols)[s_ids, np.asarray(fplan.bslot)[s_ids, l_ids]]
    vals = block_vals[torch.as_tensor(slots, dtype=torch.long, device=block_vals.device)]
    return _slots_plain(fplan.shape, fplan.blocksize, vals, cols, rbs, b,
                        out_dtype or torch.result_type(block_vals, b),
                        resolve_precision(precision))


_PLAIN = {"compact_spmm": _compact_plain, "grouped_spmm": _grouped_plain,
          "footprint_spmm": _footprint_plain}


# ----------------------------------------------------------------------------
# int8 executor (the serving tier)
# ----------------------------------------------------------------------------


def resident_spmm_int8_kernel(
    plan: Plan, qvals: torch.Tensor, scales: torch.Tensor, b_q: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """C ≈ A @ B from quantized operands (`quant.py` packs them).

    qvals: (plan.num_slots, bm, bk) int8; scales: (plan.num_slots,) fp32,
    one per ELL slot (0 on pad slots); b_q: (k, n) int8; t: (n,) fp32
    per-column scales of B. Returns (m, n) fp32. The TPU kernel's `block_n`
    and `unroll` knobs are not carried: the CUDA kernel tiles n itself.
    """
    return _run_int8("resident_spmm_int8", plan, qvals, scales, b_q, t)


def tiled_spmm_int8_kernel(
    plan: Plan, qvals: torch.Tensor, scales: torch.Tensor, b_q: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Same contract and same kernel as `resident_spmm_int8_kernel` (the
    TPU's DMA-ring form, for any k), so the two are bitwise equal."""
    return _run_int8("tiled_spmm_int8", plan, qvals, scales, b_q, t)


def _check_int8(plan: Plan, qvals, scales, b_q, t) -> None:
    m, k = plan.shape
    bm, bk = plan.blocksize
    if b_q.dtype != torch.int8 or qvals.dtype != torch.int8:
        raise TypeError(
            f"int8 executor needs int8 operands, got {qvals.dtype}/{b_q.dtype}"
        )
    if b_q.ndim != 2 or b_q.shape[0] != k:
        raise ValueError(f"b shape {tuple(b_q.shape)} incompatible with plan k={k}")
    if tuple(qvals.shape) != (plan.num_slots, bm, bk):
        raise ValueError(
            f"qvals shape {tuple(qvals.shape)} != plan's {(plan.num_slots, bm, bk)}"
        )
    for name, s, size in (("scales", scales, plan.num_slots), ("t", t, b_q.shape[1])):
        if s.dtype != torch.float32 or tuple(s.shape) != (size,):
            raise TypeError(f"{name} must be float32 of shape ({size},), got "
                            f"{s.dtype} {tuple(s.shape)}")
    for name, x in (("qvals", qvals), ("scales", scales), ("b_q", b_q), ("t", t)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != b_q.device:
            raise ValueError(f"{name} on {x.device} and b_q on {b_q.device}: same device needed")


def _run_int8(entry, plan, qvals, scales, b_q, t):
    _check_int8(plan, qvals, scales, b_q, t)
    if b_q.device.type == "cpu":
        return _block_exec_int8_plain(plan, qvals, scales, b_q, t)
    if b_q.device.type != "cuda":
        raise ValueError(f"unsupported device {b_q.device}")
    if plan.shape[0] == 0 or b_q.shape[1] == 0:
        return torch.empty((plan.shape[0], b_q.shape[1]), dtype=torch.float32,
                           device=b_q.device)
    bt = int8_kmajor_kernel(b_q, cdiv(plan.num_col_blocks * plan.blocksize[1], 16) * 16)
    return _spmm_int8_launch(entry, plan, qvals, scales, bt, t)


def _spmm_int8_launch(entry, plan, qvals, scales, bt, t):
    """C of the int8 executor from B made K-major (`int8_kmajor_kernel`):
    one launch, counted under `entry`."""
    m, _ = plan.shape
    bm, bk = plan.blocksize
    n = bt.shape[0]
    c = torch.empty((m, n), dtype=torch.float32, device=bt.device)
    cols = plan.index_tensor("block_cols", bt.device)
    nslots = plan.index_tensor("nslots", bt.device)
    # the row-blocks by slot count, most first: the order the kernel starts them
    order = plan.perm_tensor("int8_order", np.argsort(-np.asarray(plan.nslots), kind="stable"),
                             bt.device)
    rc = _int8_kernel_fns()["block_ell_spmm_int8"](
        qvals.data_ptr(), scales.data_ptr(), bt.data_ptr(), t.data_ptr(), c.data_ptr(),
        cols.data_ptr(), nslots.data_ptr(), order.data_ptr(), m, n, bm, bk,
        plan.num_row_blocks, plan.ell_width, bt.shape[1], bt.device.index or 0,
        torch.cuda.current_stream(bt.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{KERNEL_INT8} launch failed: CUDA error {rc}")
    _LAUNCHES[entry] += 1
    return c


def int8_kmajor_kernel(b_q: torch.Tensor, ldt: int) -> torch.Tensor:
    """bt (n, ldt) int8 with bt[j, r] = b_q[r, j] for r < k and 0 up to
    ldt: b_q (k, n) K-major, as the s8 tensor cores read B. ldt is a
    multiple of 16 and at least k."""
    if b_q.dtype != torch.int8 or b_q.ndim != 2 or not b_q.is_contiguous():
        raise TypeError(f"b_q must be a contiguous 2-D int8 tensor, got {b_q.dtype} "
                        f"{tuple(b_q.shape)}")
    k, n = b_q.shape
    if ldt < k or ldt % 16:
        raise ValueError(f"ldt {ldt} must be a multiple of 16 and at least k = {k}")
    if b_q.device.type == "cpu":
        return _int8_kmajor_plain(b_q, ldt)
    bt = torch.empty((n, ldt), dtype=torch.int8, device=b_q.device)
    if b_q.numel() == 0:
        return bt.zero_()
    rc = _int8_kernel_fns()["int8_kmajor"](
        b_q.data_ptr(), bt.data_ptr(), k, n, ldt, b_q.device.index or 0,
        torch.cuda.current_stream(b_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_kmajor launch failed: CUDA error {rc}")
    _LAUNCHES["int8_kmajor"] += 1
    return bt


def _int8_kmajor_plain(b_q: torch.Tensor, ldt: int) -> torch.Tensor:
    """Plain PyTorch version of `int8_kmajor_kernel`, on the input's device."""
    bt = torch.zeros((b_q.shape[1], ldt), dtype=torch.int8, device=b_q.device)
    bt[:, :b_q.shape[0]] = b_q.t()
    return bt


@functools.cache
def _int8_kernel_fns() -> dict:
    """The C entry points of csrc/block_ell_spmm_int8.cu, built on first use."""
    from tpusparse_torch.kernels import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    # qvals, scales, bt, t, c, block_cols, nslots, order, m, n, bm, bk, nbr, L,
    # ldt, device, stream; b_q, bt, k, n, ldt, device, stream
    return _build.bind(KERNEL_INT8, {"block_ell_spmm_int8": [p] * 8 + [i] * 8 + [p],
                                     "int8_kmajor": [p] * 2 + [i] * 4 + [p]})


def _block_exec_int8_plain(
    plan: Plan, qvals: torch.Tensor, scales: torch.Tensor, b_q: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the int8 executor, on the inputs' device.

    Per ELL slot, the int8 product in float64 (exact below 2⁵³; neither
    int8 nor int32 products run on the card's `torch.matmul`), cast to int32
    and then to fp32; then acc = acc + s·prod in fp32, slot by slot, each
    multiply and add rounded on its own as the kernel rounds them, pad slots
    skipped; C = acc ∘ t.
    """
    m, k = plan.shape
    bm, bk = plan.blocksize
    nbr, nbc, L = plan.num_row_blocks, plan.num_col_blocks, plan.ell_width
    n = b_q.shape[1]
    dev = b_q.device
    bp = torch.zeros((nbc * bk, n), dtype=torch.float64, device=dev)
    bp[:k] = b_q.double()
    tiles = bp.reshape(nbc, bk, n)
    cols = plan.index_tensor("block_cols", dev).reshape(nbr, L).long()
    valid = plan.slot_valid_mask(dev).bool()
    q4 = qvals.reshape(nbr, L, bm, bk)
    s2 = scales.reshape(nbr, L)
    acc = torch.zeros((nbr, bm, n), dtype=torch.float32, device=dev)
    for l in range(L):
        prod = torch.bmm(q4[:, l].double(), tiles[cols[:, l]]).to(torch.int32).float()
        acc = torch.where(valid[:, l, None, None], acc + s2[:, l, None, None] * prod, acc)
    return acc.reshape(nbr * bm, n)[:m] * t
