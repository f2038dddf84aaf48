"""Card-only tests of the port's CUDA kernels; each skips without an NVIDIA
card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest skips tests/conftest.py, which configures JAX.) Each kernel is
held against its plain PyTorch version on the same card inputs.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tpusparse_torch as tt
from tpusparse_torch import kernels, quant
from tpusparse_torch.kernels import block_flash_attention as bfa
from tpusparse_torch.kernels import flash_attention as fa
from tpusparse_torch.kernels import gemm as gk
from tpusparse_torch.kernels import sddmm as sk
from tpusparse_torch.kernels import tiled_spmm as tk
from tpusparse_torch.models import serving
from tpusparse_torch.utils.config import cdiv
from tpusparse_torch.utils.data import synthetic_mnist
from tpusparse_torch.utils.matrices import block_sparse_csr

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier: kernel and plain sum in other orders
# C in bf16: nearly equal fp32 sums may round to adjacent bf16 values
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)

# every entry point of kernels/tiled_spmm.py, none launched
NO_TK = {"tiled_spmm": 0, "resident_spmm": 0, "tiled_spmm_int8": 0, "resident_spmm_int8": 0,
         "resident_spmm_batched": 0, "compact_spmm": 0, "grouped_spmm": 0,
         "footprint_spmm": 0, "int8_kmajor": 0}

# (m, k, n), blocksize, empty row range: bm 8 to 200 (the n-major tile up
# to 56, one or two warpgroups, slices of a taller row-block), bk 8 to 128
# (a slot of less than one 128-byte chunk, or four), n 1 to 512 (the 32-,
# 64- and 128-column tiles, ragged), empty row-blocks
CASES = {
    "bm24_bk16_n130_empty": ((100, 70, 130), (24, 16), (24, 48)),
    "bm72_bk32_n64": ((150, 90, 64), (72, 32), None),
    "ragged_8x32_n130": ((100, 70, 130), (8, 32), None),
    "ragged_32x8_n33": ((75, 53, 33), (32, 8), None),
    "empty_rowblock_128x128": ((300, 260, 40), (128, 128), (128, 256)),
    "bm64_bk16_n64": ((300, 200, 64), (64, 16), None),
    "bm128_bk128_n512": ((400, 520, 512), (128, 128), None),
    "bm200_bk8_n5_empty": ((610, 150, 5), (200, 8), (200, 400)),
    "bm128_bk32_n1": ((260, 300, 1), (128, 32), None),
    "bm64_bk128_n33": ((150, 300, 33), (64, 128), (64, 128)),
}
# a row-block of 65 slots of 128 x 128 (K = 8,320): the drift check
LONG_ROW = ((128, 8320, 64), (128, 128), None)
DRIFT_LIMIT = 1e-5  # max |kernel - plain| / max |plain|, fp32 'high'


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(name, device, vals_dtype=torch.float32, b_dtype=torch.float32):
    (m, k, n), bs, empty = LONG_ROW if name == "long_row" else CASES[name]
    rng = np.random.default_rng(0)
    mask = rng.random((m, k)) < 0.15
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=device)
    plan = tt.build_plan(a, bs)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return plan, plan.pack_values(a.data).to(vals_dtype), b.to(device, b_dtype)


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_and_counts(cuda, name, precision):
    """Both entry points bitwise equal, a second call bitwise equal to the
    first, within the tier of the plain version (3xTF32 or bf16 wgmma)."""
    plan, bv, b = _inputs(name, cuda)
    tk.reset_launch_counts()
    got_t = tk.tiled_spmm_kernel(plan, bv, b, precision=precision)
    got_r = tk.resident_spmm_kernel(plan, bv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**NO_TK, "tiled_spmm": 1, "resident_spmm": 1}
    assert torch.equal(got_t, got_r)
    assert torch.equal(got_t, tk.tiled_spmm_kernel(plan, bv, b, precision=precision))
    want = tk._block_exec_plain(plan, bv, b, precision=precision)
    torch.testing.assert_close(got_t, want, **TOL)
    empty = CASES[name][2]
    if empty is not None:  # row-blocks with no slot are written as zeros
        assert int(torch.count_nonzero(got_t[empty[0]:empty[1]])) == 0


@pytest.mark.parametrize("vals_dtype,b_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_bf16_operands(cuda, name, vals_dtype, b_dtype):
    plan, bv, b = _inputs(name, cuda, vals_dtype, b_dtype)
    got = tk.tiled_spmm_kernel(plan, bv, b)
    want = tk._block_exec_plain(plan, bv, b)
    assert got.dtype == want.dtype == torch.result_type(bv, b)
    assert torch.equal(got, tk.resident_spmm_kernel(plan, bv, b))
    tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_kernel_long_row_does_not_drift(cuda):
    """A row-block of 65 slots (K = 8,320) in fp32 'high': each chunk's
    3xTF32 products go into a fresh register sum before the running fp32
    sum, so the result stays within 1e-5 of scale of the plain version."""
    plan, bv, b = _inputs("long_row", cuda)
    assert int(plan.nslots[0]) >= 64
    got = tk.tiled_spmm_kernel(plan, bv, b, precision="high")
    want = tk._block_exec_plain(plan, bv, b, precision="high")
    assert float((got - want).abs().max() / want.abs().max()) <= DRIFT_LIMIT


def test_mixed_devices_raise(cuda):
    plan, bv, b = _inputs("ragged_32x8_n33", cuda)
    with pytest.raises(ValueError, match="same device"):
        tk.tiled_spmm_kernel(plan, bv.cpu(), b)


@pytest.mark.parametrize("variant", ["sparse", "blocksparse"])
def test_mnist_forward_on_card_matches_cpu(cuda, variant):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((32, 784)).astype(np.float32))
    nets = {d: tt.MnistNet(variant, hidden=256, device=d,
                           generator=torch.Generator().manual_seed(0)) for d in ("cpu", cuda)}
    tk.reset_launch_counts()
    with torch.inference_mode():
        got = nets[cuda](x.to(cuda))
        torch.cuda.synchronize()
        assert sum(tk.launch_counts().values()) == 2  # fc1 and fc2
        want = nets["cpu"](x)
    torch.testing.assert_close(got.cpu(), want, **TOL)


# -- sddmm ----------------------------------------------------------------------

# (m, k, n), blocksize, empty row range: as CASES, n the sum's length
SDDMM_CASES = {
    "ragged_8x16_n33": ((100, 70, 33), (8, 16), None),
    "ragged_32x8_n130": ((75, 53, 130), (32, 8), None),
    "empty_rowblock_128x128_n40": ((300, 260, 40), (128, 128), (128, 256)),
    "bm64_bk16_n64": ((300, 200, 64), (64, 16), None),
    "bm128_bk128_n512": ((400, 520, 512), (128, 128), None),
    "bm200_bk8_n5_empty": ((610, 150, 5), (200, 8), (200, 400)),
    "bm128_bk32_n1": ((260, 300, 1), (128, 32), None),
    "bm64_bk128_n130": ((150, 300, 130), (64, 128), (64, 128)),
}
# a sum over n = 8,192 in one range (144 valid slots of 128 x 128 fill the
# card: the drift check) and over n = 65,536 with 4 valid slots and pad
# slots (split into S > 1 ranges of n)
SDDMM_LONG = {"long_n": ((1536, 1536, 8192), (128, 128), None),
              "split_n": ((384, 256, 65536), (128, 128), (128, 256))}


def _sddmm_inputs(name, device, dtype=torch.float32):
    (m, k, n), bs, empty = SDDMM_LONG[name] if name in SDDMM_LONG else SDDMM_CASES[name]
    rng = np.random.default_rng(1)
    mask = rng.random((m, k)) < 0.15
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=device)
    plan = tt.build_plan(a, bs)
    dc = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device, dtype)
    return plan, dc, b


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("name", sorted(SDDMM_CASES))
def test_sddmm_kernel_matches_plain(cuda, name, precision):
    plan, dc, b = _sddmm_inputs(name, cuda)
    sk.reset_launch_counts()
    got = sk.sddmm_kernel(plan, dc, b, precision=precision)
    torch.cuda.synchronize()
    assert sk.launch_counts() == {"sddmm": 1}
    want = sk._sddmm_plain(plan, dc, b, precision=precision)
    assert got.shape == (plan.num_slots, *plan.blocksize) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)
    pad = ~plan.slot_valid_mask(cuda).bool().reshape(-1)
    assert torch.count_nonzero(got[pad]) == 0  # pad slots exactly 0


@pytest.mark.parametrize("name", sorted(SDDMM_CASES))
def test_sddmm_kernel_bf16(cuda, name):
    plan, dc, b = _sddmm_inputs(name, cuda, torch.bfloat16)
    got = sk.sddmm_kernel(plan, dc, b)
    want = sk._sddmm_plain(plan, dc, b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, sk.sddmm_kernel(plan, dc, b))
    torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
    pad = ~plan.slot_valid_mask(cuda).bool().reshape(-1)
    assert torch.count_nonzero(got[pad]) == 0


def test_sddmm_long_n_does_not_drift(cuda):
    """n = 8,192 in fp32 'high' in one range: within 1e-5 of scale."""
    plan, dc, b = _sddmm_inputs("long_n", cuda)
    assert sk.sddmm_splits(sk.sddmm_tiles(plan), dc.shape[1], sk._sm_count(0)) == 1
    got = sk.sddmm_kernel(plan, dc, b, precision="high")
    want = sk._sddmm_plain(plan, dc, b, precision="high")
    assert float((got - want).abs().max() / want.abs().max()) <= DRIFT_LIMIT


def _sddmm_f64(plan, dc, b, precision):
    """The SDDMM in float64 on the tier's operands (bf16-rounded in
    'default'): the oracle of sums too long for the fp32 plain version,
    whose own rounding over n = 65,536 exceeds the kernel's."""
    if precision == "default":
        dc, b = dc.bfloat16(), b.bfloat16()
    dense = dc.double() @ b.double().t()  # (m, k)
    bm, bk = plan.blocksize
    nbr, L = plan.num_row_blocks, plan.ell_width
    dp = dense.new_zeros((nbr * bm, plan.num_col_blocks * bk))
    dp[:dense.shape[0], :dense.shape[1]] = dense
    tiles = dp.reshape(nbr, bm, -1, bk).permute(0, 2, 1, 3)  # (nbr, nbc, bm, bk)
    cols = plan.index_tensor("block_cols", dc.device).reshape(nbr, L).long()
    out = tiles[torch.arange(nbr, device=dc.device)[:, None], cols]
    valid = plan.slot_valid_mask(dc.device).bool()[..., None, None]
    return torch.where(valid, out, 0.0).reshape(plan.num_slots, bm, bk)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "highest"), (torch.float32, "default"),
    (torch.bfloat16, "high"),
])
def test_sddmm_split_over_n(cuda, dtype, precision):
    """4 valid slots and n = 65,536: S > 1 ranges of n, one launch, a second
    call bitwise equal, pad slots exactly 0; fp32 output within 1e-5 of
    scale of the float64 SDDMM of the tier's operands, bf16 output within
    the bf16 tier of the plain version."""
    plan, dc, b = _sddmm_inputs("split_n", cuda, dtype)
    splits = sk.sddmm_splits(sk.sddmm_tiles(plan), dc.shape[1], sk._sm_count(0))
    assert plan.nblocks == 4 and splits > 1
    sk.reset_launch_counts()
    got = sk.sddmm_kernel(plan, dc, b, precision=precision)
    torch.cuda.synchronize()
    assert sk.launch_counts() == {"sddmm": 1}
    assert torch.equal(got, sk.sddmm_kernel(plan, dc, b, precision=precision))
    if dtype == torch.bfloat16:
        want = sk._sddmm_plain(plan, dc, b, precision=precision)
        torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
    else:
        want = _sddmm_f64(plan, dc, b, precision)
        assert float((got.double() - want).abs().max() / want.abs().max()) <= DRIFT_LIMIT
    pad = ~plan.slot_valid_mask(cuda).bool().reshape(-1)
    assert int(pad.sum()) > 0 and torch.count_nonzero(got[pad]) == 0


# -- gemm -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("transa,transb", [(False, False), (True, False), (False, True), (True, True)])
def test_gemm_kernel_matches_plain(cuda, transa, transb, dtype, precision):
    m, n, k = 100, 70, 33
    rng = np.random.default_rng(2)
    a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
    a, b = torch.from_numpy(a).to(cuda, dtype), torch.from_numpy(b).to(cuda, dtype)
    gk.reset_launch_counts()
    got = gk.gemm_kernel(a, b, transa=transa, transb=transb, precision=precision)
    torch.cuda.synchronize()
    assert gk.launch_counts() == {"gemm": 1, "gemm_s8": 0}
    want = gk._gemm_plain(a, b, transa=transa, transb=transb, precision=precision)
    assert got.shape == (m, n) and got.dtype == dtype
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


# (m, n, k): the ragged case (132-byte rows), the MLP's last layer (n = 10,
# 40-byte rows) and its first layer's shape
GEMM_SHAPES = [(100, 70, 33), (32, 10, 256), (32, 784, 256)]
GEMM_TIERS = [(torch.float32, "high"), (torch.float32, "highest"), (torch.float32, "default"),
              (torch.bfloat16, "high"), (torch.bfloat16, "default")]


@pytest.mark.parametrize("dtype,precision", GEMM_TIERS)
@pytest.mark.parametrize("transa,transb", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_gemm_tiers_and_shapes_match_plain(cuda, shape, transa, transb, dtype, precision):
    """The tensor-core gemm in every tier (3xTF32 for fp32 'high'/'highest',
    bf16 wgmma otherwise) at ragged and MLP shapes, both staging paths
    (16-byte and element loads), every transpose pair: one launch, within
    the tier of the plain version."""
    m, n, k = shape
    rng = np.random.default_rng(m + n + k)
    a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
    a, b = torch.from_numpy(a).to(cuda, dtype), torch.from_numpy(b).to(cuda, dtype)
    gk.reset_launch_counts()
    got = gk.gemm_kernel(a, b, transa=transa, transb=transb, precision=precision)
    torch.cuda.synchronize()
    assert gk.launch_counts() == {"gemm": 1, "gemm_s8": 0}
    want = gk._gemm_plain(a, b, transa=transa, transb=transb, precision=precision)
    assert got.shape == (m, n) and got.dtype == dtype
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_gemm_repeats_bit_for_bit(cuda, precision):
    """No atomics, no split-K: two identical calls give identical bits."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((300, 1000)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((1000, 260)).astype(np.float32)).to(cuda)
    first = gk.gemm_kernel(a, b, precision=precision)
    assert torch.equal(first, gk.gemm_kernel(a, b, precision=precision))


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("shape,transa,transb", [
    ((4096, 4096, 4096), False, False), ((1000, 300, 777), False, False),
    ((1000, 300, 777), True, True), ((32, 784, 256), False, True),
])
def test_gemm_block_heights_give_the_same_bits(cuda, shape, transa, transb, dtype, precision):
    """Both block heights (the autotuner's candidates) sum every element's
    k-chunks in the same order: bitwise equal outputs, one launch each, and
    the default height csrc/gemm.cu picks is one of them."""
    m, n, k = shape
    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((k, m) if transa else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if transb else (k, n)).astype(np.float32)
    a, b = torch.from_numpy(a).to(cuda, dtype), torch.from_numpy(b).to(cuda, dtype)
    kw = dict(transa=transa, transb=transb, precision=precision)
    gk.reset_launch_counts()
    outs = [gk.gemm_kernel(a, b, block_m=bm, **kw) for bm in gk.BLOCK_MS]
    default = gk.gemm_kernel(a, b, **kw)
    torch.cuda.synchronize()
    assert gk.launch_counts()["gemm"] == 3
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], default)
    assert gk.default_block_m(m, n) == (128 if cdiv(m, 128) * cdiv(n, 128) >= 264 else 64)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    plan, dc, b = _sddmm_inputs("ragged_8x16_n33", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sddmm_kernel(plan, dc.t().contiguous().t(), b)
    with pytest.raises(TypeError, match="dtype"):
        sk.sddmm_kernel(plan, dc.double(), b)
    with pytest.raises(ValueError, match="shape"):
        sk.sddmm_kernel(plan, dc[:-1], b)
    with pytest.raises(ValueError, match="same device"):
        sk.sddmm_kernel(plan, dc, b.cpu())
    a = torch.ones(8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gemm_kernel(a.t(), a)
    with pytest.raises(TypeError, match="dtype"):
        gk.gemm_kernel(a.half(), a.t().contiguous().half())
    with pytest.raises(ValueError, match="contraction"):
        gk.gemm_kernel(a, a)
    with pytest.raises(ValueError, match="same device"):
        gk.gemm_kernel(a, a.cpu(), transb=True)


# -- one training step, card against CPU ----------------------------------------

# launches per step: 'sparse'/'blocksparse' run fc1 and fc2 forward, fc2's dB
# and both dW (SDDMM); 'dense' with the GEMM kernel runs 2 forward products,
# fc2's dX and dW, and fc1's dW.
NO_FLASH = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
NO_BLK = {"blk_flash_fwd": 0, "blk_flash_dq": 0, "blk_flash_dkv": 0}
NO_INT8 = {"spmm_int8": 0, "int8_kmajor": 0, "gemm_s8": 0, "flash_q8": 0}
NO_PLAN_EXEC = {"resident_spmm_batched": 0, "compact_spmm": 0, "grouped_spmm": 0,
                "footprint_spmm": 0}
NO_WINDOWED = {"windowed_gather": 0, "windowed_segsum": 0}
NO_OTHER = {**NO_FLASH, **NO_BLK, **NO_INT8, **NO_PLAN_EXEC, **NO_WINDOWED, "naive_spmm": 0,
            "dia_spmv": 0, "dia_nonfinite": 0}
STEP_LAUNCHES = {
    "sparse": {"block_ell_spmm": 3, "sddmm": 2, "gemm": 0, **NO_OTHER},
    "blocksparse": {"block_ell_spmm": 3, "sddmm": 2, "gemm": 0, **NO_OTHER},
    "dense": {"block_ell_spmm": 0, "sddmm": 0, "gemm": 5, **NO_OTHER},
}


@pytest.mark.parametrize("variant", sorted(STEP_LAUNCHES))
def test_train_step_on_card_matches_cpu(cuda, variant):
    tx, ty, _, _ = synthetic_mnist(n_train=64, n_test=8)
    x, y = torch.from_numpy(tx[:32]), torch.from_numpy(ty[:32])
    prev = tt.get_config().use_gemm_kernel
    tt.set_config(use_gemm_kernel=variant == "dense")
    try:
        nets = {d: tt.MnistNet(variant, hidden=256, device=d,
                               generator=torch.Generator().manual_seed(0)) for d in ("cpu", cuda)}
        opts = {d: tt.make_train_state(n) for d, n in nets.items()}
        kernels.reset_launch_counts()
        got = tt.train_step(nets[cuda], opts[cuda], x.to(cuda), y.to(cuda))
        torch.cuda.synchronize()
        assert kernels.launches_by_kernel() == STEP_LAUNCHES[variant]
        want = tt.train_step(nets["cpu"], opts["cpu"], x, y)
    finally:
        tt.set_config(use_gemm_kernel=prev)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    for (name, p), (_, q) in zip(nets[cuda].named_parameters(), nets["cpu"].named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), **TOL, msg=name)


# -- flash attention --------------------------------------------------------------

# (bh, s, d), causal, q_offset, kv_offset
FLASH_CASES = {
    "6x256x64": ((6, 256, 64), False, 0, 0),
    "causal_2x384x64": ((2, 384, 64), True, 0, 0),
    "ragged_causal_1x200x64": ((1, 200, 64), True, 0, 0),
    "narrow_8x128x24": ((8, 128, 24), False, 0, 0),
    "wide_causal_2x128x128": ((2, 128, 128), True, 0, 0),
    # head dims above 128: the forward's and the backward's teams of warps
    # on the tensor cores
    "wider_causal_2x128x192": ((2, 128, 192), True, 0, 0),
    "wider_2x130x256": ((2, 130, 256), False, 0, 0),
    "wider_ragged_offsets_1x200x200": ((1, 200, 200), True, 64, 0),
    # S wider than one 128-column slice; the 3xTF32 bank folding (s > 512);
    # beyond one 256-wide accumulator (d 320; d 330 off 16 bytes, staged
    # synchronously); d 640 in 512-wide chunks of o, S over d in pieces;
    # causal with a q offset; rows that see no key
    "wider_d136_2x200x136": ((2, 200, 136), False, 0, 0),
    "wider_fold_1x1100x256": ((1, 1100, 256), False, 0, 0),
    "wider_fold_1x1100x384": ((1, 1100, 384), False, 0, 0),
    "wider_fold_1x1100x640": ((1, 1100, 640), False, 0, 0),
    "wider_causal_d320_2x130x320": ((2, 130, 320), True, 0, 0),
    "wider_ragged_d330_1x150x330": ((1, 150, 330), False, 0, 0),
    "wider_causal_d640_1x130x640": ((1, 130, 640), True, 0, 0),
    "wider_causal_qoff64_2x256x256": ((2, 256, 256), True, 64, 0),
    "wider_no_key_rows_1x128x256": ((1, 128, 256), True, 0, 100),
    "ragged_wide_2x130x100": ((2, 130, 100), False, 0, 0),
    "offsets_1x256x64": ((1, 256, 64), True, 256, 0),
    "no_key_rows_1x128x64": ((1, 128, 64), True, 0, 100),
    # d off every multiple of 8; one row; rows that see no key across nine
    # 128-row q-tiles of the tensor-core forward
    "ragged_d_3x150x20": ((3, 150, 20), False, 0, 0),
    "one_row_2x1x64": ((2, 1, 64), False, 0, 0),
    "kv_ahead_causal_2x1030x64": ((2, 1030, 64), True, 0, 300),
    # 64 tiles on each axis: the 3xTF32 backward banks its sums every 8
    "long_1x4096x64": ((1, 4096, 64), False, 0, 0),
    "long_causal_1x4096x64": ((1, 4096, 64), True, 0, 0),
}
# o of the 'default' tier and of bf16 inputs: p is rounded to bf16 against
# the running max of its tile in the kernel and against the row max in the
# plain version, and bf16 outputs are one ulp (2^-8..2^-7) apart
FLASH_ROUNDED_LIMIT = 1e-2
# dq, dk, dv of the long cases in 'high'/'highest' against float64: an fp32
# plain sum over 4096 terms carries an error of its own near this limit
FLASH_LONG_LIMIT = 1e-5


def _over_scale(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def _flash_bwd_f64(q, k, v, do, lse, delta, *, sm_scale, causal, q_offset, kv_offset,
                   precision=None):
    """dq, dk, dv in float64 from the kernels' lse and delta, q pre-scaled in
    its own type as the kernels take it."""
    qs = (q.float() * fa._scale_in(q.dtype, sm_scale)).to(q.dtype).double()
    kd, vd, dod = k.double(), v.double(), do.double()
    vis = fa._visible(q.shape[-2], causal, q_offset, kv_offset, q.device)
    p = torch.where(vis, torch.exp(qs @ kd.transpose(-1, -2) - lse.double()[..., None]), 0.0)
    ds = p * (dod @ vd.transpose(-1, -2) - delta.double()[..., None])
    return (ds @ kd) * sm_scale, ds.transpose(-1, -2) @ qs, p.transpose(-1, -2) @ dod


def _flash_args(name, device, dtype):
    shape, causal, qo, ko = FLASH_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
                   for _ in range(4))
    kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=causal, q_offset=qo, kv_offset=ko)
    return q, k, v, do, kw


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "highest"), (torch.float32, "default"),
    (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name, dtype, precision):
    q, k, v, do, kw = _flash_args(name, cuda, dtype)
    kw["precision"] = precision
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).to(dtype).float()
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_q8": 0}
    po, plse = fa._flash_fwd_plain(q, k, v, **kw)
    pdq = fa._flash_dq_plain(q, k, v, do, lse, delta, **kw)
    pdk, pdv = fa._flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(lse, plse, **TOL)
    rounded = dtype == torch.bfloat16 or precision == "default"
    if rounded:
        assert _over_scale(o, po) < FLASH_ROUNDED_LIMIT
    else:
        torch.testing.assert_close(o, po, **TOL)
    long = name.startswith("long")
    if long and not rounded:
        pdq, pdk, pdv = _flash_bwd_f64(q, k, v, do, lse, delta, **kw)
    for gname, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        if rounded:
            assert _over_scale(got, want) < FLASH_ROUNDED_LIMIT, gname
        elif long:
            assert _over_scale(got, want) < FLASH_LONG_LIMIT, gname
        else:
            torch.testing.assert_close(got, want, **TOL, msg=gname)
    if FLASH_CASES[name][3] > FLASH_CASES[name][2]:  # rows that see no key
        blind = FLASH_CASES[name][3] - FLASH_CASES[name][2]
        assert torch.count_nonzero(o[:, :blind]) == 0 and torch.count_nonzero(dq[:, :blind]) == 0
        assert bool((lse[:, :blind] == -1e30).all())


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
def test_flash_forward_repeats_bit_for_bit(cuda, dtype, precision):
    q, k, v, _, kw = _flash_args("kv_ahead_causal_2x1030x64", cuda, dtype)
    first = fa.flash_fwd_kernel(q, k, v, precision=precision, **kw)
    second = fa.flash_fwd_kernel(q, k, v, precision=precision, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", ["wider_fold_1x1100x256", "wider_causal_d320_2x130x320",
                                  "wider_causal_d640_1x130x640", "wider_maskfree_1024_b64",
                                  "wider_band_masked_256_b64",
                                  "wider_maskfree_unpadded_160_b64"])
def test_wide_forwards_repeat_bit_for_bit(cuda, name, dtype, precision):
    """The forwards at d > 128 (a team's warps sum their partial scores in
    one order) give the same bits twice: flash and the block kernel."""
    if name in FLASH_CASES:
        q, k, v, _, kw = _flash_args(name, cuda, dtype)
        runs = [fa.flash_fwd_kernel(q, k, v, precision=precision, **kw) for _ in range(2)]
    else:
        q, k, v, _, plan, kw = _blk_args(name, cuda, dtype)
        runs = [bfa.blk_flash_fwd_kernel(q, k, v, plan, precision=precision, **kw)
                for _ in range(2)]
    first, second = runs
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", sorted(n for n in FLASH_CASES if n.startswith("wider_")))
def test_wide_flash_backward_repeats_bit_for_bit(cuda, name, dtype, precision):
    """dq, dk and dv at d > 128 (a team's warps sum their partial S and dP
    in one order; above d 512 in chunks of the output) give the same bits
    twice."""
    q, k, v, do, kw = _flash_args(name, cuda, dtype)
    kw["precision"] = precision
    o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    runs = [(fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw),
             *fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
def test_flash_backward_repeats_bit_for_bit(cuda, dtype, precision):
    q, k, v, do, kw = _flash_args("causal_2x384x64", cuda, dtype)
    kw["precision"] = precision
    o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    first = (fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw),
             *fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw))
    second = (fa.flash_dq_kernel(q, k, v, do, lse, delta, **kw),
              *fa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", ["6x256x64", "causal_2x384x64", "ragged_causal_1x200x64",
                                  "narrow_8x128x24", "wide_causal_2x128x128",
                                  "kv_ahead_causal_2x1030x64", "long_causal_1x4096x64",
                                  "long_1x4096x64"])
def test_flash_q_tiles_give_the_same_bits(cuda, name, dtype, precision):
    """The forward's 64-row q-tile (four warps) and its 128-row one (eight)
    sum each row in one warp over the same k-tiles in the same order: o and
    lse bitwise equal, causal or not, in every tier (the long cases bank
    their 3xTF32 sums every 8 k-tiles)."""
    q, k, v, _, kw = _flash_args(name, cuda, dtype)
    kw["precision"] = precision
    fa.reset_launch_counts()
    o128, lse128 = fa.flash_fwd_kernel(q, k, v, block_q=128, **kw)
    o64, lse64 = fa.flash_fwd_kernel(q, k, v, block_q=64, **kw)
    o0, lse0 = fa.flash_fwd_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_fwd"] == 3
    assert torch.equal(o64, o128) and torch.equal(lse64, lse128)
    assert torch.equal(o0, o128) and torch.equal(lse0, lse128)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, do, kw = _flash_args("narrow_8x128x24", cuda, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd_kernel(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(TypeError, match="one type"):
        fa.flash_fwd_kernel(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="same device"):
        fa.flash_fwd_kernel(q, k.cpu(), v, **kw)
    with pytest.raises(ValueError, match="shapes differ"):
        fa.flash_fwd_kernel(q, k[:, :64], v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, **kw)
    o, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    with pytest.raises(TypeError, match="lse"):
        fa.flash_dq_kernel(q, k, v, do, lse[:, :64].contiguous(), lse, **kw)


def test_flash_layer_train_step_on_card_matches_cpu(cuda):
    """A BERT layer ('flash', hidden 96, 4 heads) SGD step on the card and on
    the CPU from one seed: 1 flash_fwd, 1 flash_dq and 1 flash_dkv, and the
    same loss and parameters."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 200, 96)).astype(np.float32))
    layers = {d: tt.BertAttentionLayer(96, 4, 192, "flash", device=d,
                                       generator=torch.Generator().manual_seed(0))
              for d in ("cpu", cuda)}
    opts = {d: tt.make_train_state(m) for d, m in layers.items()}
    kernels.reset_launch_counts()
    got = tt.bert_train_step(layers[cuda], opts[cuda], x.to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launches_by_kernel()
    assert {n: counts[n] for n in NO_FLASH} == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    want = tt.bert_train_step(layers["cpu"], opts["cpu"], x)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    for (name, p), (_, q) in zip(layers[cuda].named_parameters(), layers["cpu"].named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), **TOL, msg=name)


# -- block-pattern flash attention ---------------------------------------------


def _blk_plan(name):
    """Plans of each kind the kernels take: mask-free block masks, token
    patterns with tile masks, blocks 32 to 256 and unequal, s off the block;
    a band without global keys, whose rows past the band's start find their
    first listed sub-tile wholly masked; rows that see no key (the band with
    some rows cleared from its tile masks); rows of 16 sub-tiles and more,
    past the forward's bank of 8."""
    # the same plans at head dims above 128 ("wider_"), "dNNN_" where one
    # plan runs at more than one of them
    name = re.sub(r"^wider_(d\d+_)?", "", name)
    if name == "bigbird_512_b64":
        return bfa.BlockAttnPlan(tt.bigbird_block_mask(512, 64), 64, 64, 512)
    if name == "bigbird_256_b32":
        return bfa.BlockAttnPlan(tt.bigbird_block_mask(256, 32, 3, 1, 1), 32, 32, 256)
    if name == "bigbird_1024_b128":
        return bfa.BlockAttnPlan(tt.bigbird_block_mask(1024, 128), 128, 128, 1024)
    if name == "maskfree_unpadded_160_b64":
        return bfa.BlockAttnPlan(np.ones((3, 3), bool), 64, 64, 160)
    if name == "maskfree_1024_b64":
        return bfa.BlockAttnPlan(np.ones((16, 16), bool), 64, 64, 1024)
    s, bq, bk, window, glob = {
        "band_masked_256_b64": (256, 64, 64, 20, 3),
        "band_masked_first_empty_256_b64": (256, 64, 64, 20, 0),
        "blind_rows_256_b64": (256, 64, 64, 20, 3),
        "band_masked_unpadded_160_b64x32": (160, 64, 32, 20, 3),
        "band_masked_512_b128x256": (512, 128, 256, 40, 2),
        "band_masked_1024_b256": (1024, 256, 256, 64, 0),
        "band_masked_unaligned_200_b40x24": (200, 40, 24, 20, 3),
    }[name]
    ind, ptr = tt.local_global_pattern(s, window, glob)
    plan = bfa.BlockAttnPlan.from_token_pattern(ind, ptr, s, bq, bk)
    if name == "blind_rows_256_b64":  # rows 70-89 of q-block 1 see no key
        plan.tile_masks[plan.L:2 * plan.L, 70 - 64:90 - 64] = 0
    return plan


BLK_CASES = {  # name: (bh, d)
    "bigbird_512_b64": (4, 64),
    "bigbird_256_b32": (2, 128),
    "bigbird_1024_b128": (2, 64),
    "maskfree_unpadded_160_b64": (3, 40),
    "maskfree_1024_b64": (2, 64),
    "band_masked_256_b64": (3, 64),
    "band_masked_first_empty_256_b64": (2, 96),
    "blind_rows_256_b64": (2, 64),
    "band_masked_unpadded_160_b64x32": (2, 24),
    "band_masked_512_b128x256": (2, 128),
    "band_masked_1024_b256": (2, 64),
    "wider_bigbird_256_b32": (2, 192),
    "wider_band_masked_unpadded_160_b64x32": (2, 200),
    "wider_band_masked_512_b128x256": (1, 256),
    # the forward's teams: S wider than one 128-column slice, the 3xTF32 bank
    # folding (1024 keys a row), beyond one 256-wide accumulator (d 320 and
    # 520; d 640 in 512-wide chunks of o), rows that see no key
    "wider_bigbird_512_b64": (2, 136),
    "wider_maskfree_1024_b64": (1, 256),
    "wider_band_masked_256_b64": (2, 320),
    "wider_band_masked_first_empty_256_b64": (2, 520),
    "wider_maskfree_unpadded_160_b64": (1, 640),
    "wider_blind_rows_256_b64": (2, 256),
    # mask rows of 24 bytes (no 16-byte copies of the masks), q-blocks of 40
    # rows (the wide tiles' teams partly idle)
    "wider_band_masked_unaligned_200_b40x24": (2, 136),
    # the backward's 3xTF32 bank (every 256 streamed rows) on the 512
    # instance and in the 512-wide chunks; mask rows of 24 bytes there
    "wider_d384_maskfree_1024_b64": (1, 384),
    "wider_d640_maskfree_1024_b64": (1, 640),
    "wider_d320_band_masked_unaligned_200_b40x24": (2, 320),
}


def _blk_args(name, device, dtype):
    plan = _blk_plan(name)
    bh, d = BLK_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, plan.seq, d)).astype(np.float32))
                   .to(device, dtype) for _ in range(4))
    return q, k, v, do, plan, dict(sm_scale=1 / d ** 0.5)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", sorted(BLK_CASES))
def test_block_flash_kernels_match_plain(cuda, name, dtype, precision):
    q, k, v, do, plan, kw = _blk_args(name, cuda, dtype)
    kw["precision"] = precision
    bfa.reset_launch_counts()
    o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
    delta = (do.float() * o.float()).sum(-1).to(dtype).float()
    dq = bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw)
    dk, dv = bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw)
    torch.cuda.synchronize()
    assert bfa.launch_counts() == {"blk_flash_fwd": 1, "blk_flash_dq": 1, "blk_flash_dkv": 1}
    po, plse = bfa._blk_fwd_plain(q, k, v, plan, **kw)
    pdq = bfa._blk_dq_plain(q, k, v, do, lse, delta, plan, **kw)
    pdk, pdv = bfa._blk_dkv_plain(q, k, v, do, lse, delta, plan, **kw)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(lse, plse, **TOL)
    rounded = dtype == torch.bfloat16 or precision == "default"
    for gname, got, want in (("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        if rounded:
            assert _over_scale(got, want) < FLASH_ROUNDED_LIMIT, gname
        else:
            torch.testing.assert_close(got, want, **TOL, msg=gname)
    blind = ~plan.token_mask(cuda).any(-1)  # rows that see no key
    assert torch.count_nonzero(o[:, blind]) == 0 and torch.count_nonzero(dq[:, blind]) == 0
    assert bool((lse[:, blind] == -1e30).all())
    if name == "blind_rows_256_b64":
        assert int(blind.sum()) == 20


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", ["bigbird_512_b64", "band_masked_1024_b256",
                                  "maskfree_1024_b64", "band_masked_first_empty_256_b64"])
def test_block_flash_forward_repeats_bit_for_bit(cuda, name, dtype, precision):
    q, k, v, _, plan, kw = _blk_args(name, cuda, dtype)
    first = bfa.blk_flash_fwd_kernel(q, k, v, plan, precision=precision, **kw)
    second = bfa.blk_flash_fwd_kernel(q, k, v, plan, precision=precision, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("name", ["bigbird_512_b64", "band_masked_1024_b256",
                                  "maskfree_1024_b64", "band_masked_first_empty_256_b64",
                                  # the wide teams: masked at d 256 (dq's shared
                                  # memory full), the 3xTF32 bank, d 320, d 520 and
                                  # d 640 (chunks)
                                  "wider_band_masked_512_b128x256", "wider_maskfree_1024_b64",
                                  "wider_band_masked_256_b64",
                                  "wider_band_masked_first_empty_256_b64",
                                  "wider_maskfree_unpadded_160_b64",
                                  # the bank on the 512 instance and in the chunks
                                  "wider_d384_maskfree_1024_b64",
                                  "wider_d640_maskfree_1024_b64"])
def test_block_flash_backward_repeats_bit_for_bit(cuda, name, dtype, precision):
    q, k, v, do, plan, kw = _blk_args(name, cuda, dtype)
    kw["precision"] = precision
    o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
    delta = (do.float() * o.float()).sum(-1).to(dtype).float()
    runs = [(bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw),
             *bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
def test_block_flash_keys_that_no_query_sees_get_zero_gradients(cuda, dtype, precision):
    """dk = dv = 0 exactly for keys that no query sees: kv block 2 of a
    block mask that no q-block lists (its dk/dv tiles walk nothing), and keys
    100-109 of a band plan whose tile masks are zeroed in their columns
    (every listed sub-tile masks them)."""
    _unseen_keys_get_zero_gradients(cuda, dtype, precision, 64)


@pytest.mark.parametrize("dtype,precision", [
    (torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high"),
])
@pytest.mark.parametrize("d", [256, 640])
def test_block_flash_wide_keys_that_no_query_sees_get_zero_gradients(cuda, d, dtype, precision):
    """The same on the wide teams (d 256) and in their chunks (d 640)."""
    _unseen_keys_get_zero_gradients(cuda, dtype, precision, d)


def _unseen_keys_get_zero_gradients(cuda, dtype, precision, d):
    mask = np.array([[1, 1, 0, 0], [1, 1, 0, 1], [0, 1, 0, 1], [1, 0, 0, 1]], bool)
    ind, ptr = tt.local_global_pattern(256, 20, 3)
    banded = bfa.BlockAttnPlan.from_token_pattern(ind, ptr, 256, 64, 64)
    ii, ll = np.nonzero(np.arange(banded.L)[None, :] < banded.kv_cnt[:, None])
    for i, l in zip(ii, ll):
        if banded.kv_list[i, l] == 1:
            banded.tile_masks[i * banded.L + l, :, 100 - 64:110 - 64] = 0
    rng = np.random.default_rng(43)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 256, d)).astype(np.float32))
                   .to(cuda, dtype) for _ in range(4))
    kw = dict(sm_scale=d ** -0.5, precision=precision)
    for plan, n_unseen in ((bfa.BlockAttnPlan(mask, 64, 64, 256), 64), (banded, 10)):
        o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
        delta = (do.float() * o.float()).sum(-1).to(dtype).float()
        dk, dv = bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw)
        unseen = ~plan.token_mask(cuda).any(0)
        assert int(unseen.sum()) == n_unseen
        assert torch.count_nonzero(dk[:, unseen]) == 0 and torch.count_nonzero(dv[:, unseen]) == 0
        assert torch.count_nonzero(dk[:, ~unseen]) > 0


def test_block_flash_backward_of_a_long_list_matches_float64(cuda):
    """A band with global tokens at seq 2048, blocks of 256: q-block 0 lists
    every kv block and every q-block lists kv block 0, so both kernels
    stream 2048 rows for those tiles and bank their 3xTF32 sums four times.
    dq, dk and dv against float64 from the kernels' lse and delta, within
    FLASH_LONG_LIMIT of scale (an fp32 plain sum over 2048 terms carries an
    error of its own near it)."""
    ind, ptr = tt.local_global_pattern(2048, 64, 256)
    plan = bfa.BlockAttnPlan.from_token_pattern(ind, ptr, 2048, 256, 256)
    assert plan.tile_masks is not None and int(plan.kv_cnt[0]) == plan.nk == 8
    rng = np.random.default_rng(41)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2048, 64)).astype(np.float32))
                   .to(cuda) for _ in range(4))
    kw = dict(sm_scale=0.125, precision="high")
    o, lse = bfa.blk_flash_fwd_kernel(q, k, v, plan, **kw)
    delta = (do * o).sum(-1)
    dq = bfa.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw)
    dk, dv = bfa.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw)
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    vis = plan.token_mask(cuda)
    sc = (qd @ kd.transpose(-1, -2)) * kw["sm_scale"]
    p = torch.where(vis, torch.exp(sc - lse.double()[..., None]), 0.0)
    ds = p * (dod @ vd.transpose(-1, -2) - delta.double()[..., None]) * kw["sm_scale"]
    want = (ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod)
    for gname, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _over_scale(got, w) < FLASH_LONG_LIMIT, gname


def test_block_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, do, plan, kw = _blk_args("band_masked_256_b64", cuda, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        bfa.blk_flash_fwd_kernel(q.half(), k.half(), v.half(), plan, **kw)
    with pytest.raises(ValueError, match="same device"):
        bfa.blk_flash_fwd_kernel(q, k.cpu(), v, plan, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bfa.blk_flash_fwd_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, plan,
                                 **kw)
    with pytest.raises(ValueError, match="plan is for seq 256"):
        bfa.blk_flash_fwd_kernel(q[:, :128].contiguous(), k[:, :128].contiguous(),
                                 v[:, :128].contiguous(), plan, **kw)


@pytest.mark.parametrize("attention,force", [("bigbird", None), ("sparse", "blockflash")])
def test_pattern_layer_train_step_on_card_matches_cpu(cuda, attention, force):
    """A BERT layer ('bigbird', or 'sparse' forced onto the block kernels;
    hidden 96, 4 heads, window 32) SGD step on the card and on the CPU from
    one seed: 1 launch of each block kernel, none of the flash kernels, and
    the same loss and parameters."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 256, 96)).astype(np.float32))
    layers = {d: tt.BertAttentionLayer(96, 4, 192, attention, window=32, device=d,
                                       generator=torch.Generator().manual_seed(0))
              for d in ("cpu", cuda)}
    if force:
        for layer in layers.values():
            layer.attention.method = force
    opts = {d: tt.make_train_state(m) for d, m in layers.items()}
    kernels.reset_launch_counts()
    got = tt.bert_train_step(layers[cuda], opts[cuda], x.to(cuda))
    torch.cuda.synchronize()
    counts = kernels.launches_by_kernel()
    assert {n: counts[n] for n in {**NO_FLASH, **NO_BLK}} == {
        **NO_FLASH, "blk_flash_fwd": 1, "blk_flash_dq": 1, "blk_flash_dkv": 1}
    want = tt.bert_train_step(layers["cpu"], opts["cpu"], x)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    for (name, p), (_, q) in zip(layers[cuda].named_parameters(), layers["cpu"].named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), **TOL, msg=name)


# -- the int8 serving tier -------------------------------------------------------

# (m, k, n), blocksize, empty row range ("blocks": whole 128 x 128 blocks,
# each present with probability 0.1, the headline's fill). (64, 128),
# (128, 64) and "blocks" run the pipelined executor, the others the first
# design.
INT8_CASES = {
    "ragged_8x16_n33": ((100, 70, 33), (8, 16), None),
    "ragged_32x8_n130": ((75, 53, 130), (32, 8), None),
    "empty_rowblock_128x128_n200": ((300, 260, 200), (128, 128), (128, 256)),
    "ragged_64x128_n70": ((200, 300, 70), (64, 128), None),
    "empty_rowblock_128x64_n200": ((300, 200, 200), (128, 64), (128, 256)),
    "ragged_8x16_n1": ((100, 70, 1), (8, 16), None),
    "ragged_128x128_n1": ((300, 260, 1), (128, 128), None),
    "blocks_1024sq_128x128_n512": ((1024, 1024, 512), (128, 128), "blocks"),
}


def _int8_operands(name, device):
    (m, k, n), bs, empty = INT8_CASES[name]
    rng = np.random.default_rng(len(name))
    if empty == "blocks":
        a = block_sparse_csr(len(name), (m, k), bs, 0.10, device=device)
    else:
        mask = rng.random((m, k)) < 0.15
        if empty is not None:
            mask[empty[0]:empty[1]] = False
        a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32),
                              device=device)
    plan = tt.build_plan(a, bs)
    qvals, scales = quant.quantize_block_values(plan.pack_values(a.data))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    b_q, t = quant.quantize_columns(b)
    return plan, qvals, scales, b_q, t


@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_spmm_int8_kernel_equals_plain(cuda, name):
    """Both int8 entry points launch the one kernel and equal the plain
    version bit for bit (the epilogue rounds each multiply and add on its
    own, as the plain version does)."""
    plan, qvals, scales, b_q, t = _int8_operands(name, cuda)
    tk.reset_launch_counts()
    got_r = tk.resident_spmm_int8_kernel(plan, qvals, scales, b_q, t)
    got_t = tk.tiled_spmm_int8_kernel(plan, qvals, scales, b_q, t)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**NO_TK, "tiled_spmm_int8": 1, "resident_spmm_int8": 1,
                                  "int8_kmajor": 2}
    want = tk._block_exec_int8_plain(plan, qvals, scales, b_q, t)
    assert got_r.dtype == torch.float32 and got_r.shape == want.shape
    assert torch.equal(got_r, got_t)
    assert torch.equal(got_r, want)


@pytest.mark.parametrize("shape,ldt", [((70, 33), 80), ((1, 1), 16), ((16384, 512), 16384),
                                       ((200, 130), 256)])
def test_int8_kmajor_kernel_equals_plain(cuda, shape, ldt):
    rng = np.random.default_rng(shape[0])
    b_q = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(cuda)
    tk.reset_launch_counts()
    got = tk.int8_kmajor_kernel(b_q, ldt)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**NO_TK, "int8_kmajor": 1}
    assert torch.equal(got, tk._int8_kmajor_plain(b_q, ldt))


# (m, k, n): ragged m, k and n; m under 64 with n under 8; n off a multiple
# of 8; m and n one past a tile edge; k in 64 chunks of 128; k % 16 != 0 (A
# padded) at 4100
GEMM_S8_SHAPES = [(100, 70, 33), (64, 37, 50), (130, 259, 257), (1, 1024, 8), (37, 100, 5),
                  (200, 256, 100), (129, 384, 257), (256, 8192, 320), (1030, 4100, 1030)]


def _int8_pair(m, k, n, device):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(device)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(device)
    return a, b


@pytest.mark.parametrize("shape", GEMM_S8_SHAPES)
def test_gemm_s8_kernel_equals_plain(cuda, shape):
    """Each call makes B K-major (1 int8_kmajor) and runs the kernel (1
    gemm_s8); the int32 result equals the plain version bit for bit."""
    a, b = _int8_pair(*shape, cuda)
    kernels.reset_launch_counts()
    got = gk.gemm_int8_kernel(a, b)
    torch.cuda.synchronize()
    counts = kernels.launches_by_kernel()
    assert counts["gemm_s8"] == 1 and counts["int8_kmajor"] == 1
    assert sum(counts.values()) == 2
    assert got.dtype == torch.int32 and torch.equal(got, gk._gemm_int8_plain(a, b))


# (m, k, n) and the width of C's tiles the kernel takes there: more tiles
# than the card holds blocks at once (at most two an SM), so that each block
# of the persistent grid walks several and the ring's stages and phases
# carry across tiles
GEMM_S8_MULTI_TILE = [((4096, 128, 4096), 256), ((40000, 128, 128), 128)]


@pytest.mark.parametrize("shape,bn", GEMM_S8_MULTI_TILE)
def test_gemm_s8_walks_several_tiles_a_block(cuda, shape, bn):
    m, k, n = shape
    assert gk._s8_tile_n(m, n) == bn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cdiv(m, 128) * cdiv(n, bn) > 2 * sms
    a, b = _int8_pair(m, k, n, cuda)
    assert torch.equal(gk.gemm_int8_kernel(a, b), gk._gemm_int8_plain(a, b))


@pytest.mark.parametrize("k", [64, 40])
def test_gemm_s8_takes_a_that_is_not_16_byte_aligned(cuda, k):
    """A contiguous a whose base is off 16 bytes (a row slice, or a slice
    one byte into a flat tensor): the wrapper hands the kernel an aligned,
    zero-padded copy, and the result is the plain version's."""
    m, n = 70, 48
    big, b = _int8_pair(m + 1, k, n, cuda)
    flat = torch.cat([torch.zeros(1, dtype=torch.int8, device=cuda), big[1:].reshape(-1)])
    assert flat[1:].data_ptr() % 16 != 0
    for a in (big[1:], flat[1:].view(m, k)):
        assert a.is_contiguous()
        assert torch.equal(gk.gemm_int8_kernel(a, b), gk._gemm_int8_plain(a, b))


# (bh, s, d), causal, q_offset, kv_offset
Q8_CASES = {
    "2x3x256x64": ((6, 256, 64), False, 0, 0),
    "causal_1x2x384x64": ((2, 384, 64), True, 0, 0),
    "ragged_1x1x200x64": ((1, 200, 64), False, 0, 0),
    "narrow_2x4x128x24": ((8, 128, 24), False, 0, 0),
    "wide_1x2x128x128": ((2, 128, 128), True, 0, 0),
    "offsets_1x1x256x64_q256": ((1, 256, 64), True, 256, 0),
    "wider_1x2x128x192": ((2, 128, 192), True, 0, 0),
    "wider_ragged_1x1x200x256": ((1, 200, 256), False, 0, 0),
    # s off the 64-row q-tile, d at every instance, offsets together
    "ragged_causal_1x2x200x40": ((2, 200, 40), True, 0, 0),
    "ragged_causal_1x2x1000x64": ((2, 1000, 64), True, 0, 0),
    "d16_1x2x256x16": ((2, 256, 16), True, 0, 0),
    "d96_1x2x256x96": ((2, 256, 96), False, 0, 0),
    "d256_causal_1x2x256x256": ((2, 256, 256), True, 0, 0),
    "d320_chunked_1x2x200x320": ((2, 200, 320), True, 0, 0),
    "offsets_q192_kv64_1x2x256x64": ((2, 256, 64), True, 192, 64),
    "offsets_q100_kv30_1x1x200x40": ((1, 200, 40), True, 100, 30),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(Q8_CASES))
def test_flash_q8_kernel_matches_plain(cuda, name, dtype):
    """p is rounded to bf16 against its tile's running max in the kernel and
    against the row max in the plain version: within FLASH_ROUNDED_LIMIT of
    scale."""
    shape, causal, q_off, kv_off = Q8_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for _ in range(3))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    kw = dict(sm_scale=1 / shape[-1] ** 0.5, causal=causal, q_offset=q_off, kv_offset=kv_off)
    fa.reset_launch_counts()
    got = fa.flash_q8_kernel(q.to(dtype), kq, vq, ks, vs, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_q8"] == 1
    want = fa._flash_q8_plain(q.to(dtype), kq, vq, ks, vs, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _over_scale(got, want) < FLASH_ROUNDED_LIMIT


def test_flash_q8_rows_that_see_no_key_are_zero(cuda):
    q, k, v = (torch.randn(2, 128, 64, device=cuda) for _ in range(3))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    o = fa.flash_q8_kernel(q, kq, vq, ks, vs, sm_scale=0.125, causal=True, kv_offset=100)
    assert torch.count_nonzero(o[:, :100]) == 0 and torch.count_nonzero(o[:, 100:]) > 0


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    plan, qvals, scales, b_q, t = _int8_operands("ragged_8x16_n33", cuda)
    with pytest.raises(TypeError, match="int8"):
        tk.resident_spmm_int8_kernel(plan, qvals.float(), scales, b_q, t)
    with pytest.raises(TypeError, match="t must be float32"):
        tk.tiled_spmm_int8_kernel(plan, qvals, scales, b_q, t[:5].contiguous())
    with pytest.raises(ValueError, match="same device"):
        tk.tiled_spmm_int8_kernel(plan, qvals, scales, b_q, t.cpu())
    a = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        gk.gemm_int8_kernel(a.float(), a.t().contiguous())
    with pytest.raises(ValueError, match="bad shapes"):
        gk.gemm_int8_kernel(a, a)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gemm_int8_kernel(a, a.t())
    q = torch.zeros((1, 64, 32), device=cuda)
    kq = torch.zeros((1, 64, 32), dtype=torch.int8, device=cuda)
    s1 = torch.ones(1, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        fa.flash_q8_kernel(q, q, kq, s1, s1, sm_scale=1.0)
    with pytest.raises(ValueError, match="leading shape"):
        fa.flash_q8_kernel(q, kq, kq, torch.ones(2, device=cuda), s1, sm_scale=1.0)


def test_serving_products_on_card_match_cpu(cuda):
    """The decode products (bf16 operands, fp32 sums and result) on the card
    against the same products on the CPU: both sum the same exact products,
    in other orders."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (256, 96)).astype(np.int8))
    got = serving._dot_bf16(x.to(cuda), w.to(cuda))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), serving._dot_bf16(x, w), rtol=1e-5, atol=1e-3)
    a = torch.from_numpy(rng.standard_normal((2, 4, 1, 64)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-127, 128, (2, 4, 64, 40)).astype(np.int8))
    torch.testing.assert_close(serving._dot_bf16(a.to(cuda), b.to(cuda)).cpu(),
                               serving._dot_bf16(a, b), rtol=1e-5, atol=1e-3)


def test_quantized_gpt_on_card_matches_cpu(cuda):
    """A small QuantizedGPT from one seed on the card and on the CPU: the
    same int8 weights and scales, and logits of a prefill and 3 decode steps
    within 1e-2 of scale (bf16-rounded activations may round apart where two
    fp32 sums differ by an ulp)."""
    gen = torch.Generator().manual_seed(0)
    cpu = tt.GPTDecoder(2, 64, 4, 128, 50, 32, device="cpu", generator=gen)
    card = tt.GPTDecoder(2, 64, 4, 128, 50, 32, device=cuda)
    card.load_state_dict(cpu.state_dict())
    qc, qg = tt.quantize_gpt(cpu), tt.quantize_gpt(card)
    for bc, bg in zip(qc.blocks, qg.blocks):
        for lc, lg in ((bc.qkv, bg.qkv), (bc.fc1, bg.fc1), (bc.fc2, bg.fc2), (bc.o, bg.o)):
            assert torch.equal(lc.qw, lg.qw.cpu()) and torch.equal(lc.sw, lg.sw.cpu())
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 50, (2, 8)))
    kernels.reset_launch_counts()
    with torch.no_grad():
        lc, cc = qc.prefill(ids[:, :4])
        lg, cg = qg.prefill(ids[:, :4].to(cuda))
        assert _over_scale(lg.cpu(), lc) < 1e-2
        for pos in range(4, 7):
            lc, cc = qc.decode_step(ids[:, pos], cc, pos)
            lg, cg = qg.decode_step(ids[:, pos].to(cuda), cg, pos)
            assert _over_scale(lg.cpu(), lc) < 1e-2, pos
    assert not any(kernels.launches_by_kernel().values())


# -- naive SpMM (every reducer) and the graph models ---------------------------------

NAIVE_MODES = [(r, False) for r in ("sum", "mean", "max", "min", "mul", "div")] + [
    ("max", True), ("min", True)]


def _naive_operands(seed, m, k, n, device, b_dtype=torch.float32, ties=False):
    """A CSR with empty rows (every 7th) and one row far longer than the
    rest, and a dense B; with `ties` both from a few small integers."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < 0.1
    mask[::7] = False
    mask[m // 2, : k * 3 // 4] = True  # the long row
    vals = (rng.choice([-2.0, -1.0, 1.0, 2.0], (m, k)) if ties
            else rng.uniform(0.5, 1.5, (m, k)) * rng.choice([-1.0, 1.0], (m, k)))
    a = tt.CSR.from_dense((mask * vals).astype(np.float32), device=device)
    b = (rng.integers(-2, 3, (k, n)) if ties else rng.uniform(0.5, 1.5, (k, n)))
    return a, torch.from_numpy(b.astype(np.float32)).to(device, b_dtype)


@pytest.mark.parametrize("n", [1, 7, 15, 16, 17, 31, 32, 33, 40, 64, 257, 300])
@pytest.mark.parametrize("reduce,return_arg", NAIVE_MODES)
def test_naive_spmm_kernel_equals_plain(cuda, reduce, return_arg, n):
    """Every reducer and arg output, bitwise equal to the plain version: both
    round each product and each update on their own, in slot order. n runs
    over the edges of a lane's 4 columns and of the strips (16-byte rows of
    B take 4 columns a lane, others one); the long row outruns the unroll
    of 8 slots."""
    from tpusparse_torch.kernels import naive_spmm as nk

    a, b = _naive_operands(n, 77, 60, n, cuda, ties=return_arg)
    ell = nk.ell_pack(a)
    nnz = a.nnz if return_arg else 0
    kernels.reset_launch_counts()
    got = nk.naive_spmm_kernel(ell, a.shape, b, reduce=reduce, return_arg=return_arg, nnz=nnz)
    torch.cuda.synchronize()
    assert kernels.launches_by_kernel()["naive_spmm"] == 1
    want = nk._naive_spmm_plain(ell, a.shape, b, reduce=reduce, return_arg=return_arg, nnz=nnz)
    for g, w in zip(got if return_arg else (got,), want if return_arg else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("n", [33, 40, 256])
@pytest.mark.parametrize("reduce,return_arg", NAIVE_MODES)
def test_naive_spmm_kernel_bf16_b(cuda, reduce, return_arg, n):
    """A bf16 B: 8 columns a lane where its rows are whole 16-byte chunks (n
    40, 256), one otherwise (33); bitwise equal to the plain version."""
    from tpusparse_torch.kernels import naive_spmm as nk

    a, b = _naive_operands(3, 50, 40, n, cuda, b_dtype=torch.bfloat16, ties=return_arg)
    ell = nk.ell_pack(a)
    kw = dict(reduce=reduce, return_arg=return_arg, nnz=a.nnz if return_arg else 0)
    got = nk.naive_spmm_kernel(ell, a.shape, b, **kw)
    want = nk._naive_spmm_plain(ell, a.shape, b, **kw)
    for g, w in zip(got if return_arg else (got,), want if return_arg else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strip_cols", [8, 16, 32])
@pytest.mark.parametrize("n", [16, 17, 40, 64, 257])
@pytest.mark.parametrize("reduce,return_arg", [("sum", False), ("div", False), ("max", True)])
def test_naive_spmm_strips_equal_plain(cuda, reduce, return_arg, n, strip_cols, b_dtype):
    """Strips of B narrower than n, fixed: every strip of a row, the last one
    partly past n, bitwise equal to the plain version."""
    from tpusparse_torch.kernels import naive_spmm as nk

    a, b = _naive_operands(n, 77, 60, n, cuda, b_dtype=b_dtype, ties=return_arg)
    ell = nk.ell_pack(a)
    nnz = a.nnz if return_arg else 0
    kernels.reset_launch_counts()
    got = nk._naive_spmm_strips(ell, a.shape, b, reduce, return_arg, nnz, strip_cols)
    torch.cuda.synchronize()
    assert kernels.launches_by_kernel()["naive_spmm"] == 1
    want = nk._naive_spmm_plain(ell, a.shape, b, reduce=reduce, return_arg=return_arg, nnz=nnz)
    for g, w in zip(got if return_arg else (got,), want if return_arg else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_naive_spmm_refuses_a_strip_it_cannot_walk(cuda):
    """A strip that is no power of two of lanes raises; the wrapper does not
    fall back."""
    from tpusparse_torch.kernels import naive_spmm as nk

    a, b = _naive_operands(2, 20, 16, 64, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        nk._naive_spmm_strips(nk.ell_pack(a), a.shape, b, "sum", False, 0, 12)


def test_naive_spmm_gradient_on_card_matches_cpu(cuda):
    a, b = _naive_operands(4, 40, 30, 9, "cpu")
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((40, 9)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        data = a.data.to(dev).clone().requires_grad_(True)
        bb = b.to(dev).clone().requires_grad_(True)
        out = tt.naive_spmm(tt.CSR(data, a.indices, a.indptr, a.shape), bb)
        out.backward(g.to(dev))
        grads[str(dev)] = (out.detach().cpu(), data.grad.cpu(), bb.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, **TOL)


def test_gcn_train_step_on_card_matches_cpu(cuda):
    """A small GCN on the naive route: 2 naive_spmm launches a step (one per
    layer; Â's values need no gradient), loss and parameters card against
    CPU after 3 Adam steps."""
    adj = tt.random_graph(0, 120, avg_degree=4.0, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((120, 24)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, 120))
    mask = torch.from_numpy((rng.random(120) < 0.3).astype(np.float32))
    from tpusparse_torch.models import gcn

    runs = {}
    for dev in ("cpu", cuda):
        a_hat = tt.normalized_adjacency(tt.CSR(adj.data.to(dev), adj.indices, adj.indptr,
                                               adj.shape))
        model = tt.GCN(24, hidden=(16,), num_classes=5, spmm_method="naive", device=dev,
                       generator=torch.Generator().manual_seed(0))
        opt = gcn.make_train_state(model)
        kernels.reset_launch_counts()
        losses = [float(gcn.train_step(model, opt, a_hat, x.to(dev), labels.to(dev),
                                       mask.to(dev))) for _ in range(3)]
        if dev == cuda:
            assert kernels.launches_by_kernel()["naive_spmm"] == 6
        runs[str(dev)] = (losses, [p.detach().cpu() for p in model.parameters()])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], **TOL)
    for got, want in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# -- the batched executor and the executors of the derived plans ---------------------

# name: (m, k, n), blocksize, batch, empty row range: the n-major tile at
# bm 5, 8, 24 and 32 (N 8, 8, 24, 32), the 64-row tile at bm 72 (two
# warpgroups; n 64 on the raw ring's 8-byte copies) and 128; n 1 to 200
PLAN_EXEC_CASES = {
    "ragged_8x32_n130_b3": ((100, 70, 130), (8, 32), 3, (16, 40)),
    "ragged_32x16_n33_b5": ((75, 53, 33), (32, 16), 5, None),
    "rowblock_128x128_n200_b1": ((300, 260, 200), (128, 128), 1, (128, 256)),
    "bm5_n1_b4": ((43, 37, 1), (5, 8), 4, (10, 20)),
    "bm24_n130_b2": ((100, 70, 130), (24, 16), 2, (24, 48)),
    "bm72_n64_b3": ((150, 90, 64), (72, 32), 3, (72, 144)),
}
PLAN_EXEC_TIERS = [(torch.float32, "high"), (torch.float32, "default"),
                   (torch.bfloat16, "high")]


def _ffma_pair_base(entry, plan, data, b, precision=None):
    """The bitwise base of the grouped or the footprint executor: the other
    one of the two FFMA executors (window_tiles.cuh's chain) on the same
    base plan, groups and supers of 4 row-blocks. It is held within the tier
    of the tensor-core `tiled_spmm_kernel`, which sums in another order."""
    if entry == "grouped_spmm":
        dp, fn = tt.footprint_plan(plan, 4), tk.footprint_spmm_kernel
    else:
        dp, fn = tt.group_plan(plan, 4), tk.grouped_spmm_kernel
    base = fn(dp, dp.pack_values(data), b, precision=precision)
    tc = tk.tiled_spmm_kernel(plan, plan.pack_values(data), b, precision=precision)
    tol = TOL_BF16 if base.dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(base.float(), tc.float(), **tol)
    return base


def _plan_exec_inputs(name, device, dtype):
    (m, k, n), bs, batch, empty = PLAN_EXEC_CASES[name]
    rng = np.random.default_rng(6)
    mask = rng.random((m, k)) < 0.1
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32),
                          device=device)
    plan = tt.build_plan(a, bs)
    b3 = torch.from_numpy(rng.standard_normal((batch, k, n)).astype(np.float32))
    return a, plan, b3.to(device, dtype)


@pytest.mark.parametrize("dtype,precision", PLAN_EXEC_TIERS)
@pytest.mark.parametrize("name", sorted(PLAN_EXEC_CASES))
def test_batched_kernel_matches_plain_and_2d_kernel_bitwise(cuda, name, dtype, precision):
    """C bitwise equal to the 2-D kernel on the folded (k, batch·n)
    operand (one body, one tile chooser), to a second call and to the 2-D
    kernel on each B[g] alone (each element summed in one order); within
    the tier of the plain version."""
    a, plan, b3 = _plan_exec_inputs(name, cuda, dtype)
    bv = plan.pack_values(a.data.to(dtype))
    tk.reset_launch_counts()
    got = tk.resident_spmm_batched_kernel(plan, bv, b3, precision=precision)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**NO_TK, "resident_spmm_batched": 1}
    tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL
    assert torch.equal(got, tk.resident_spmm_batched_kernel(plan, bv, b3, precision=precision))
    folded = tt.ops._fold_batch(
        lambda bb: tk.tiled_spmm_kernel(plan, bv, bb, precision=precision), b3)
    assert torch.equal(got, folded)
    for g in range(b3.shape[0]):
        assert torch.equal(got[g], tk.tiled_spmm_kernel(plan, bv, b3[g].contiguous(),
                                                        precision=precision))
    want = tk._block_exec_batched_plain(plan, bv, b3, precision=precision)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _derived_plans(plan):
    return (("compact_spmm", tt.compact_plan(plan), tk.compact_spmm_kernel, tk._compact_plain),
            ("grouped_spmm", tt.group_plan(plan, 4), tk.grouped_spmm_kernel, tk._grouped_plain),
            ("footprint_spmm", tt.footprint_plan(plan, 4), tk.footprint_spmm_kernel,
             tk._footprint_plain))


@pytest.mark.parametrize("dtype,precision", PLAN_EXEC_TIERS)
@pytest.mark.parametrize("name", sorted(PLAN_EXEC_CASES))
def test_plan_executors_match_plain_and_block_ell_bitwise(cuda, name, dtype, precision):
    """compact: bitwise equal to block_ell_spmm on the base plan (one body,
    one slot order) and to a second call; grouped and footprint: bitwise
    equal to each other (one FFMA chain; `_ffma_pair_base`, itself within
    the tier of block_ell_spmm); each within the tier of its plain version;
    empty row-blocks written as zeros."""
    a, plan, b3 = _plan_exec_inputs(name, cuda, dtype)
    b = b3[0].contiguous()
    data = a.data.to(dtype)
    tc = tk.tiled_spmm_kernel(plan, plan.pack_values(data), b, precision=precision)
    for entry, dp, fn, plain in _derived_plans(plan):
        bv = dp.pack_values(data)
        tk.reset_launch_counts()
        got = fn(dp, bv, b, precision=precision)
        torch.cuda.synchronize()
        assert tk.launch_counts() == {**NO_TK, entry: 1}
        if entry == "compact_spmm":
            assert torch.equal(got, tc), entry
            assert torch.equal(got, fn(dp, bv, b, precision=precision)), entry
        else:
            assert torch.equal(got, _ffma_pair_base(entry, plan, data, b, precision)), entry
        want = plain(dp, bv, b, precision=precision)
        tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL
        torch.testing.assert_close(got.float(), want.float(), **tol, msg=entry)


def test_footprint_kernel_takes_every_n_tile(cuda):
    """n of 5, 20, 40 and 300 (one to five 64-column n-tiles, ragged) and
    S 16 with 128 x 128 blocks (a super of 16 windows): each bitwise equal
    to the grouped executor on the base plan (`_ffma_pair_base`)."""
    a, plan, _ = _plan_exec_inputs("ragged_8x32_n130_b3", cuda, torch.float32)
    rng = np.random.default_rng(8)
    for n in (5, 20, 40, 300):
        b = torch.from_numpy(rng.standard_normal((a.shape[1], n)).astype(np.float32)).to(cuda)
        fp = tt.footprint_plan(plan, 4)
        got = tk.footprint_spmm_kernel(fp, fp.pack_values(a.data), b)
        assert torch.equal(got, _ffma_pair_base("footprint_spmm", plan, a.data, b)), n
    a, plan, b3 = _plan_exec_inputs("rowblock_128x128_n200_b1", cuda, torch.float32)
    fp = tt.footprint_plan(plan, 16)
    assert tk.footprint_tile(fp) == 16
    b = b3[0].contiguous()
    assert torch.equal(tk.footprint_spmm_kernel(fp, fp.pack_values(a.data), b),
                       _ffma_pair_base("footprint_spmm", plan, a.data, b))


# (m, k, n), blocksize, rows_per_super, rows left empty: a super of 16
# 128-row row-blocks over 16 windows (the second super half full); S 5
# of 48-row blocks (240 rows: the second window of a super is partial and
# cuts a row-block); a super of S 4 whose rows are all empty
FOOTPRINT_CASES = {
    "s16_128x128_16_windows": ((3072, 640, 130), (128, 128), 16, None),
    "s5_48x32_off_the_window": ((1000, 300, 70), (48, 32), 5, None),
    "s4_32x16_empty_super": ((500, 200, 33), (32, 16), 4, (128, 256)),
}


# (m, k, n), blocksize, group_size, rows left empty: one grouped window per
# row-block at bm 8 (a whole group of 4 empty), 64 and 128 (a whole group
# of 2 empty), two windows per row-block at bm 200 (one row-block empty);
# m and n ragged
GROUPED_CASES = {
    "bm8_empty_group": ((203, 150, 77), (8, 32), 4, (32, 64)),
    "bm64_ragged": ((300, 200, 130), (64, 16), 2, (64, 128)),
    "bm128_empty_group": ((520, 260, 70), (128, 128), 2, (256, 512)),
    "bm200_two_windows": ((610, 150, 33), (200, 16), 2, (200, 400)),
}


@pytest.mark.parametrize("dtype,precision", PLAN_EXEC_TIERS)
@pytest.mark.parametrize("name", sorted(GROUPED_CASES))
def test_grouped_windows_bitwise(cuda, name, dtype, precision):
    """The grouped kernel's windows (one row-block each, or slices of a
    taller one): bitwise equal to the footprint executor on the base plan
    (`_ffma_pair_base`), row-blocks with no slot written as zeros, within
    the tier of its plain version, one launch."""
    (m, k, n), bs, G, empty = GROUPED_CASES[name]
    rng = np.random.default_rng(m + G)
    mask = rng.random((m, k)) < 0.08
    mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=cuda)
    plan = tt.build_plan(a, bs)
    gp = tt.group_plan(plan, G)
    assert tk.grouped_tile(gp, n)["slices"] == (2 if bs[0] > 128 else 1)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda, dtype)
    base = _ffma_pair_base("grouped_spmm", plan, a.data.to(dtype), b, precision)
    bv = gp.pack_values(a.data.to(dtype))
    tk.reset_launch_counts()
    got = tk.grouped_spmm_kernel(gp, bv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**NO_TK, "grouped_spmm": 1}
    assert torch.equal(got, base)
    assert int(torch.count_nonzero(got[empty[0]:min(empty[1], m)])) == 0
    want = tk._grouped_plain(gp, bv, b, precision=precision)
    tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype,precision", PLAN_EXEC_TIERS)
@pytest.mark.parametrize("name", sorted(FOOTPRINT_CASES))
def test_footprint_windows_bitwise(cuda, name, dtype, precision):
    """The footprint kernel's windows at their edges: bitwise equal to the
    grouped executor on the base plan (`_ffma_pair_base`), within the tier
    of its plain version, one launch."""
    (m, k, n), bs, S, empty = FOOTPRINT_CASES[name]
    rng = np.random.default_rng(m + S)
    mask = rng.random((m, k)) < 0.08
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=cuda)
    plan = tt.build_plan(a, bs)
    fp = tt.footprint_plan(plan, S)
    if empty is not None:
        assert int(fp.nslots[1]) == 0
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda, dtype)
    base = _ffma_pair_base("footprint_spmm", plan, a.data.to(dtype), b, precision)
    bv = fp.pack_values(a.data.to(dtype))
    tk.reset_launch_counts()
    got = tk.footprint_spmm_kernel(fp, bv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**NO_TK, "footprint_spmm": 1}
    assert torch.equal(got, base)
    want = tk._footprint_plain(fp, bv, b, precision=precision)
    tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_batched_train_step_launches_and_matches_cpu(cuda):
    """One step of tiled_spmm(a, b3) with grads in a.data and b3: 1 batched
    forward, 1 sddmm (dA over the folded batch), 1 batched dB; its output
    and gradients on the card against the CPU."""
    a, _, b3 = _plan_exec_inputs("ragged_32x16_n33_b5", "cpu", torch.float32)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b3.shape[0], a.shape[0], b3.shape[2])).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        data = a.data.to(dev).clone().requires_grad_(True)
        bb = b3.to(dev).clone().requires_grad_(True)
        kernels.reset_launch_counts()
        out = tt.tiled_spmm(tt.CSR(data, a.indices, a.indptr, a.shape), bb, blocksize=(32, 16))
        out.backward(g.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.launches_by_kernel() == {
                **{n: 0 for n in kernels.launches_by_kernel()},
                "resident_spmm_batched": 2, "sddmm": 1}
        runs[str(dev)] = (out.detach().cpu(), data.grad.cpu(), bb.grad.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("method", [None, "tiled", "resident"])
@pytest.mark.parametrize("b_shape", [(3, 9, 1), (2, 2, 9, 1)])
def test_batched_n1_backward_on_card_matches_cpu(cuda, b_shape, method):
    """A batched b with one column: d(values) and dB of sum(spmm(A, b)) on
    the card against the CPU (the batch folded into columns at n = 1 is
    copied before the SDDMM of dA takes it)."""
    import scipy.sparse

    dense = scipy.sparse.random(9, 9, 0.5, random_state=18, dtype=np.float32).toarray()
    a = tt.CSR.from_dense(dense, device="cpu")
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(b_shape).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        data = a.data.to(dev).clone().requires_grad_(True)
        bb = b.to(dev).clone().requires_grad_(True)
        tt.spmm(tt.CSR(data, a.indices, a.indptr, a.shape), bb, method=method).sum().backward()
        runs[str(dev)] = (data.grad.cpu(), bb.grad.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)


def test_footprint_train_step_launches_and_matches_cpu(cuda):
    """One step of spmm(method='footprint'): 1 footprint_spmm forward, 1
    sddmm (dA) and 1 block_ell_spmm (dB on the transpose plan); card
    against CPU."""
    a, _, b3 = _plan_exec_inputs("ragged_8x32_n130_b3", "cpu", torch.float32)
    b = b3[0]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (a.shape[0], b.shape[1])).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        data = a.data.to(dev).clone().requires_grad_(True)
        bb = b.to(dev).clone().requires_grad_(True)
        kernels.reset_launch_counts()
        out = tt.spmm(tt.CSR(data, a.indices, a.indptr, a.shape), bb, method="footprint",
                      blocksize=(8, 32))
        out.backward(g.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.launches_by_kernel() == {
                **{n: 0 for n in kernels.launches_by_kernel()},
                "footprint_spmm": 1, "sddmm": 1, "block_ell_spmm": 1}
        runs[str(dev)] = (out.detach().cpu(), data.grad.cpu(), bb.grad.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)


def test_batched_kernel_chunks_batches_past_the_grid_limit(cuda):
    """A batch of 65,536 + 7, past the grid's y and z limits: one launch
    over the batch folded into columns, each batch element bitwise equal
    to the 2-D kernel on that element alone."""
    a, plan, _ = _plan_exec_inputs("ragged_32x16_n33_b5", cuda, torch.float32)
    bv = plan.pack_values(a.data)
    b3 = torch.randn(65536 + 7, a.shape[1], 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    tk.reset_launch_counts()
    got = tk.resident_spmm_batched_kernel(plan, bv, b3)
    torch.cuda.synchronize()
    assert tk.launch_counts()["resident_spmm_batched"] == 1
    for g in (0, 65534, 65535, 65536, 65542):
        assert torch.equal(got[g], tk.tiled_spmm_kernel(plan, bv, b3[g].contiguous())), g


# row-blocks of at most this many rows take the n-major tile
NMAJOR_MAX_BM = int(re.search(
    r"constexpr int NMAJOR_MAX_BM = (\d+);",
    (Path(tk.__file__).resolve().parents[1] / "csrc" / "block_ell_spmm.cuh").read_text()).group(1))


@pytest.mark.parametrize("dtype,precision", PLAN_EXEC_TIERS)
@pytest.mark.parametrize("bm", [5, 8, 24, NMAJOR_MAX_BM, NMAJOR_MAX_BM + 1])
def test_nmajor_and_row_tiles_agree_within_the_tier(cuda, bm, dtype, precision):
    """Row-blocks on both sides of the tile chooser's border: the n-major
    tile (bm <= NMAJOR_MAX_BM) and the 64-row tile (bm = NMAJOR_MAX_BM +
    1) each within the tier of the plain version, the 2-D, batched and
    compact executors bitwise equal."""
    rng = np.random.default_rng(bm)
    m, k, n = 7 * bm + 3, 90, 100
    mask = rng.random((m, k)) < 0.15
    a = tt.CSR.from_dense((mask * rng.standard_normal((m, k))).astype(np.float32), device=cuda)
    plan = tt.build_plan(a, (bm, 16))
    cp = tt.compact_plan(plan)
    bv, cv = plan.pack_values(a.data.to(dtype)), cp.pack_values(a.data.to(dtype))
    b3 = torch.from_numpy(rng.standard_normal((2, k, n)).astype(np.float32)).to(cuda, dtype)
    want = tk._block_exec_plain(plan, bv, b3[1].contiguous(), precision=precision)
    tol = TOL_BF16 if want.dtype == torch.bfloat16 else TOL
    c2 = tk.tiled_spmm_kernel(plan, bv, b3[1].contiguous(), precision=precision)
    cb = tk.resident_spmm_batched_kernel(plan, bv, b3, precision=precision)[1]
    cc = tk.compact_spmm_kernel(cp, cv, b3[1].contiguous(), precision=precision)
    assert torch.equal(c2, cb) and torch.equal(c2, cc)
    torch.testing.assert_close(c2.float(), want.float(), **tol)


# -- the windowed gather and segment sum, and SpGEMM -----------------------------

# name: (n or n_in, table length or segment count, kind of map)
WINDOWED_CASES = {
    "local_far_outliers": (5000, 900, "local"),
    "single_far_read": (4096, 4096, "one_far"),
    "scattered": (2000, 50000, "scattered"),
    "empty_segments_ragged": (1030, 601, "half_empty"),
    "short_table": (1000, 40, "scattered"),
    "wide_window": (7000, 1100, "local"),  # the segment plan takes W = 4096
}


def _windowed_map(name):
    n, t, kind = WINDOWED_CASES[name]
    rng = np.random.default_rng(5)
    if kind == "scattered":
        idx = rng.integers(0, t, n)
    elif kind == "half_empty":
        idx = np.sort(rng.integers(0, t // 2, n))
    else:
        idx = np.minimum((np.arange(n) * t) // n + rng.integers(0, 40, n), t - 1)
        if kind == "one_far":
            idx[7] = t - 1
        else:
            idx[rng.integers(0, n, 25)] = rng.integers(0, t, 25)
    return idx, t, rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(WINDOWED_CASES))
def test_windowed_gather_kernel_equals_plain_bitwise(cuda, name, dtype):
    from tpusparse_torch.kernels import windowed as wk

    idx, t, rng = _windowed_map(name)
    plan = wk.windowed_gather_plan(idx, t)
    table = torch.from_numpy(rng.normal(size=t).astype(np.float32)).to(dtype)
    table[:3] = -0.0
    args = (plan.tensor("rel", cuda), plan.tensor("starts", cuda))
    wk.reset_launch_counts()
    got = wk.windowed_gather_kernel(table.to(cuda), *args, n=plan.n, window=plan.window)
    torch.cuda.synchronize()
    assert wk.launch_counts() == {"windowed_gather": 1, "windowed_segsum": 0}
    want = wk._gather_plain(table.to(cuda), *args, n=plan.n, window=plan.window)
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32 else torch.int32),
                       want.view(torch.int16 if dtype != torch.float32 else torch.int32))
    full = wk.windowed_gather(table.to(cuda), plan)
    assert torch.equal(full.cpu(), wk.windowed_gather(table, plan))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(WINDOWED_CASES))
def test_windowed_segsum_kernel_equals_plain_bitwise(cuda, name, dtype):
    """The plain version sums in the kernel's order, so the two are equal
    bit for bit. In fp32 the whole operation, exceptions added by index_add_
    on the card, stays within the fp32 tier of the CPU's; in bf16 and fp16
    the exception path adds in the table's dtype, in another order on the
    card than on the CPU, so only the kernel's part is held there."""
    from tpusparse_torch.kernels import windowed as wk

    seg, s, rng = _windowed_map(name)
    plan = wk.windowed_segment_plan(seg, s)
    y = torch.from_numpy(rng.normal(size=seg.size).astype(np.float32)).to(dtype)
    args = (plan.tensor("seg_masked", cuda), plan.tensor("starts", cuda))
    wk.reset_launch_counts()
    got = wk.windowed_segsum_kernel(y.to(cuda), *args, num_segments=s, window=plan.window)
    torch.cuda.synchronize()
    assert wk.launch_counts() == {"windowed_gather": 0, "windowed_segsum": 1}
    want = wk._segsum_plain(y.to(cuda), *args, num_segments=s, window=plan.window)
    assert torch.equal(got.float(), want.float())
    if dtype == torch.float32:
        torch.testing.assert_close(wk.windowed_segment_sum(y.to(cuda), plan).cpu(),
                                   wk.windowed_segment_sum(y, plan), **TOL)


def test_windowed_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from tpusparse_torch.kernels import windowed as wk

    rel = torch.zeros(1024, dtype=torch.int32, device=cuda)
    starts = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        wk.windowed_gather_kernel(torch.zeros(10, device=cuda, dtype=torch.float64), rel,
                                  starts, n=10, window=128)
    with pytest.raises(ValueError, match="same device"):
        wk.windowed_gather_kernel(torch.zeros(10, device=cuda), rel.cpu(), starts, n=10,
                                  window=128)


def test_spgemm_forward_backward_on_card_matches_cpu(cuda):
    """A @ A at 1024² (0.5 %) with grads in both operands' values: the card
    launches exactly the windowed kernels its plan adopted, and C, dA and
    dB agree with the CPU run of the same plan at the fp32 tier."""
    from tpusparse_torch.kernels import windowed as wk

    a = tt.random_csr(3, (1024, 1024), 0.005, device="cpu")
    plan = tt.spgemm_plan(a, a)
    assert plan.ws_c is not None and plan.wg_a is not None and plan.wg_c is not None
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(plan.c_nnz).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        x = tt.CSR(a.data.to(dev).clone().requires_grad_(True), a.indices, a.indptr, a.shape)
        y = tt.CSR(a.data.to(dev).clone().requires_grad_(True), a.indices, a.indptr, a.shape)
        wk.reset_launch_counts()
        c = x @ y
        c.data.backward(g.to(dev))
        if dev == cuda:
            torch.cuda.synchronize()
            gathers = 2 * (plan.wg_a is not None) + 2 * (plan.wg_b is not None) + 1
            assert wk.launch_counts() == {"windowed_gather": gathers, "windowed_segsum": 1}
        runs[str(dev)] = (c.data.detach().cpu(), x.data.grad.cpu(), y.data.grad.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)


# m, k, diagonals, offsets' range, data dtype, x dtype[, zero pattern]
DIA_CASES = {
    "square_200": (700, 700, 200, (-650, 650), torch.float32, torch.float32),
    "rect_tall_129": (900, 640, 129, (-850, 600), torch.float32, torch.float32),
    "rect_wide_150": (600, 880, 150, (-500, 850), torch.float32, torch.float32),
    "past_both_edges_7": (513, 513, 7, (-900, 900), torch.float32, torch.float32),
    "bf16_plane_fp32_x": (1000, 1000, 300, (-990, 990), torch.bfloat16, torch.float32),
    "bf16_both": (777, 777, 160, (-700, 700), torch.bfloat16, torch.bfloat16),
    "fp32_plane_bf16_x": (640, 640, 140, (-600, 600), torch.float32, torch.bfloat16),
    "one_diagonal": (300, 300, 1, (-5, 5), torch.float32, torch.float32),
    # planes with whole zero 32-row tiles (the tile list's case)
    "band_10pct_tiles": (1024, 1024, 200, (-1000, 1000), torch.float32, torch.float32, "band"),
    "band_m_not_32_multiple": (1003, 990, 120, (-900, 900), torch.float32, torch.float32, "band"),
    "neg_zero_tile": (700, 700, 150, (-650, 650), torch.float32, torch.float32, "neg_zero"),
    "nan_in_occupied_tile": (700, 700, 150, (-650, 650), torch.float32, torch.float32, "nan"),
    "band_bf16_both": (777, 800, 160, (-700, 700), torch.bfloat16, torch.bfloat16, "band"),
}


def _dia_inputs(name, device):
    m, k, nd, (lo, hi), ddt, xdt, *pattern = DIA_CASES[name]
    rng = np.random.default_rng(nd + m)
    offs = np.sort(rng.choice(np.arange(lo, hi), nd, replace=False)).astype(np.int64)
    data = rng.standard_normal((nd, m)).astype(np.float32)
    tile_of = np.arange(m) // 32
    ntiles = int(tile_of[-1]) + 1
    if pattern == ["band"]:  # row d holds entries in a band of ~10 % of the tiles
        for d in range(nd):
            data[d, np.abs(tile_of - (d * ntiles) // nd) > max(1, ntiles // 20)] = 0.0
    elif pattern == ["neg_zero"]:  # whole tiles of -0.0 and of +0.0
        data[::3, tile_of % 4 == 1] = -0.0
        data[1::3, tile_of % 4 == 2] = 0.0
    elif pattern == ["nan"]:
        data[5, 70] = np.nan
        data[6:, tile_of % 2 == 0] = 0.0
    data = torch.from_numpy(data).to(device, ddt)
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(device, xdt)
    return offs, data, x


@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_dia_spmv_kernel_equals_plain_bitwise(cuda, name):
    from tpusparse_torch.kernels import dia as dk

    offs, data, x = _dia_inputs(name, cuda)
    plane, p_offs = dk._pack_dia(data, offs)
    o = dk._offsets_tensor(p_offs, cuda)
    dk.reset_launch_counts()
    got = dk.dia_spmv_kernel(plane, o, x)
    torch.cuda.synchronize()
    assert dk.launch_counts() == {"dia_spmv": 1, "dia_nonfinite": 0}
    want = dk._dia_spmv_plain(plane, o, x)
    assert got.dtype == torch.float32 and torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32))
    torch.testing.assert_close(got.cpu(), dk._dia_spmv_plain(plane.cpu(), o.cpu(), x.cpu()),
                               **TOL, equal_nan=True)


def _poison_skipped(plane, p_offs, x, value):
    """Zero every 32-row tile whose terms reach x[j] for one j, then set x[j]
    to `value`: only skipped terms meet it. Returns the rows it reaches."""
    m, k = plane.shape[1], x.shape[0]
    j = k // 2
    rows = []
    for d, off in enumerate(p_offs):
        i = j - int(off)
        if 0 <= i < m:
            plane[d, (i // 32) * 32:(i // 32) * 32 + 32] = 0.0
            rows.append(i)
    x[j] = value
    return rows


@pytest.mark.parametrize("x_case", ["finite", "nan_skipped", "inf_skipped"])
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_dia_spmv_tile_list_equals_plain_bitwise(cuda, name, x_case):
    """The kernel walking the plane's tile list equals the plain version bit
    for bit, NaN rows included: zero tiles, -0.0 tiles, a NaN in an occupied
    tile, and a NaN or +Inf in x that only skipped terms meet."""
    from tpusparse_torch.kernels import dia as dk

    offs, data, x = _dia_inputs(name, cuda)
    plane, p_offs = dk._pack_dia(data, offs)
    plane = plane.clone()
    rows = []
    if x_case != "finite":
        rows = _poison_skipped(plane, p_offs, x, float("nan" if x_case == "nan_skipped"
                                                       else "inf"))
    o = dk._offsets_tensor(p_offs, cuda)
    tiles = dk.dia_tile_list(plane, o)
    dk.reset_launch_counts()
    got = dk.dia_spmv_kernel(plane, o, x, tiles)
    torch.cuda.synchronize()
    assert dk.launch_counts() == {"dia_spmv": 1, "dia_nonfinite": 1}
    want = dk._dia_spmv_plain(plane, o, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(got[rows]).all())
    if DIA_CASES[name][6:] == ("band",):
        assert tiles.nocc < 0.2 * plane.shape[0] * tiles.ptr.shape[0]


def test_packed_dia_rebuilds_its_tile_list_on_the_card(cuda):
    """PackedDIA builds its list at the first mv and keeps it; a plane changed
    in place between two mvs gets a new list, and each mv (one launch)
    equals the plain version of the plane it sees."""
    from tpusparse_torch.kernels import dia as dk

    offs, data, x = _dia_inputs("band_10pct_tiles", cuda)
    m = data.shape[1]
    p = dk.pack_dia_operator(data, offs, (m, x.shape[0]))
    o = p._offsets_on(cuda)
    for step in range(3):
        dk.reset_launch_counts()
        got = p.mv(x)
        torch.cuda.synchronize()
        assert dk.launch_counts() == {"dia_spmv": 1, "dia_nonfinite": 1}
        want = dk._dia_spmv_plain(p.data, o, x)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), step
        tiles = p.tiles()
        assert step == 0 or tiles is not first
        if step == 0:
            p.data[:, 512:544] = 1.5  # fill a column of tiles that was mostly empty
        elif step == 1:
            assert tiles.nocc > first.nocc
            p.data[:, :64] = 0.0
        first = tiles


def test_packed_dia_trainable_plane_sees_a_write_through_data(cuda):
    """A PackedDIA whose plane requires grad walks every diagonal (no list,
    no check launch), so a manual SGD step through `.data`, which leaves the
    plane's version counter as it was, shows in the next mv; each mv equals
    the plain version bitwise."""
    from tpusparse_torch.kernels import dia as dk

    offs, data, x = _dia_inputs("band_10pct_tiles", cuda)
    m = data.shape[1]
    p = dk.pack_dia_operator(data.clone().requires_grad_(True), offs, (m, x.shape[0]))
    o = p._offsets_on(cuda)
    for step in range(2):
        dk.reset_launch_counts()
        got = p.mv(x)
        torch.cuda.synchronize()
        assert dk.launch_counts() == {"dia_spmv": 1, "dia_nonfinite": 0}
        want = dk._dia_spmv_plain(p.data.detach(), o, x)
        assert torch.equal(got.detach().view(torch.int32), want.view(torch.int32)), step
        version = p.data._version
        p.data.data[:, 512:544] -= 0.25  # fills a column of tiles that was mostly empty
        assert p.data._version == version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 1000, 1025, 31868])
def test_dia_nonfinite_kernel_equals_plain(cuda, k, dtype):
    """The nonfinite check launched alone sets the flags its plain version
    does (one per slice of x), with a NaN and an Inf placed or not; one
    launch a call."""
    from tpusparse_torch.kernels import dia as dk

    x = torch.from_numpy(np.random.default_rng(k).standard_normal(k).astype(np.float32))
    x = x.to(cuda, dtype)
    for poison in (False, True):
        if poison:
            x[k - 1] = float("inf")
            x[(k // 3) % k] = float("nan")
        dk.reset_launch_counts()
        got = dk.dia_nonfinite_kernel(x)
        torch.cuda.synchronize()
        assert dk.launch_counts() == {"dia_spmv": 0, "dia_nonfinite": 1}
        want = dk._nonfinite_plain(x)
        assert torch.equal(got, want) and bool(want.any()) == poison


# name: (index map maker, cap); run in fp32, bf16 and fp16
def _seg_amg(rng):  # AMG-shaped: unsorted aggregation ids, windows of thousands
    g = np.indices((48, 48, 24)).reshape(3, -1).T // np.array((3, 3, 2))
    na = (16, 16, 12)
    ids = (g[:, 0] * na[1] + g[:, 1]) * na[2] + g[:, 2]
    return np.argsort(np.arange(3072) + rng.integers(0, 600, 3072))[ids], 3072


SEGSUM_CASES = {
    "amg_unsorted_cap16384": (_seg_amg, 16384),
    "one_segment_owns_a_window": (lambda rng: (np.zeros(16384, np.int64), 5), 16384),
    "sorted_spgemm_shaped": (lambda rng: (np.sort(rng.integers(0, 20000, 20500)), 20000), 4096),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(SEGSUM_CASES) + ["all_ids_minus_one"])
def test_windowed_segsum_groups_windows_bitwise(cuda, name, dtype):
    """The segment sum bit for bit against its plain version on an unsorted
    AMG-shaped map at cap 16384, one segment owning a whole 16,384-entry
    window, a sorted SpGEMM-shaped map and a map of -1 only; one launch."""
    from tpusparse_torch.kernels import windowed as wk

    rng = np.random.default_rng(9)
    if name == "all_ids_minus_one":
        n_in, s, window = 5000, 700, 4096
        seg = torch.full((n_in,), -1, dtype=torch.int32, device=cuda)
        starts = torch.zeros(8, dtype=torch.int32, device=cuda)
    else:
        build, cap = SEGSUM_CASES[name]
        ids, s = build(rng)
        plan = wk.windowed_segment_plan(ids, s, cap=cap)
        n_in, window = ids.size, plan.window
        seg, starts = plan.tensor("seg_masked", cuda), plan.tensor("starts", cuda)
        if name != "sorted_spgemm_shaped":
            assert window > 4096
    y = torch.from_numpy(rng.normal(size=n_in).astype(np.float32)).to(cuda, dtype)
    wk.reset_launch_counts()
    got = wk.windowed_segsum_kernel(y, seg, starts, num_segments=s, window=window)
    torch.cuda.synchronize()
    assert wk.launch_counts() == {"windowed_gather": 0, "windowed_segsum": 1}
    want = wk._segsum_plain(y, seg, starts, num_segments=s, window=window)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    if name == "all_ids_minus_one":
        assert not bool(got.any())


@pytest.mark.parametrize("window", [256, 2048])
def test_windowed_segsum_takes_negative_starts(cuda, window):
    """Spans whose window starts before position 0 (the kernel takes any
    int32 start, as its plain version does): the positions below 0 are
    skipped, and the sums equal the plain version bit for bit."""
    from tpusparse_torch.kernels import windowed as wk

    rng = np.random.default_rng(window)
    n_in, s = 3000, 300
    seg = torch.from_numpy(rng.integers(-1, s, n_in).astype(np.int32)).to(cuda)
    starts = torch.from_numpy(np.array([-window // 2, 1000 - window, 2500 - window // 2],
                                       np.int32)).to(cuda)
    y = torch.from_numpy(rng.normal(size=n_in).astype(np.float32)).to(cuda)
    got = wk.windowed_segsum_kernel(y, seg, starts, num_segments=s, window=window)
    want = wk._segsum_plain(y, seg, starts, num_segments=s, window=window)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(want[:128].any())


def test_dia_spmv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from tpusparse_torch.kernels import dia as dk

    o = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        dk.dia_spmv_kernel(torch.zeros(2, 8, device=cuda, dtype=torch.float64), o,
                           torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="same device"):
        dk.dia_spmv_kernel(torch.zeros(2, 8, device=cuda), o.cpu(), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dk.dia_spmv_kernel(torch.zeros(8, 2, device=cuda).t(), o, torch.zeros(8, device=cuda))


def test_dia_routes_on_card_match_cpu(cuda):
    """dia_spmm on one column past 128 diagonals launches the kernel once
    (with its plain-torch backward), 'dia' and 'auto' on a banded CSR run the
    unrolled sum, and each agrees with the CPU at the fp32 tier."""
    from tpusparse_torch.kernels import dia as dk
    from tpusparse_torch.types import DIA

    offs, data, x = _dia_inputs("square_200", "cpu")
    runs = {}
    for dev in ("cpu", cuda):
        d = data.to(dev).clone().requires_grad_(True)
        xx = x.to(dev).clone().requires_grad_(True)
        dk.reset_launch_counts()
        y = tt.dia_spmm(DIA(d, offs, (700, 700)), xx)
        y.square().sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert dk.launch_counts() == {"dia_spmv": 1, "dia_nonfinite": 0}
        runs[str(dev)] = (y.detach().cpu(), d.grad.cpu(), xx.grad.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, **TOL)
    from tpusparse_torch.utils.matrices import _laplace2d

    sp = _laplace2d(40)
    for method in ("dia", "auto"):
        outs = []
        for dev in ("cpu", cuda):
            a = tt.CSR.from_scipy(sp, device=dev)
            b = torch.from_numpy(np.random.default_rng(1).random((1600, 3), dtype=np.float32))
            outs.append(tt.spmm(a, b.to(dev), method=method).cpu())
        torch.testing.assert_close(outs[1], outs[0], **TOL)


def test_amg_vcycle_on_card_matches_cpu(cuda):
    """The AMG V-cycle at the 7-point Laplacian on 12³ (level 1: 185
    diagonals, the only wide level): the card launches the wide-DIA kernel
    7 times a cycle (5 matvecs of A, 2 of the factored prolongator's D⁻¹A)
    and matches the same hierarchy on the CPU within 1e-5 of scale."""
    from tpusparse_torch import kernels
    from tpusparse_torch.utils.matrices import _laplace3d

    sp = _laplace3d(12)
    b = torch.from_numpy(np.random.default_rng(0).random(sp.shape[0], dtype=np.float32))
    out = {}
    for dev in ("cpu", cuda):
        m = tt.smoothed_aggregation_setup(tt.CSR.from_scipy(sp, device=dev))
        kernels.reset_launch_counts()
        out[str(dev)] = m(b.to(dev)).cpu()
        if dev == cuda:
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert counts["dia_spmv"] == counts["dia_nonfinite"] == 7, counts
    err = float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max())
    assert err <= 1e-5, err
