"""Parity of the port's SDDMM and block-SpMM backward with the JAX package:
`block_transpose_plan` (arrays exactly equal), the SDDMM kernel's plain
version against `sddmm_pallas` (interpret mode), the public `ops.sddmm`,
and the gradients of `tiled_spmm`, `resident_spmm` and `spmm_blocks`
against `jax.vjp` of the JAX ops. On CPU tensors the port's wrappers run
their plain versions; the CUDA kernels are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.ops as jops
import tpusparse.plan as jplan
from tpusparse.kernels.sddmm import sddmm_pallas
from tpusparse.types import CSR as JCSR
from tpusparse.types import sddmm_reference as jsddmm_reference

import tpusparse_torch.ops as tops
import tpusparse_torch.plan as tplan
from tpusparse_torch.kernels import sddmm as sk
from tpusparse_torch.types import CSR as TCSR
from tpusparse_torch.types import sddmm_reference

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
# bf16 output: fp32 sums of two implementations may round to adjacent bf16
# values (one ulp is 2^-8..2^-7 of the value); inputs are ~N(0, 1).
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)

# name: (m, k, n, density, blocksize, empty row range, empty column range)
CASES = {
    "ragged_8x16_n33": (100, 70, 33, 0.1, (8, 16), None, (16, 48)),
    "ragged_32x8_n40": (75, 53, 40, 0.15, (32, 8), None, (8, 24)),
    "empty_rowblock_8x8": (40, 64, 17, 0.2, (8, 8), (8, 24), (40, 56)),
    "empty_rowblock_128x128": (300, 260, 24, 0.05, (128, 128), (128, 256), None),
}


def _case(name, seed=0):
    """(dense A, dC, B, JAX CSR, port CSR, blocksize): A is non-square, with
    an empty row range and an empty column range (whole row- and
    column-blocks at these blocksizes)."""
    m, k, n, density, bs, rows, cols = CASES[name]
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    if rows is not None:
        mask[rows[0]:rows[1]] = False
    if cols is not None:
        mask[:, cols[0]:cols[1]] = False
    dense = (mask * rng.standard_normal((m, k))).astype(np.float32)
    dc = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return dense, dc, b, JCSR.from_dense(dense), TCSR.from_dense(dense, device="cpu"), bs


# -- block_transpose_plan -------------------------------------------------------


@pytest.mark.parametrize("name", ["ragged_8x16_n33", "ragged_32x8_n40", "empty_rowblock_8x8"])
def test_block_transpose_plan_equals_jax(name):
    _, _, _, j, t, bs = _case(name)
    pj, perm_j = jplan.block_transpose_plan(jplan.build_plan(j, bs))
    pt, perm_t = tplan.block_transpose_plan(tplan.build_plan(t, bs))
    for f in ("block_cols", "nslots", "scatter_idx"):
        got, want = getattr(pt, f), np.asarray(getattr(pj, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(perm_t, np.asarray(perm_j))
    assert perm_t.dtype == np.int32
    for f in ("shape", "blocksize", "ell_width", "nnz", "nblocks", "num_slots"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert pt.scatter_idx.size == 0
    assert (pt.nslots == 0).any()  # the empty column-blocks of A


def test_block_transpose_plan_reproduces_a_transpose():
    dense, _, _, _, t, bs = _case("empty_rowblock_8x8")
    plan = tplan.build_plan(t, bs)
    blocks = plan.pack_values(t.data)
    plan_t, perm = tplan.block_transpose_plan(plan)
    bm, bk = bs
    ext = torch.cat([blocks.transpose(1, 2), torch.zeros(1, bk, bm)])
    at = plan_t.blocks_to_dense(ext[torch.from_numpy(perm).long()])
    np.testing.assert_array_equal(at.numpy(), dense.T)
    # pad slots point at the zero block, and their block id is 0
    pad = ~plan_t.slot_valid_mask().bool().reshape(-1)
    assert (perm[pad.numpy()] == plan.num_slots).all()
    assert (plan_t.block_cols.reshape(-1)[pad.numpy()] == 0).all()


def test_block_transpose_plan_is_cached_and_cleared():
    _, _, _, _, t, bs = _case("ragged_32x8_n40")
    plan = tplan.build_plan(t, bs)
    first = tplan.block_transpose_plan(plan)
    assert tplan.block_transpose_plan(plan) is first
    tplan.clear_plan_cache()
    assert tplan.block_transpose_plan(plan) is not first


# -- the SDDMM kernel's plain version ---------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_sddmm_plain_matches_pallas(name):
    _, dc, b, j, t, bs = _case(name)
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    want = np.asarray(sddmm_pallas(pj, jnp.asarray(dc), jnp.asarray(b)))
    got = sk.sddmm_kernel(pt, torch.from_numpy(dc), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pad = ~pt.slot_valid_mask().bool().reshape(-1)
    assert torch.count_nonzero(got[pad]) == 0  # pad slots exactly 0


def test_sddmm_plain_matches_sddmm_reference_per_nonzero():
    dense, dc, b, _, t, bs = _case("ragged_8x16_n33")
    plan = tplan.build_plan(t, bs)
    vals = plan.unpack_values(sk.sddmm_kernel(plan, torch.from_numpy(dc), torch.from_numpy(b)))
    rows, cols = np.nonzero(dense)
    np.testing.assert_allclose(vals.numpy(), (dc @ b.T)[rows, cols], **TOL)


def test_sddmm_bf16_matches_pallas():
    _, dc, b, j, t, bs = _case("ragged_32x8_n40")
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    want = sddmm_pallas(pj, jnp.asarray(dc, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    got = sk.sddmm_kernel(pt, torch.from_numpy(dc).bfloat16(), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL_BF16)


def test_sddmm_default_tier_matches_bf16_rounded_numpy():
    dense, dc, b, _, t, bs = _case("ragged_32x8_n40")
    plan = tplan.build_plan(t, bs)
    dct, bt = torch.from_numpy(dc), torch.from_numpy(b)
    got = plan.unpack_values(sk.sddmm_kernel(plan, dct, bt, precision="default"))

    def rnd(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()

    rows, cols = np.nonzero(dense)
    # bf16 x bf16 products are exact in fp32, so only the sums round
    np.testing.assert_allclose(got.numpy(), (rnd(dc) @ rnd(b).T)[rows, cols], **TOL)
    high = plan.unpack_values(sk.sddmm_kernel(plan, dct, bt, precision="high"))
    assert not torch.equal(got, high)  # the tier really rounds


def test_sddmm_wrapper_rejects_what_the_kernel_does_not_take():
    _, dc, b, _, t, bs = _case("ragged_8x16_n33")
    plan = tplan.build_plan(t, bs)
    dct, bt = torch.from_numpy(dc), torch.from_numpy(b)
    with pytest.raises(ValueError, match="shape mismatch"):
        sk.sddmm_kernel(plan, dct[:, :-1], bt)
    with pytest.raises(ValueError, match="shape mismatch"):
        sk.sddmm_kernel(plan, bt, dct)
    with pytest.raises(TypeError, match="dtype"):
        sk.sddmm_kernel(plan, dct.double(), bt)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sddmm_kernel(plan, torch.from_numpy(np.asfortranarray(dc)), bt)
    with pytest.raises(ValueError, match="precision"):
        sk.sddmm_kernel(plan, dct, bt, precision="tf32")
    sk.reset_launch_counts()
    sk.sddmm_kernel(plan, dct, bt)
    assert sk.launch_counts() == {"sddmm": 0}  # the CPU path launches nothing


# -- public ops.sddmm -------------------------------------------------------------


def _sddmm_inputs(seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((24, 40)) < 0.12
    pattern = (mask * rng.standard_normal((24, 40))).astype(np.float32)
    x = rng.standard_normal((24, 12)).astype(np.float32)
    y = rng.standard_normal((12, 40)).astype(np.float32)
    g = rng.standard_normal(int(mask.sum())).astype(np.float32)
    return JCSR.from_dense(pattern), TCSR.from_dense(pattern, device="cpu"), x, y, g


def test_sddmm_reference_matches_jax():
    j, t, x, y, _ = _sddmm_inputs()
    want = np.asarray(jsddmm_reference(j, jnp.asarray(x), jnp.asarray(y)))
    got = sddmm_reference(t, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ops_sddmm_matches_jax(use_kernel):
    j, t, x, y, _ = _sddmm_inputs()
    want = np.asarray(jops.sddmm(j, jnp.asarray(x), jnp.asarray(y), use_pallas=use_kernel))
    got = tops.sddmm(t, torch.from_numpy(x), torch.from_numpy(y), use_kernel=use_kernel)
    assert tuple(got.shape) == (t.nnz,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ops_sddmm_grads_match_jax_vjp():
    j, t, x, y, g = _sddmm_inputs()
    _, vjp = jax.vjp(lambda xx, yy: jops.sddmm(j, xx, yy), jnp.asarray(x), jnp.asarray(y))
    dx_want, dy_want = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    tops.sddmm(t, xt, yt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want), **TOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(dy_want), **TOL)


def test_ops_sddmm_kernel_path_is_forward_only():
    _, t, x, y, _ = _sddmm_inputs()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tops.sddmm(t, xt, torch.from_numpy(y), use_kernel=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        out.sum().backward()


# -- gradients of the block SpMM ops against jax.vjp ------------------------------


@pytest.mark.parametrize("op", ["tiled_spmm", "resident_spmm"])
@pytest.mark.parametrize("name", ["ragged_8x16_n33", "empty_rowblock_8x8", "empty_rowblock_128x128"])
def test_packed_spmm_grads_match_jax_vjp(name, op):
    _, g, b, j, t, bs = _case(name)
    jfn, tfn = getattr(jops, op), getattr(tops, op)

    def jf(data, bb):
        return jfn(JCSR(data, j.indices, j.indptr, j.shape), bb, blocksize=bs)

    want, vjp = jax.vjp(jf, j.data, jnp.asarray(b))
    d_data_want, db_want = vjp(jnp.asarray(g))
    data = t.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tfn(TCSR(data, t.indices, t.indptr, t.shape), bt, blocksize=bs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(d_data_want), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_want), **TOL)


@pytest.mark.parametrize("name", ["ragged_8x16_n33", "ragged_32x8_n40", "empty_rowblock_8x8",
                                  "empty_rowblock_128x128"])
def test_spmm_blocks_grads_match_jax_vjp(name):
    dense, g, b, j, t, bs = _case(name)
    pj, pt = jplan.build_plan(j, bs), tplan.build_plan(t, bs)
    want, vjp = jax.vjp(lambda blk, bb: jops.spmm_blocks(pj, blk, bb),
                        pj.pack_values(j.data), jnp.asarray(b))
    dblocks_want, db_want = vjp(jnp.asarray(g))
    blocks = pt.pack_values(t.data).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tops.spmm_blocks(pt, blocks, bt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(dblocks_want), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_want), **TOL)
    # dB is Aᵀ·dC; the row-blocks of Aᵀ with no block (A's empty column
    # range) come out exactly 0
    np.testing.assert_allclose(bt.grad.numpy(), dense.T.astype(np.float64) @ g, **TOL)
    assert bt.grad.dtype == bt.dtype
    cols = CASES[name][6]
    if cols is not None:
        assert torch.count_nonzero(bt.grad[cols[0]:cols[1]]) == 0


def test_spmm_grad_restricted_to_pattern():
    # dA of sum(A @ B) is the row sum of B at each nonzero's column
    dense, _, b, _, t, bs = _case("ragged_32x8_n40")
    data = t.data.clone().requires_grad_(True)
    tops.tiled_spmm(TCSR(data, t.indices, t.indptr, t.shape), torch.from_numpy(b),
                    blocksize=bs).sum().backward()
    _, cols = np.nonzero(dense)
    np.testing.assert_allclose(data.grad.numpy(), b.sum(axis=1)[cols], **TOL)


def test_backward_skips_what_needs_no_gradient():
    _, g, b, _, t, bs = _case("ragged_8x16_n33")
    plan = tplan.build_plan(t, bs)
    blocks = plan.pack_values(t.data).requires_grad_(True)
    bt = torch.from_numpy(b)  # needs no gradient: no dB
    tops.spmm_blocks(plan, blocks, bt).backward(torch.from_numpy(g))
    assert blocks.grad is not None and bt.grad is None
    data = t.data.clone()
    bt = torch.from_numpy(b).requires_grad_(True)  # values need none: no SDDMM
    tops.tiled_spmm(TCSR(data, t.indices, t.indptr, t.shape), bt,
                    blocksize=bs).backward(torch.from_numpy(g))
    assert data.grad is None and bt.grad is not None


def test_forward_under_inference_mode_keeps_no_graph():
    _, _, b, _, t, bs = _case("ragged_8x16_n33")
    plan = tplan.build_plan(t, bs)
    blocks = plan.pack_values(t.data).requires_grad_(True)
    with torch.inference_mode():
        out = tops.spmm_blocks(plan, blocks, torch.from_numpy(b))
    assert out.grad_fn is None and not out.requires_grad
