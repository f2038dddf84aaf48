"""Parity of the port's derived plans (CompactPlan, GroupedPlan,
FootprintPlan), their executors, `footprint_spmm` and the plan files with
the JAX package. The plan arrays must be equal; each executor's plain
PyTorch version (what a wrapper runs on CPU tensors) is held against the
JAX Pallas executor in interpret mode. The CUDA kernels are held against
their plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.ops as jops
import tpusparse.plan as jplan
import tpusparse.types as jtypes
from tpusparse.kernels.tiled_spmm import (
    compact_spmm_pallas,
    footprint_spmm_pallas,
    grouped_spmm_pallas,
)
from tpusparse.types import CSR as JCSR
from tpusparse.utils.config import set_config as jset_config

import tpusparse_torch as tt
import tpusparse_torch.ops as tops
import tpusparse_torch.plan as tplan
import tpusparse_torch.types as ttypes
from tpusparse_torch.kernels import tiled_spmm as tk
from tpusparse_torch.types import CSR as TCSR

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
# bf16 output: the fp32 sums of two implementations may round to adjacent
# bf16 values (one ulp is 2^-8..2^-7 of the value).
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)

BLOCKSIZES = [(8, 8), (8, 32), (16, 16), (32, 8)]


def _uniform(seed=0, m=100, k=70, density=0.1, empty=(40, 56)):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    mask[empty[0]:empty[1]] = False  # whole row-blocks at every blocksize here
    return (mask * rng.standard_normal((m, k))).astype(np.float32)


def _pair(kind):
    if kind == "uniform":
        d = _uniform()
        return JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    j = jtypes.random_powerlaw_csr(3, (96, 80), avg_nnz_per_row=5.0)
    t = ttypes.random_powerlaw_csr(3, (96, 80), avg_nnz_per_row=5.0, device="cpu")
    return j, t


def _assert_fields_equal(pj, pt, arrays, scalars):
    for f in arrays:
        np.testing.assert_array_equal(np.asarray(getattr(pt, f)), np.asarray(getattr(pj, f)),
                                      err_msg=f)
    for f in scalars:
        assert tuple(np.atleast_1d(getattr(pt, f))) == tuple(np.atleast_1d(getattr(pj, f))), f


# -- plan arrays equal to JAX's ---------------------------------------------------


@pytest.mark.parametrize("blocksize", BLOCKSIZES)
@pytest.mark.parametrize("kind", ["uniform", "powerlaw"])
def test_compact_plan_matches_jax(kind, blocksize):
    j, t = _pair(kind)
    pj = jplan.compact_plan(jplan.build_plan(j, blocksize))
    pt = tplan.compact_plan(tplan.build_plan(t, blocksize))
    _assert_fields_equal(pj, pt, ("cols", "row_base", "scatter_idx"),
                         ("shape", "blocksize", "nnz", "nblocks", "num_row_blocks",
                          "num_col_blocks"))


@pytest.mark.parametrize("group_size", [1, 4, 64])
@pytest.mark.parametrize("blocksize", BLOCKSIZES)
@pytest.mark.parametrize("kind", ["uniform", "powerlaw"])
def test_grouped_plan_matches_jax(kind, blocksize, group_size):
    j, t = _pair(kind)
    pj = jplan.group_plan(jplan.build_plan(j, blocksize), group_size)
    pt = tplan.group_plan(tplan.build_plan(t, blocksize), group_size)
    _assert_fields_equal(pj, pt, ("block_cols", "local_rb", "nslots", "scatter_idx"),
                         ("shape", "blocksize", "group_size", "ell_width", "nnz", "nblocks",
                          "num_groups", "num_col_blocks", "num_slots"))


@pytest.mark.parametrize("rows_per_super", [1, 4, 16])
@pytest.mark.parametrize("blocksize", BLOCKSIZES)
@pytest.mark.parametrize("kind", ["uniform", "powerlaw"])
def test_footprint_plan_matches_jax(kind, blocksize, rows_per_super):
    j, t = _pair(kind)
    pj = jplan.footprint_plan(jplan.build_plan(j, blocksize), rows_per_super)
    pt = tplan.footprint_plan(tplan.build_plan(t, blocksize), rows_per_super)
    _assert_fields_equal(pj, pt, ("ucols", "ucnt", "nslots", "lrow", "bslot", "newcol",
                                  "scatter_idx"),
                         ("shape", "blocksize", "rows_per_super", "u_width", "ell_width",
                          "nnz", "nblocks", "ntiles", "num_row_blocks", "num_col_blocks",
                          "num_supers", "num_slots"))


def test_footprint_plan_invariants():
    """test_spmm_kernels.py::test_footprint_plan_invariants on the port."""
    t = ttypes.random_csr(32, (256, 192), 0.07, device="cpu")
    plan = tplan.build_plan(t, (8, 16))
    fp = tplan.footprint_plan(plan, rows_per_super=8)
    assert fp.nblocks == plan.nblocks
    assert fp.ntiles == int(fp.ucnt.sum()) <= fp.nblocks
    for s in range(fp.num_supers):
        c = fp.nslots[s]
        if c > 0:
            assert fp.newcol[s, 0] == 1 and fp.bslot[s, 0] == 0
            assert (np.diff(fp.bslot[s, :c]) == fp.newcol[s, 1:c]).all()
            assert fp.bslot[s, c - 1] == fp.ucnt[s] - 1
    for p in (fp, tplan.compact_plan(plan), tplan.group_plan(plan, 8)):
        np.testing.assert_array_equal(p.unpack_values(p.pack_values(t.data)).numpy(),
                                      t.data.numpy())


def test_derived_plan_caches():
    """test_routing.py::test_grouped_plan_cache, for all three; and
    test_spmm_kernels.py::test_derived_plan_caches_distinguish_intra_block_layout:
    two matrices with one (8, 16) block but other positions inside it get
    their own plans and the right products."""
    t = ttypes.random_csr(5, (64, 64), 0.05, device="cpu")
    plan = tplan.build_plan(t, (8, 8))
    assert tplan.group_plan(plan, 8) is tplan.group_plan(plan, 8)
    assert tplan.group_plan(plan, 8) is not tplan.group_plan(plan, 4)
    assert tplan.compact_plan(plan) is tplan.compact_plan(plan)
    assert tplan.footprint_plan(plan, 2) is tplan.footprint_plan(plan, 2)
    assert tplan.footprint_plan(plan, 2) is not tplan.footprint_plan(plan, 4)
    tplan.clear_plan_cache()  # keeps the derived caches, as JAX's does
    assert tplan.compact_plan(plan) is tplan._COMPACT_CACHE[tplan._derived_key(plan, "compact")]

    b = torch.from_numpy(np.random.default_rng(0).random((16, 8), dtype=np.float32))
    for positions in ([((0, 0), 1.0), ((3, 5), 2.0)], [((1, 1), 3.0), ((4, 7), 4.0)]):
        d = np.zeros((8, 16), np.float32)
        for (r, c), v in positions:
            d[r, c] = v
        a = TCSR.from_dense(d, device="cpu")
        base = tplan.build_plan(a, (8, 16))
        ref = d.astype(np.float64) @ b.double().numpy()
        for name, dp, fn in (
                ("footprint", tplan.footprint_plan(base, 2), tk.footprint_spmm_kernel),
                ("compact", tplan.compact_plan(base), tk.compact_spmm_kernel),
                ("grouped", tplan.group_plan(base, 2), tk.grouped_spmm_kernel)):
            np.testing.assert_allclose(fn(dp, dp.pack_values(a.data), b).numpy(), ref,
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# -- the executors' plain versions against the Pallas executors ---------------------

EXECUTORS = {
    "compact": (tplan.compact_plan, jplan.compact_plan, tk.compact_spmm_kernel,
                compact_spmm_pallas, None),
    "grouped": (tplan.group_plan, jplan.group_plan, tk.grouped_spmm_kernel,
                grouped_spmm_pallas, 4),
    "footprint": (tplan.footprint_plan, jplan.footprint_plan, tk.footprint_spmm_kernel,
                  footprint_spmm_pallas, 4),
}
# name: (m, k, n, density, blocksize, empty row range)
EXEC_CASES = {
    "ragged_8x16_n40": (64, 96, 40, 0.1, (8, 16), (16, 32)),
    "ragged_32x8_n33": (75, 53, 33, 0.15, (32, 8), None),
    "low_fill_8x32_n24": (128, 160, 24, 0.01, (8, 32), (64, 80)),
    # the block executors' tile edges: bm 5 and 24 (the n-major tile's N 8
    # and 24), 72 (the 64-row tile, two warpgroups); n 1 and 130; row-blocks
    # with no slot
    "bm5_n1_empty": (43, 37, 1, 0.15, (5, 8), (10, 20)),
    "bm24_n130_empty": (100, 70, 130, 0.1, (24, 16), (24, 48)),
    "bm72_n130_empty": (150, 90, 130, 0.1, (72, 32), (72, 144)),
}


def _exec_case(name, seed=1):
    m, k, n, density, bs, empty = EXEC_CASES[name]
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    if empty is not None:
        mask[empty[0]:empty[1]] = False
    dense = (mask * rng.standard_normal((m, k))).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return dense, b, JCSR.from_dense(dense), TCSR.from_dense(dense, device="cpu"), bs


def _derived(executor, j, t, bs):
    t_make, j_make, t_fn, j_fn, arg = EXECUTORS[executor]
    extra = () if arg is None else (arg,)
    return (j_make(jplan.build_plan(j, bs), *extra), t_make(tplan.build_plan(t, bs), *extra),
            t_fn, j_fn)


@pytest.mark.parametrize("name", sorted(EXEC_CASES))
def test_compact_plan_heaviest_first_orders_row_blocks_by_slot_count(name):
    """The order in which the compact executor starts its row-blocks: the
    slot counts of row_base sorted, most first, ties in row order, int32;
    one copy a device."""
    _, _, _, t, bs = _exec_case(name)
    cp = tplan.compact_plan(tplan.build_plan(t, bs))
    order = cp.index_tensor("heaviest_first", "cpu")
    assert order.dtype == torch.int32 and order is cp.index_tensor("heaviest_first", "cpu")
    counts = np.diff(np.asarray(cp.row_base))
    np.testing.assert_array_equal(order.numpy(), np.argsort(-counts, kind="stable"))
    sorted_counts = counts[order.numpy()]
    assert (np.diff(sorted_counts) <= 0).all()
    for c in np.unique(counts):  # ties keep row order
        ties = order.numpy()[sorted_counts == c]
        assert (np.diff(ties) > 0).all()


@pytest.mark.parametrize("name", sorted(EXEC_CASES))
@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_executor_plain_path_matches_pallas(executor, name):
    dense, b, j, t, bs = _exec_case(name)
    pj, pt, t_fn, j_fn = _derived(executor, j, t, bs)
    want = np.asarray(j_fn(pj, pj.pack_values(j.data), jnp.asarray(b)))
    got = t_fn(pt, pt.pack_values(t.data), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), dense.astype(np.float64) @ b, **TOL)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_executor_multi_n_tile_matches_pallas(executor):
    """test_routing.py::test_executors_multi_n_tile and
    test_spmm_kernels.py::test_footprint_spmm_multi_n_tile: n past JAX's N
    block (forced to 128: three n-tiles)."""
    rng = np.random.default_rng(9)
    d = ((rng.random((128, 256)) < 0.05) * rng.standard_normal((128, 256))).astype(np.float32)
    b = rng.normal(size=(256, 384)).astype(np.float32)
    j, t = JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    pj, pt, t_fn, j_fn = _derived(executor, j, t, (8, 32))
    jset_config(spmm_block_n=128)
    try:
        want = np.asarray(j_fn(pj, pj.pack_values(j.data), jnp.asarray(b)))
    finally:
        jset_config(spmm_block_n=512)
    got = t_fn(pt, pt.pack_values(t.data), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_executor_bf16_operands_accumulate_in_fp32(executor):
    """bf16 values and B, bf16 C, within 3x the error of the ELL executor
    against float64 over a 1024-long row, as in
    test_spmm_kernels.py::test_footprint_bf16_accumulates_in_f32; and
    against the Pallas executor with an fp32 output block (JAX's grouped
    executor adds each slot into its output block in the output's type, so
    a bf16 block there rounds 64 times along this row)."""
    rng = np.random.default_rng(4)
    d = (rng.random((8, 1024), dtype=np.float32) - 0.5).astype(np.float32)
    b = rng.random((1024, 16), dtype=np.float32)
    j, t = JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    pj, pt, t_fn, j_fn = _derived(executor, j, t, (8, 16))
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    want = np.asarray(j_fn(pj, pj.pack_values(j.data).astype(jnp.bfloat16), jb,
                           out_dtype=jnp.float32))
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = t_fn(pt, pt.pack_values(t.data).to(torch.bfloat16), bt)
    assert got.dtype == torch.bfloat16
    ref = d.astype(np.float64) @ bt.double().numpy()
    base = tplan.build_plan(t, (8, 16))
    ell = tk.tiled_spmm_kernel(base, base.pack_values(t.data).to(torch.bfloat16), bt)
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    err_ell = np.abs(ell.float().numpy() - ref).max() / np.abs(ref).max()
    assert err < 3 * err_ell + 1e-3, (err, err_ell)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL_BF16)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_executor_default_tier_matches_bf16_rounded_numpy(executor):
    dense, b, _, t, bs = _exec_case("ragged_32x8_n33")
    t_make, _, t_fn, _, arg = EXECUTORS[executor]
    dp = t_make(tplan.build_plan(t, bs), *(() if arg is None else (arg,)))
    got = t_fn(dp, dp.pack_values(t.data), torch.from_numpy(b), precision="default")

    def rnd(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()

    np.testing.assert_allclose(got.numpy(), rnd(dense) @ rnd(b), **TOL)


@pytest.mark.parametrize("G", [4, 16])
def test_grouped_executor_parity(G):
    """test_routing.py::test_grouped_executor_parity (256 x 384 at 1 %,
    blocks 8 x 8): against the Pallas executor and float64."""
    rng = np.random.default_rng(11)
    d = ((rng.random((256, 384)) < 0.01) * rng.random((256, 384))).astype(np.float32)
    b = rng.normal(size=(384, 128)).astype(np.float32)
    j, t = JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    gj = jplan.group_plan(jplan.build_plan(j, (8, 8)), G)
    gt = tplan.group_plan(tplan.build_plan(t, (8, 8)), G)
    got = tk.grouped_spmm_kernel(gt, gt.pack_values(t.data), torch.from_numpy(b))
    want = np.asarray(grouped_spmm_pallas(gj, gj.pack_values(j.data), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), d.astype(np.float64) @ b, **TOL)


def test_compact_executor_parity():
    """test_routing.py::test_compact_executor_parity (blocks 8 x 64)."""
    rng = np.random.default_rng(8)
    d = ((rng.random((256, 384)) < 0.02) * rng.random((256, 384))).astype(np.float32)
    b = rng.normal(size=(384, 128)).astype(np.float32)
    j, t = JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    cj = jplan.compact_plan(jplan.build_plan(j, (8, 64)))
    ct = tplan.compact_plan(tplan.build_plan(t, (8, 64)))
    got = tk.compact_spmm_kernel(ct, ct.pack_values(t.data), torch.from_numpy(b))
    want = np.asarray(compact_spmm_pallas(cj, cj.pack_values(j.data), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_footprint_tile_fits_the_shared_memory():
    """The footprint kernel's geometry: a block of 256 threads owns a
    128-row window of a super and a 64-column n-tile, its accumulators in
    registers and only two A and B chunks in shared memory. At the
    headline's S 16 and 128 x 128 blocks a super is 16 blocks of one
    row-block each; on a low-fill plan (S 16, blocks 8 x 32) one block of 16
    row-blocks. So every rows_per_super fits (S 17 and 64, which the old
    shared-memory accumulators could not hold, run on the CPU as the plain
    version and match the dense product)."""
    assert (tk.FOOTPRINT_ROWS, tk.FOOTPRINT_NTILE, tk.FOOTPRINT_THREADS) == (128, 64, 256)
    t = ttypes.random_csr(0, (4096, 512), 0.001, device="cpu")
    head = tplan.footprint_plan(tplan.build_plan(t, (128, 128)), 16)
    assert tk.footprint_tile(head) == 16
    low = tplan.footprint_plan(tplan.build_plan(t, (8, 32)), 16)
    assert tk.footprint_tile(low) == 1
    assert tk.footprint_tile(tplan.footprint_plan(tplan.build_plan(t, (48, 32)), 5)) == 2
    b = torch.from_numpy(np.random.default_rng(9).standard_normal((512, 8)).astype(np.float32))
    for S in (17, 64):
        big = tplan.footprint_plan(tplan.build_plan(t, (128, 128)), S)
        assert tk.footprint_tile(big) == S
        got = tk.footprint_spmm_kernel(big, big.pack_values(t.data), b)
        np.testing.assert_allclose(got.numpy(), t.to_dense().numpy() @ b.numpy(), **TOL)
    got = tops.footprint_spmm(t, b, blocksize=(128, 128), rows_per_super=64)
    np.testing.assert_allclose(got.numpy(), t.to_dense().numpy() @ b.numpy(), **TOL)


# (m, k), blocksize, group_size, n, the grid grouped_tile must give: the
# headline's 128 row-blocks of 128 rows at n 512 (1,024 blocks, >= 4 x 132),
# the low-fill plan's 512 row-blocks of 8 rows at n 256 (8 x 256 windows),
# 4-row blocks in 8-row windows, 20-row and 64-row blocks in 128-row
# windows, and 200-row blocks in two slices each
GROUPED_GEOMETRY = {
    "headline_128": ((16384, 64), (128, 128), 64, 512, (128, 8)),
    "low_fill_8": ((4096, 64), (8, 32), 64, 256, (512, 1)),
    "bm4_n70": ((150, 90), (4, 16), 5, 70, (38, 1)),
    "bm20_n300": ((410, 90), (20, 16), 3, 300, (21, 5)),
    "bm64_n70": ((300, 90), (64, 16), 2, 70, (5, 2)),
    "bm200_n33": ((610, 90), (200, 16), 2, 33, (8, 1)),
}


@pytest.mark.parametrize("name", sorted(GROUPED_GEOMETRY))
def test_grouped_tile_covers_every_output_once(name):
    """The grouped kernel's geometry: block (x, y) owns rows [r0, r0 +
    min(rows, bm - r0)) of row-block rb = x // slices (r0 = (x % slices) *
    rows) and columns [y * cols, (y + 1) * cols) of C. Over the grid every
    output of the padded (row-blocks x bm, n) C is owned exactly once, and
    the plain path at the same plan matches the dense product."""
    (m, k), bs, G, n, grid = GROUPED_GEOMETRY[name]
    t = ttypes.random_csr(5, (m, k), 0.02, device="cpu")
    gp = tplan.group_plan(tplan.build_plan(t, bs), G)
    geo = tk.grouped_tile(gp, n)
    assert geo["grid"] == grid
    bm = bs[0]
    assert geo["rows"] >= min(bm, 128) and geo["slices"] * geo["rows"] >= bm
    owned = np.zeros((gp.num_row_blocks * bm, n), dtype=np.int64)
    for x in range(grid[0]):
        rb, r0 = divmod(x, geo["slices"])
        r0 *= geo["rows"]
        rows = min(geo["rows"], bm - r0)
        for y in range(grid[1]):
            owned[rb * bm + r0: rb * bm + r0 + rows,
                  y * geo["cols"]: (y + 1) * geo["cols"]] += 1
    assert (owned == 1).all()
    b = torch.from_numpy(np.random.default_rng(7).standard_normal((k, n)).astype(np.float32))
    got = tk.grouped_spmm_kernel(gp, gp.pack_values(t.data), b)
    np.testing.assert_allclose(got.numpy(), t.to_dense().numpy() @ b.numpy(), **TOL)


def test_executors_reject_what_they_do_not_take():
    _, b, _, t, bs = _exec_case("ragged_8x16_n40")
    base = tplan.build_plan(t, bs)
    bt = torch.from_numpy(b)
    for dp, fn in ((tplan.compact_plan(base), tk.compact_spmm_kernel),
                   (tplan.group_plan(base, 4), tk.grouped_spmm_kernel),
                   (tplan.footprint_plan(base, 4), tk.footprint_spmm_kernel)):
        bv = dp.pack_values(t.data)
        with pytest.raises(ValueError, match="block_vals shape"):
            fn(dp, bv[:-1], bt)
        with pytest.raises(ValueError, match="incompatible"):
            fn(dp, bv, bt[:-1])
        with pytest.raises(TypeError, match="dtype"):
            fn(dp, bv, bt.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(dp, bv, torch.from_numpy(np.asfortranarray(b)))


def test_cpu_path_counts_no_launch():
    _, b, _, t, bs = _exec_case("ragged_8x16_n40")
    base = tplan.build_plan(t, bs)
    tk.reset_launch_counts()
    for dp, fn in ((tplan.compact_plan(base), tk.compact_spmm_kernel),
                   (tplan.group_plan(base, 4), tk.grouped_spmm_kernel),
                   (tplan.footprint_plan(base, 4), tk.footprint_spmm_kernel)):
        fn(dp, dp.pack_values(t.data), torch.from_numpy(b))
    assert not any(tt.kernels.launches_by_kernel().values())


# -- footprint_spmm and spmm(method='footprint') --------------------------------------


@pytest.mark.parametrize("rows_per_super", [1, 4, 16])
@pytest.mark.parametrize("name", sorted(EXEC_CASES))
def test_footprint_spmm_and_grads_match_jax(name, rows_per_super):
    _, b, j, t, bs = _exec_case(name)
    g = np.random.default_rng(2).standard_normal((t.shape[0], b.shape[1])).astype(np.float32)
    data = t.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tops.footprint_spmm(TCSR(data, t.indices, t.indptr, t.shape), bt, blocksize=bs,
                              rows_per_super=rows_per_super)
    out.backward(torch.from_numpy(g))
    want, vjp = jax.vjp(
        lambda v, bb: jops.footprint_spmm(JCSR(v, j.indices, j.indptr, j.shape), bb,
                                          blocksize=bs, rows_per_super=rows_per_super),
        j.data, jnp.asarray(b))
    d_vals, d_b = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(d_vals), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(d_b), **TOL)


def test_spmm_footprint_method():
    """test_routing.py::test_spmm_footprint_method: the forward against JAX
    and float64; the gradient in the values equal to the tiled path's."""
    rng = np.random.default_rng(14)
    d = ((rng.random((96, 128)) < 0.08) * rng.standard_normal((96, 128))).astype(np.float32)
    b = rng.normal(size=(128, 48)).astype(np.float32)
    j, t = JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    got = tops.spmm(t, torch.from_numpy(b), method="footprint")
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.spmm(j, jnp.asarray(b),
                                                                  method="footprint")), **TOL)
    np.testing.assert_allclose(got.numpy(), d.astype(np.float64) @ b, **TOL)
    grads = {}
    for method in ("footprint", "tiled"):
        data = t.data.clone().requires_grad_(True)
        (tops.spmm(TCSR(data, t.indices, t.indptr, t.shape), torch.from_numpy(b),
                   method=method) ** 2).sum().backward()
        grads[method] = data.grad.numpy()
    np.testing.assert_allclose(grads["footprint"], grads["tiled"], **TOL)


def test_footprint_spmm_folds_3d_and_widens_fp16():
    _, b, j, t, bs = _exec_case("ragged_32x8_n33")
    b3 = np.stack([b, -b[:, ::-1]]).copy()
    got = tops.footprint_spmm(t, torch.from_numpy(b3), blocksize=bs, rows_per_super=4)
    want = jops.footprint_spmm(j, jnp.asarray(b3), blocksize=bs, rows_per_super=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    b16 = b.astype(np.float16)
    got = tops.spmm(t, torch.from_numpy(b16), method="footprint", blocksize=bs)
    want = jops.spmm(j, jnp.asarray(b16), method="footprint", blocksize=bs)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- plan files and the roofline constants ----------------------------------------------


def test_plan_save_load_roundtrip_across_packages(tmp_path):
    """test_types.py::test_plan_save_load_roundtrip across packages: a plan
    saved by JAX loads equal in the port and runs the same product, and the
    other way round."""
    rng = np.random.default_rng(0)
    d = ((rng.random((128, 160)) < 0.05) * rng.random((128, 160))).astype(np.float32)
    j, t = JCSR.from_dense(d), TCSR.from_dense(d, device="cpu")
    pj, pt = jplan.build_plan(j, (8, 32)), tplan.build_plan(t, (8, 32))
    b = rng.normal(size=(160, 64)).astype(np.float32)
    jplan.save_plan(pj, str(tmp_path / "jax.npz"))
    tplan.save_plan(pt, str(tmp_path / "torch.npz"))
    from_jax = tt.load_plan(str(tmp_path / "jax.npz"))
    from_torch = jplan.load_plan(str(tmp_path / "torch.npz"))
    for loaded, ref in ((from_jax, pt), (from_torch, pj)):
        for f in ("block_cols", "nslots", "scatter_idx"):
            np.testing.assert_array_equal(np.asarray(getattr(loaded, f)),
                                          np.asarray(getattr(ref, f)))
            assert np.asarray(getattr(loaded, f)).dtype == np.asarray(getattr(ref, f)).dtype
        for f in ("shape", "blocksize", "ell_width", "nnz", "nblocks"):
            assert getattr(loaded, f) == getattr(ref, f), f
    got = tk.tiled_spmm_kernel(from_jax, from_jax.pack_values(t.data), torch.from_numpy(b))
    assert torch.equal(got, tk.tiled_spmm_kernel(pt, pt.pack_values(t.data),
                                                 torch.from_numpy(b)))
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "torch.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype, f
            np.testing.assert_array_equal(zj[f], zt[f])


def test_set_roofline_constants_moves_the_report():
    plan = tplan.build_plan(ttypes.random_csr(0, (256, 256), 0.05, device="cpu"), (32, 32))
    before = plan.report(n_cols=64)["projected_time_s"]
    saved = dict(tplan._ROOFLINE)
    try:
        tt.set_roofline_constants(peak_fp32_flops=saved["peak_fp32_flops"] / 10,
                                  hbm_bandwidth=saved["hbm_bandwidth"] / 10)
        assert plan.report(n_cols=64)["projected_time_s"] == pytest.approx(10 * before)
    finally:
        tplan._ROOFLINE.update(saved)
