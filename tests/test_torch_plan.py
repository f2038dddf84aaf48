"""Parity of the port's inspector plans (tpusparse_torch.plan) with the JAX
package's (tpusparse.plan): plan arrays must be equal at every blocksize."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.plan as jplan
from tpusparse.nn.layers import Pattern as JPattern
from tpusparse.types import CSR as JCSR

import tpusparse_torch.plan as tplan
from tpusparse_torch.nn import Pattern as TPattern
from tpusparse_torch.types import CSR as TCSR

BLOCKSIZES = [(8, 8), (8, 32), (16, 16), (32, 8), (128, 128)]
PATTERNS = {
    "ragged": dict(seed=0, m=100, k=70, density=0.1),
    "skewed": dict(seed=1, m=96, k=80, density=0.05, skew=True),
    "empty_rowblock": dict(seed=2, m=300, k=260, density=0.05, empty_rows=(128, 256)),
}


def _np_csr(seed, m, k, density, empty_rows=(0, 0), skew=False):
    """(data, indices, indptr, shape) of a seeded random pattern. `skew`
    makes every 7th row ~30x denser than the rest; `empty_rows` clears a
    row range (a whole row-block at the sizes used here)."""
    rng = np.random.default_rng(seed)
    p = np.full(m, density)
    if skew:
        p[::7] = min(1.0, density * 30)
    mask = rng.random((m, k)) < p[:, None]
    mask[empty_rows[0]:empty_rows[1]] = False
    vals = rng.standard_normal((m, k)).astype(np.float32)
    rows, cols = np.nonzero(mask)
    indptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    return vals[rows, cols], cols.astype(np.int32), indptr, (m, k)


def _pair(pattern):
    data, indices, indptr, shape = _np_csr(**PATTERNS[pattern])
    j = JCSR(data=jnp.asarray(data), indices=indices, indptr=indptr, shape=shape)
    t = TCSR(data=torch.from_numpy(data), indices=indices, indptr=indptr, shape=shape)
    return j, t


def _assert_plans_equal(pj, pt):
    for f in ("block_cols", "nslots", "scatter_idx"):
        np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(pj, f)))
    for f in ("shape", "blocksize", "ell_width", "nnz", "nblocks", "num_slots",
              "num_row_blocks", "num_col_blocks"):
        assert tuple(np.atleast_1d(getattr(pt, f))) == tuple(np.atleast_1d(getattr(pj, f))), f


@pytest.mark.parametrize("blocksize", BLOCKSIZES)
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_build_plan_matches_jax(pattern, blocksize):
    j, t = _pair(pattern)
    _assert_plans_equal(
        jplan.build_plan(j, blocksize, use_cache=False),
        tplan.build_plan(t, blocksize, use_cache=False),
    )


def test_empty_rowblock_has_no_slots():
    _, t = _pair("empty_rowblock")
    plan = tplan.build_plan(t, (128, 128), use_cache=False)
    assert plan.nslots[1] == 0 and plan.nslots[0] > 0


@pytest.mark.parametrize("blocksize", [(16, 16), (32, 8), (128, 128)])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_build_plan_pair_matches_jax(pattern, blocksize):
    j, t = _pair(pattern)
    pj, pj_t, permj = jplan.build_plan_pair(j, blocksize)
    pt, pt_t, permt = tplan.build_plan_pair(t, blocksize)
    _assert_plans_equal(pj, pt)
    _assert_plans_equal(pj_t, pt_t)
    np.testing.assert_array_equal(permt, np.asarray(permj))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_pack_unpack_match_jax_and_round_trip(pattern):
    j, t = _pair(pattern)
    pj = jplan.build_plan(j, (16, 16))
    pt = tplan.build_plan(t, (16, 16))
    bvj = np.asarray(pj.pack_values(j.data))
    bvt = pt.pack_values(t.data)
    np.testing.assert_array_equal(bvt.numpy(), bvj)
    np.testing.assert_array_equal(pt.unpack_values(bvt).numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(
        pt.unpack_values(bvt).numpy(), np.asarray(pj.unpack_values(jnp.asarray(bvj)))
    )


@pytest.mark.parametrize("blocksize", [(8, 32), (128, 128)])
def test_slot_mask_and_blocks_to_dense_match_jax(blocksize):
    j, t = _pair("skewed")
    pj = jplan.build_plan(j, blocksize)
    pt = tplan.build_plan(t, blocksize)
    np.testing.assert_array_equal(pt.slot_valid_mask().numpy(), np.asarray(pj.slot_valid_mask()))
    dense_t = pt.blocks_to_dense(pt.pack_values(t.data)).numpy()
    np.testing.assert_array_equal(dense_t, np.asarray(pj.blocks_to_dense(pj.pack_values(j.data))))
    np.testing.assert_array_equal(dense_t, t.to_dense().numpy())


def test_report_keys_and_counts_match_jax():
    j, t = _pair("ragged")
    rj = jplan.build_plan(j, (16, 16)).report(n_cols=64)
    rt = tplan.build_plan(t, (16, 16)).report(n_cols=64)
    assert set(rt) == set(rj)
    # shape-derived counts agree; the roofline keys use the H100 constants
    for key in ("density", "nnz", "nblocks", "ell_width", "block_fill",
                "ell_pad_overhead", "vmem_bytes_per_step", "useful_flops",
                "block_flops", "bytes_moved", "arithmetic_intensity"):
        assert rt[key] == pytest.approx(rj[key]), key
    assert rt["projected_time_s"] > 0 and rt["bound"] in ("compute", "memory")


def test_plan_cache_hits_and_clears():
    _, t = _pair("ragged")
    tplan.clear_plan_cache()
    p1 = tplan.build_plan(t, (8, 8))
    p2 = tplan.build_plan(t, (8, 8))
    assert p1 is p2
    assert tplan.plan_cache_info() == {"size": 1, "hits": 1, "misses": 1}
    tplan.clear_plan_cache()
    assert tplan.plan_cache_info() == {"size": 0, "hits": 0, "misses": 0}


@pytest.mark.parametrize(
    "seed,shape,density", [(0, (256, 784), 0.1), (1, (10, 256), 0.1), (7, (33, 17), 0.3)]
)
def test_pattern_random_matches_jax(seed, shape, density):
    pj = JPattern.random(seed, shape, density)
    pt = TPattern.random(seed, shape, density)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    np.testing.assert_array_equal(pt.indptr, pj.indptr)
    assert pt.shape == tuple(pj.shape) and pt.nnz == pj.nnz
    assert pt == TPattern.random(seed, shape, density)
    assert hash(pt) == hash(TPattern.random(seed, shape, density))
    assert pt != TPattern.random(seed + 1, shape, density)


def test_index_tensors_are_cached_per_device():
    _, t = _pair("ragged")
    plan = tplan.build_plan(t, (8, 8))
    a = plan.index_tensor("block_cols", "cpu")
    assert plan.index_tensor("block_cols", "cpu") is a
    assert a.dtype == torch.int32 and a.numel() == plan.num_slots
    assert plan.index_tensor("scatter_idx", "cpu").dtype == torch.int64
