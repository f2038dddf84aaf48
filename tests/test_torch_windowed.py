"""Parity of the port's windowed gather and segment sum with the JAX package
(tests/test_windowed.py's kernel tests), whose Pallas kernels run here in
interpret mode. The same numpy inputs go through both packages: the plans'
arrays must be equal, the gather's output equal bit for bit, the segment
sum within the fp32 tier (the TPU kernel sums each 128-entry chunk as a
vector reduction, the port in ascending position). On CPU tensors the
port's wrappers run the kernels' plain versions; tests/test_torch_cuda.py
and chip_smoke.py hold the CUDA kernels against them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import windowed as jw
from tpusparse_torch.kernels import windowed as tw

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite

GATHER_FIELDS = ("idx", "starts", "rel", "exc_pos", "exc_idx", "n", "table_len", "window", "nb")
SEGMENT_FIELDS = ("seg", "starts", "seg_masked", "exc_pos", "exc_seg", "mask", "n_in",
                  "num_segments", "window", "nb")


def _local_idx(rng, n, t, jitter=40, n_far=0):
    idx = np.minimum((np.arange(n) * t) // n + rng.integers(0, jitter, n), t - 1)
    if n_far:
        idx[rng.integers(0, n, n_far)] = rng.integers(0, t, n_far)
    return idx.astype(np.int64)


def _same_plan(tp, jp, fields):
    for f in fields:
        got, want = getattr(tp, f), getattr(jp, f)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert got == want, f
    assert tw.modeled_cost_s(tp) == jw.modeled_cost_s(jp)


def _gather_pair(idx, t, table):
    jp, tp = jw.windowed_gather_plan(idx, t), tw.windowed_gather_plan(idx, t)
    _same_plan(tp, jp, GATHER_FIELDS)
    want = np.asarray(jw.windowed_gather(jnp.asarray(table), jp))
    got = tw.windowed_gather(torch.from_numpy(table), tp).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))  # bit for bit
    return tp, got


def _segment_pair(seg, s, y):
    jp, tp = jw.windowed_segment_plan(seg, s), tw.windowed_segment_plan(seg, s)
    _same_plan(tp, jp, SEGMENT_FIELDS)
    want = np.asarray(jw.windowed_segment_sum(jnp.asarray(y), jp))
    got = tw.windowed_segment_sum(torch.from_numpy(y), tp).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    return tp, got


# ---------------------------------------------------------------------------
# gather (tests/test_windowed.py::TestWindowedGather)
# ---------------------------------------------------------------------------


def test_gather_matches_jax_and_numpy_exactly(rng):
    n, t = 5000, 900
    idx = _local_idx(rng, n, t, n_far=25)
    table = rng.normal(size=t).astype(np.float32)
    _, got = _gather_pair(idx, t, table)
    assert (got == table[idx]).all()


def test_outliers_ride_exceptions_not_window(rng):
    n, t = 4096, 4096
    idx = _local_idx(rng, n, t, jitter=8)
    idx[7] = t - 1  # single far read
    table = rng.normal(size=t).astype(np.float32)
    tp, got = _gather_pair(idx, t, table)
    assert tp.window <= 256 and tp.exc_pos.size >= 1
    assert (got == table[idx]).all()


@pytest.mark.parametrize("t", [2000, 50000])
def test_fully_scattered_gather_still_exact(rng, t):
    """JAX's shape, whose table fits one window, and a table 25x the cap of
    the window, where nearly every read is an exception."""
    n = 2000
    idx = rng.integers(0, t, n)
    table = rng.normal(size=t).astype(np.float32)
    tp, got = _gather_pair(idx, t, table)
    assert tp.exception_fraction > (0.5 if t > 2048 else -1)
    assert (got == table[idx]).all()


def test_gather_signed_zero_and_short_table(rng):
    """A table shorter than its window, n off the 1024 padding: the windowed
    part returns a stored -0.0 as +0.0 (JAX's sum from 0.0), an exception
    keeps it; both packages agree bit for bit."""
    t, n = 40, 1000
    idx = rng.integers(0, t, n)
    table = rng.normal(size=t).astype(np.float32)
    table[idx[:5]] = -0.0
    tp, got = _gather_pair(idx, t, table)
    assert tp.window >= t and tp.exc_pos.size == 0
    assert not np.signbit(got[:5]).any()


def test_gather_grad_is_segment_sum_and_matches_jax(rng):
    n, t = 1000, 300
    idx = _local_idx(rng, n, t)
    table = rng.normal(size=t).astype(np.float32)
    co = rng.normal(size=n).astype(np.float32)
    jp, tp = jw.windowed_gather_plan(idx, t), tw.windowed_gather_plan(idx, t)
    want = jax.grad(lambda tb: jnp.sum(jw.windowed_gather(tb, jp) * co))(jnp.asarray(table))
    x = torch.from_numpy(table).requires_grad_(True)
    (tw.windowed_gather(x, tp) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)
    ref = np.zeros(t, np.float64)
    np.add.at(ref, idx, co.astype(np.float64))
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_gather_rejects_bad_table():
    jp = jw.windowed_gather_plan(np.zeros(10, np.int64), 64)
    tp = tw.windowed_gather_plan(np.zeros(10, np.int64), 64)
    for gather, plan, zeros in ((jw.windowed_gather, jp, jnp.zeros),
                                (tw.windowed_gather, tp, torch.zeros)):
        with pytest.raises(ValueError, match="length"):
            gather(zeros(63), plan)
        with pytest.raises(ValueError, match="1-D"):
            gather(zeros((64, 2)), plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gather_half_tables_equal_jax(rng, dtype):
    n, t = 3000, 700
    idx = _local_idx(rng, n, t, n_far=10)
    table = rng.normal(size=t).astype(np.float32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jp, tp = jw.windowed_gather_plan(idx, t), tw.windowed_gather_plan(idx, t)
    want = np.asarray(jw.windowed_gather(jnp.asarray(table, jdt), jp).astype(jnp.float32))
    got = tw.windowed_gather(torch.from_numpy(table).to(dtype), tp)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# segment sum (tests/test_windowed.py::TestWindowedSegmentSum)
# ---------------------------------------------------------------------------


def test_segment_sum_matches_jax_and_numpy(rng):
    n_in, s = 7000, 1100
    seg = np.minimum((np.arange(n_in) * s) // n_in, s - 1)
    seg[rng.integers(0, n_in, 30)] = rng.integers(0, s, 30)
    y = rng.normal(size=n_in).astype(np.float32)
    tp, got = _segment_pair(seg, s, y)
    assert tp.window == 4096 and tp.exc_pos.size > 0  # the cap
    ref = np.zeros(s, np.float64)
    np.add.at(ref, seg, y.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_segment_sum_empty_segments(rng):
    n_in, s = 1024, 600
    seg = np.sort(rng.integers(0, s // 2, n_in))  # upper half empty
    y = rng.normal(size=n_in).astype(np.float32)
    _, got = _segment_pair(seg, s, y)
    ref = np.zeros(s, np.float32)
    np.add.at(ref, seg, y)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert (got[s // 2:] == 0).all()


def test_segment_sum_grad_is_gather_and_matches_jax(rng):
    n_in, s = 800, 200
    seg = np.sort(rng.integers(0, s, n_in))
    y = rng.normal(size=n_in).astype(np.float32)
    co = rng.normal(size=s).astype(np.float32)
    jp, tp = jw.windowed_segment_plan(seg, s), tw.windowed_segment_plan(seg, s)
    want = jax.grad(lambda v: jnp.sum(jw.windowed_segment_sum(v, jp) * co))(jnp.asarray(y))
    x = torch.from_numpy(y).requires_grad_(True)
    (tw.windowed_segment_sum(x, tp) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), co[seg], rtol=1e-5, atol=1e-6)


def test_segment_sum_rejects_bad_y():
    jp = jw.windowed_segment_plan(np.zeros(10, np.int64), 4)
    tp = tw.windowed_segment_plan(np.zeros(10, np.int64), 4)
    for ssum, plan, zeros in ((jw.windowed_segment_sum, jp, jnp.zeros),
                              (tw.windowed_segment_sum, tp, torch.zeros)):
        with pytest.raises(ValueError, match="n_in"):
            ssum(zeros(9), plan)
        with pytest.raises(ValueError, match="n_in"):
            ssum(zeros((10, 1)), plan)


def test_segment_sum_bf16_matches_jax(rng):
    n_in, s = 2000, 300
    seg = np.sort(rng.integers(0, s, n_in))
    y = rng.normal(size=n_in).astype(np.float32)
    jp, tp = jw.windowed_segment_plan(seg, s), tw.windowed_segment_plan(seg, s)
    want = np.asarray(jw.windowed_segment_sum(jnp.asarray(y, jnp.bfloat16), jp), np.float32)
    got = tw.windowed_segment_sum(torch.from_numpy(y).to(torch.bfloat16), tp)
    assert got.dtype == torch.bfloat16
    # both sum in fp32 and round once to bf16; the orders differ
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the kernels' plain versions and their checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["local", "scattered", "empty_segments", "past_n_in"])
def test_segsum_plain_sums_in_the_kernels_order(rng, case):
    """The plain version adds each segment's windowed entries in ascending
    position from 0.0 in fp32, as the kernel does: equal bit for bit to a
    sequential numpy fp32 sum over the kept entries; entries marked -1 add
    nothing, even NaN, and windows may run past n_in."""
    n_in, s = {"local": (3000, 500), "scattered": (1500, 700), "empty_segments": (900, 400),
               "past_n_in": (1030, 300)}[case]
    seg = {"local": lambda: np.minimum((np.arange(n_in) * s) // n_in + rng.integers(0, 3, n_in),
                                       s - 1),
           "scattered": lambda: rng.integers(0, s, n_in),
           "empty_segments": lambda: np.sort(rng.integers(0, s // 3, n_in)),
           "past_n_in": lambda: np.sort(rng.integers(0, s, n_in))}[case]()
    plan = tw.windowed_segment_plan(seg, s)
    y = rng.normal(size=n_in).astype(np.float32)
    y[plan.seg_masked < 0] = np.nan  # the kernel skips them, whatever their value
    got = tw._segsum_plain(torch.from_numpy(y), torch.from_numpy(plan.seg_masked),
                           torch.from_numpy(plan.starts), num_segments=s, window=plan.window)
    want = np.zeros(s, np.float32)
    for j in range(n_in):
        o = plan.seg_masked[j]
        if o >= 0:
            want[o] = np.float32(want[o] + y[j])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_kernel_entry_points_check_their_arguments():
    rel = torch.zeros(1024, dtype=torch.int32)
    starts = torch.zeros(8, dtype=torch.int32)
    table = torch.zeros(10)
    with pytest.raises(TypeError, match="float64"):
        tw.windowed_gather_kernel(table.double(), rel, starts, n=10, window=128)
    with pytest.raises(TypeError, match="int32"):
        tw.windowed_gather_kernel(table, rel.long(), starts, n=10, window=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tw.windowed_gather_kernel(table, rel, starts, n=10, window=100)
    with pytest.raises(ValueError, match="too short"):
        tw.windowed_gather_kernel(table, rel, starts, n=2000, window=128)
    with pytest.raises(ValueError, match="must match y"):
        tw.windowed_segsum_kernel(table, rel, starts, num_segments=4, window=128)
    with pytest.raises(ValueError, match="contiguous"):
        tw.windowed_segsum_kernel(torch.zeros(20)[::2], rel[:10], starts, num_segments=4,
                                  window=128)


def test_kernel_wrappers_count_no_launch_on_the_cpu(rng):
    tw.reset_launch_counts()
    plan = tw.windowed_gather_plan(_local_idx(rng, 500, 100), 100)
    tw.windowed_gather(torch.ones(100), plan)
    splan = tw.windowed_segment_plan(np.sort(rng.integers(0, 50, 300)), 50)
    tw.windowed_segment_sum(torch.ones(300), splan)
    assert tw.launch_counts() == {"windowed_gather": 0, "windowed_segsum": 0}


def test_pick_window_equals_jax(rng):
    for widths, nspan, cap in ((rng.integers(1, 600, 5000), 40, 2048),
                               (rng.integers(1, 5000, 300), 3, 4096),
                               (np.array([1, 2, 3]), 1, 128)):
        assert tw._pick_window(widths, nspan, cap) == jw._pick_window(widths, nspan, cap)
    assert tw.xla_index_cost_s(12345) == jw.xla_index_cost_s(12345)


def _aggregation_map(seed, shape=(24, 24, 12), block=(3, 3, 2)):
    """An AMG-shaped aggregation map: each point of a 3-D grid goes to the
    aggregate of its 3x3x2 box, aggregates numbered in a locally shuffled
    order, so ids are unsorted and a 128-aggregate span draws from
    thousands of positions."""
    rng = np.random.default_rng(seed)
    g = np.indices(shape).reshape(3, -1).T // np.array(block)
    na = np.array(shape) // np.array(block)
    ids = (g[:, 0] * na[1] + g[:, 1]) * na[2] + g[:, 2]
    n_agg = int(np.prod(na))
    return np.argsort(np.arange(n_agg) + rng.integers(0, 300, n_agg))[ids], n_agg


def test_unsorted_aggregation_map_at_cap_16384_matches_jax():
    """The restriction map of AMG's factored prolongator (amg.py plans it at
    cap=16384): unsorted ids, windows of thousands of entries and a few
    exceptions, against the JAX package at the fp32 tier and float64."""
    seg, s = _aggregation_map(0)
    assert not np.all(np.diff(seg) >= 0)
    y = np.random.default_rng(1).normal(size=seg.size).astype(np.float32)
    jp = jw.windowed_segment_plan(seg, s, cap=16384)
    tp = tw.windowed_segment_plan(seg, s, cap=16384)
    _same_plan(tp, jp, SEGMENT_FIELDS)
    assert tp.window > 4096 and tp.exc_pos.size > 0
    want = np.asarray(jw.windowed_segment_sum(jnp.asarray(y), jp))
    got = tw.windowed_segment_sum(torch.from_numpy(y), tp).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ref = np.zeros(s)
    np.add.at(ref, seg, y.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
