"""Parity of the port's banded algebra with the JAX package
(tests/test_dia.py): the DIA container and its conversions, `dia_spmm` on
its three paths, the wide-DIA kernel's plain version against
`dia_spmv_pallas` (interpret mode here), `PackedDIA`'s plane order, the
gradients, `spmm(method='dia')`, `dsmm` and the cost-model router
`_route_spmm`. The same numpy inputs go through both packages; values meet
the fp32 tier of the JAX suite. On CPU tensors the kernel wrapper runs its
plain version; tests/test_torch_cuda.py and chip_smoke.py hold the CUDA
kernel against it on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import tpusparse as ts
import tpusparse_torch as tt
from tpusparse import ops as jops
from tpusparse.kernels import dia as jd
from tpusparse.types import DIA as JDIA
from tpusparse.types import csr_to_dia as j_csr_to_dia
from tpusparse.types import dia_to_csr as j_dia_to_csr
from tpusparse_torch import ops as tops
from tpusparse_torch.kernels import dia as td
from tpusparse_torch.types import DIA, csr_to_dia, dia_to_csr

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite


def _band(m, k, offsets, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, k), np.float32)
    for off in offsets:
        i = np.arange(max(0, -off), min(m, k - off))
        dense[i, i + off] = rng.standard_normal(i.size).astype(np.float32)
    return ssp.csr_matrix(dense)


def _pair(sp):
    return tt.CSR.from_scipy(sp, device="cpu"), ts.CSR.from_scipy(sp)


def _wide(seed, m, k, nd, lo=-700, hi=700):
    rng = np.random.default_rng(seed)
    offs = np.unique(rng.integers(lo, hi, 4 * nd))[:nd].astype(np.int64)
    return offs, rng.standard_normal((offs.size, m)).astype(np.float32), rng


def _dense_of(data, offs, m, k):
    out = np.zeros((m, k))
    for d, off in enumerate(offs):
        i = np.arange(max(0, -off), min(m, k - off))
        out[i, i + off] += data[d, i]
    return out


@pytest.mark.parametrize("shape,offsets", [((40, 40), [-3, 0, 1, 5]), ((30, 45), [-4, 2, 20]),
                                           ((50, 20), [-35, -1, 0, 7])])
def test_container_and_conversions_match_jax(shape, offsets):
    sp = _band(*shape, offsets, seed=len(offsets))
    t_csr, j_csr = _pair(sp)
    t, j = csr_to_dia(t_csr), j_csr_to_dia(j_csr)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t._valid_mask(), j._valid_mask())
    assert (t.noffsets, t.bandwidth, t.shape) == (j.noffsets, j.bandwidth, j.shape)
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    tt_, jt = t.T, j.T
    np.testing.assert_array_equal(tt_.offsets, jt.offsets)
    np.testing.assert_array_equal(tt_.data.numpy(), np.asarray(jt.data))
    dense = sp.toarray()
    np.testing.assert_array_equal(DIA.from_dense(dense, device="cpu").data.numpy(),
                                  np.asarray(JDIA.from_dense(dense).data))
    back, jback = dia_to_csr(t), j_dia_to_csr(j)
    np.testing.assert_array_equal(back.indptr, jback.indptr)
    np.testing.assert_array_equal(back.indices, jback.indices)
    np.testing.assert_array_equal(back.data.numpy(), np.asarray(jback.data))
    s_t, s_j = t.to_scipy(), j.to_scipy()
    np.testing.assert_array_equal(s_t.data, s_j.data)
    np.testing.assert_array_equal(s_t.toarray(), dense)
    f = DIA.from_scipy(ssp.dia_matrix(dense), device="cpu")
    np.testing.assert_array_equal(f.data.numpy(), np.asarray(JDIA.from_scipy(ssp.dia_matrix(dense)).data))
    rt, rj = t.report(n_cols=4), j.report(n_cols=4)
    for key in ("format", "noffsets", "bandwidth", "nnz", "density", "pad_overhead",
                "useful_flops", "bytes_moved", "bound"):
        assert rt[key] == rj[key], key
    # the projection uses the card's roofline, not the TPU's
    assert rt["projected_time_s"] == pytest.approx(rt["bytes_moved"] / 3.35e12)


def test_from_scipy_with_trimmed_trailing_columns():
    m_sp = ssp.coo_matrix(([1.0], ([0], [0])), shape=(5, 5)).todia()
    d = DIA.from_scipy(m_sp, device="cpu")
    np.testing.assert_array_equal(d.data.numpy(), np.asarray(JDIA.from_scipy(m_sp).data))
    ref = np.zeros((5, 5))
    ref[0, 0] = 1.0
    np.testing.assert_array_equal(d.to_dense().numpy(), ref)


def test_container_guards():
    with pytest.raises(ValueError, match="sorted"):
        DIA(data=torch.zeros(2, 4), offsets=np.array([1, 0]), shape=(4, 4))
    sp = ssp.random(64, 64, density=0.3, random_state=1, format="csr", dtype=np.float32)
    with pytest.raises(ValueError, match="distinct diagonals"):
        csr_to_dia(tt.CSR.from_scipy(sp, device="cpu"), max_offsets=8)
    d = csr_to_dia(_pair(_band(8, 8, [0]))[0])
    with pytest.raises(TypeError, match="dia_to_csr"):
        tt.sp_add(d, d)
    with pytest.raises(ValueError, match="incompatible"):
        tops.dia_spmm(d, torch.zeros(9, 2))
    with pytest.raises(ValueError, match="reduce='sum' only"):
        tops.spmm(d, torch.zeros(8, 2), reduce="max")


@pytest.mark.parametrize("path,nd,ncols,shape", [
    ("unrolled", 7, 3, (300, 300)),
    ("unrolled_rect", 40, 1, (260, 300)),
    ("scan", 300, 3, (700, 700)),
    ("scan_rect", 150, 2, (600, 520)),
    ("kernel", 200, 1, (900, 900)),
    ("kernel_rect", 150, 1, (700, 610)),
])
def test_dia_spmm_paths_match_jax(path, nd, ncols, shape):
    m, k = shape
    offs, data, rng = _wide(nd + m, m, k, nd, -m + 5, k - 5)
    x = rng.standard_normal((k, ncols)).astype(np.float32)
    t = DIA(data=torch.from_numpy(data), offsets=offs, shape=shape)
    j = JDIA(data=jnp.asarray(data), offsets=offs, shape=shape)
    b = x[:, 0] if ncols == 1 else x
    got = tops.dia_spmm(t, torch.from_numpy(b)).numpy()
    want = np.asarray(jops.dia_spmm(j, jnp.asarray(b)))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _dense_of(data, offs, m, k) @ b, **TOL)


def test_dia_spmm_batched_b():
    offs, data, rng = _wide(3, 64, 64, 9, -60, 60)
    b = rng.standard_normal((3, 64, 5)).astype(np.float32)
    t = DIA(data=torch.from_numpy(data), offsets=offs, shape=(64, 64))
    j = JDIA(data=jnp.asarray(data), offsets=offs, shape=(64, 64))
    np.testing.assert_allclose(tops.dia_spmm(t, torch.from_numpy(b)).numpy(),
                               np.asarray(jops.dia_spmm(j, jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("case", ["square", "rect_tall", "rect_wide", "past_both_edges",
                                  "bf16_plane", "one_diagonal"])
def test_plain_kernel_matches_dia_spmv_pallas(case):
    m, k, nd, lo, hi, dt = {
        "square": (800, 800, 250, -700, 700, np.float32),
        "rect_tall": (900, 640, 180, -850, 600, np.float32),
        "rect_wide": (600, 880, 160, -500, 850, np.float32),
        "past_both_edges": (640, 640, 200, -1200, 1200, np.float32),
        "bf16_plane": (700, 700, 150, -600, 600, jnp.bfloat16),
        "one_diagonal": (700, 700, 1, -3, 3, np.float32),
    }[case]
    offs, data, rng = _wide(7, m, k, nd, lo, hi)
    x = rng.standard_normal(k).astype(np.float32)
    jdata = jnp.asarray(data).astype(dt)
    want = np.asarray(jd.dia_spmv_pallas(jdata, offs, jnp.asarray(x)))
    tdata = torch.from_numpy(np.array(jdata.astype(jnp.float32)))
    if dt == jnp.bfloat16:
        tdata = tdata.to(torch.bfloat16)
    got = td.dia_spmv(tdata, offs, torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the kernel's entry point sums in the plane's row order
    plane, p_offs = td._pack_dia(tdata, offs)
    direct = td.dia_spmv_kernel(plane, td._offsets_tensor(p_offs, "cpu"), torch.from_numpy(x))
    np.testing.assert_array_equal(direct.numpy(), got.numpy())


def test_plain_kernel_sums_in_plane_order_and_rounds_bf16_products():
    """The plain version's contract, which the CUDA kernel repeats bit for
    bit: products in the plane's row order, each bf16 x bf16 product rounded
    to bf16, an fp32 sum from 0, a zero past the edge that still multiplies
    (an inf in an invalid slot gives NaN, as JAX's padded x does)."""
    rng = np.random.default_rng(0)
    nd, m, k = 5, 9, 7
    offs = np.array([3, -2, 0, 8, -1], np.int32)
    data = torch.from_numpy(rng.standard_normal((nd, m)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(torch.bfloat16)
    got = td.dia_spmv_kernel(data, torch.from_numpy(offs), x)
    want = np.zeros(m, np.float32)
    for d in range(nd):
        for i in range(m):
            j = i + int(offs[d])
            xv = float(x[j]) if 0 <= j < k else 0.0
            p = torch.tensor(float(data[d, i]) * xv, dtype=torch.float32).to(torch.bfloat16)
            want[i] = np.float32(want[i] + np.float32(float(p)))
    np.testing.assert_array_equal(got.numpy(), want)
    data32 = data.float()
    data32[3, 0] = float("inf")  # offset 8 at row 0 reads past x: inf * 0
    assert torch.isnan(td.dia_spmv_kernel(data32, torch.from_numpy(offs), x.float())[0])


def test_packed_dia_matches_jax():
    m = 640
    offs, data, rng = _wide(11, m, m, 160, -400, 400)
    p = td.pack_dia_operator(torch.from_numpy(data), offs, (m, m))
    jp = jd.pack_dia_operator(jnp.asarray(data), offs, (m, m))
    np.testing.assert_array_equal(p.offsets, jp.offsets)  # plane order, unsorted
    assert not np.array_equal(p.offsets, np.sort(p.offsets))
    np.testing.assert_array_equal(p.unpack_data().numpy(), np.asarray(jp.unpack_data()))
    assert p.shape == jp.shape and p.dtype == torch.float32
    x = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(p(torch.from_numpy(x)).numpy(), np.asarray(jp(jnp.asarray(x))),
                               **TOL)
    xm = rng.standard_normal((m, 3)).astype(np.float32)  # the multivector route
    np.testing.assert_allclose(p.mv(torch.from_numpy(xm)).numpy(),
                               np.asarray(jp.mv(jnp.asarray(xm))), **TOL)


@pytest.mark.parametrize("path", ["unrolled", "kernel"])
def test_grads_match_jax(path):
    m = 500
    nd = 9 if path == "unrolled" else 140
    offs, data, rng = _wide(5, m, m, nd, -450, 450)
    x = rng.standard_normal(m).astype(np.float32)
    g = rng.standard_normal(m).astype(np.float32)

    def jloss(d_, x_):
        return jnp.sum(jops.dia_spmm(JDIA(data=d_, offsets=offs, shape=(m, m)), x_) * g)

    jgd, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(x))
    dd = torch.from_numpy(data).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    (tops.dia_spmm(DIA(data=dd, offsets=offs, shape=(m, m)), xx) * torch.from_numpy(g)).sum(
    ).backward()
    np.testing.assert_allclose(dd.grad.numpy(), np.asarray(jgd), **TOL)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(jgx), **TOL)
    if path == "kernel":  # PackedDIA's plane is a leaf that takes its gradient
        p = td.pack_dia_operator(torch.from_numpy(data), offs, (m, m))
        p.data.requires_grad_()
        (p.mv(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
        order = td.plane_order(offs)
        np.testing.assert_allclose(p.data.grad.numpy(), np.asarray(jgd)[order], **TOL)


def test_spmm_method_dia_and_grads():
    sp = _band(96, 96, [-9, -1, 0, 1, 9], seed=4)
    t_csr, j_csr = _pair(sp)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((96, 6)).astype(np.float32)
    g = rng.standard_normal((96, 6)).astype(np.float32)

    def jloss(vals, b_):
        a_ = ts.CSR(data=vals, indices=j_csr.indices, indptr=j_csr.indptr, shape=j_csr.shape)
        return jnp.sum(jops.spmm(a_, b_, method="dia") * g)

    jdv, jdb = jax.grad(jloss, argnums=(0, 1))(j_csr.data, jnp.asarray(b))
    vals = t_csr.data.clone().requires_grad_()
    bb = torch.from_numpy(b).requires_grad_()
    a = tt.CSR(data=vals, indices=t_csr.indices, indptr=t_csr.indptr, shape=t_csr.shape)
    out = tops.spmm(a, bb, method="dia")
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jops.spmm(j_csr, jnp.asarray(b), method="dia")), **TOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(jdv), **TOL)
    np.testing.assert_allclose(bb.grad.numpy(), np.asarray(jdb), **TOL)
    wide = tt.CSR.from_scipy(ssp.random(200, 200, density=0.5, random_state=0, format="csr",
                                        dtype=np.float32), device="cpu")
    with pytest.raises(ValueError, match="banded"):
        tops.spmm(wide, torch.zeros(200, 2), method="dia")


def test_dsmm_with_dia_operand():
    sp = _band(40, 48, [-2, 0, 3], seed=8)
    t = csr_to_dia(_pair(sp)[0])
    j = j_csr_to_dia(_pair(sp)[1])
    x = np.random.default_rng(0).standard_normal((5, 40)).astype(np.float32)
    got = tops.dsmm(torch.from_numpy(x), t, method="auto").numpy()
    np.testing.assert_allclose(got, np.asarray(jops.dsmm(jnp.asarray(x), j)), **TOL)
    np.testing.assert_allclose(got, x.astype(np.float64) @ sp.toarray(), **TOL)


def _banded_4096():
    return _band(4096, 4096, [-64, -1, 0, 1, 64], seed=1)


def _scattered():
    return ssp.random(2048, 2048, density=0.002, random_state=3, format="csr", dtype=np.float32)


def _blocky():
    mask = ssp.random(16, 16, density=0.5, random_state=4, format="csr", dtype=np.float32)
    return ssp.kron(mask, np.ones((128, 128), np.float32), format="csr")


ROUTE_CASES = {  # pattern, b's shape
    "banded_spmv": (_banded_4096, (4096, 1)),
    "banded_wide_b": (_banded_4096, (4096, 256)),
    "scattered_spmv": (_scattered, (2048, 1)),
    "scattered_wide_b": (_scattered, (2048, 512)),
    "block_dense": (_blocky, (2048, 512)),
    "dense_ish": (lambda: ssp.random(256, 256, density=0.6, random_state=5, format="csr",
                                     dtype=np.float32), (256, 64)),
    "powerlaw": (lambda: tt.random_powerlaw_csr(6, (3000, 3000), 8.0, device="cpu").to_scipy(),
                 (3000, 32)),
    "batched_3d_b": (_blocky, (4, 2048, 64)),
    "batched_3d_b_banded": (_banded_4096, (2, 4096, 8)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_spmm_matches_jax(case):
    make, bshape = ROUTE_CASES[case]
    sp = ssp.csr_matrix(make())
    sp.sort_indices()
    t_csr, j_csr = _pair(sp)
    got = tops._route_spmm(t_csr, torch.zeros(bshape), None)
    want = jops._route_spmm(j_csr, np.zeros(bshape, np.float32), None)
    assert got == want
    if case == "banded_spmv":
        assert got == "dia"


def test_cost_constants_are_jax_defaults_and_settable():
    assert tops.get_cost_constants() == jops._COST_DEFAULTS
    sp = _band(4096, 4096, [-64, -1, 0, 1, 64], seed=1)
    t_csr = _pair(sp)[0]
    assert tops._route_spmm(t_csr, torch.zeros(4096, 1), None) == "dia"
    try:
        tops.set_cost_constants(dia_bw=1.0)  # a very slow DIA path routes elsewhere
        assert tops._route_spmm(t_csr, torch.zeros(4096, 1), None) != "dia"
        with pytest.raises(KeyError):
            tops.set_cost_constants(bogus=1.0)
    finally:
        tops.set_cost_constants(**tops._COST_DEFAULTS)


def test_spmm_auto_matches_jax_on_a_banded_operator():
    sp = _band(300, 300, [-17, -1, 0, 1, 17], seed=3)
    t_csr, j_csr = _pair(sp)
    b = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    got = tops.spmm(t_csr, torch.from_numpy(b), method="auto").numpy()
    np.testing.assert_allclose(got, np.asarray(jops.spmm(j_csr, jnp.asarray(b))), **TOL)
    got3 = tops.spmm(t_csr, torch.ones(2, 300, 3), method="auto", reduce="max")
    want3 = jops.spmm(j_csr, jnp.ones((2, 300, 3)), method="auto", reduce="max")
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), **TOL)


def test_binding_matches_the_c_entry_point(monkeypatch):
    """The ctypes argument lists of `dia_spmv` and `dia_x_nonfinite` have one
    type per parameter of the C entry points in csrc/dia_spmv.cu (ctypes
    refuses a call whose count differs, and only on the card)."""
    import re
    from pathlib import Path

    from tpusparse_torch.kernels import _build

    captured = {}
    monkeypatch.setattr(_build, "bind", lambda name, argtypes: captured.update(argtypes))
    td._kernel_fns.__wrapped__()
    src = (Path(td.__file__).resolve().parents[1] / "csrc" / "dia_spmv.cu").read_text()
    params = re.search(r'extern "C" int dia_spmv\(([^)]*)\)', src).group(1).split(",")
    assert len(captured["dia_spmv"]) == len(params) == 16
    params = re.search(r'extern "C" int dia_x_nonfinite\(([^)]*)\)', src).group(1).split(",")
    assert len(captured["dia_x_nonfinite"]) == len(params) == 6


# ---------------------------------------------------------------------------
# the kernel's tile list and the exactness of walking only occupied tiles
# ---------------------------------------------------------------------------


def _tiled_plane(seed, nd, m, dtype=torch.float32):
    """A plane whose row d holds entries only in a band of three 32-row
    tiles (whole zero tiles elsewhere), with a tile of -0.0 in row 1's band
    and a NaN in row 3's; m need not be a multiple of 32."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nd, m)).astype(np.float32)
    ntiles = -(-m // 32)
    band = [(d * ntiles) // nd for d in range(nd)]
    tile_of = np.arange(m) // 32
    for d in range(nd):
        data[d, np.abs(tile_of - band[d]) > 1] = 0.0
    data[1, tile_of == band[1]] = -0.0
    data[3, band[3] * 32 + 5] = np.nan
    return torch.from_numpy(data).to(dtype), band


def test_tile_list_matches_a_numpy_count():
    """For each 32-row tile, the plane rows whose entries there are not all
    ±0, in plane order (NaN counted), with their offsets beside them."""
    nd, m = 23, 203
    data, band = _tiled_plane(1, nd, m)
    offs = np.random.default_rng(2).choice(np.arange(-150, 150), nd, replace=False)
    tiles = td.dia_tile_list(data, torch.from_numpy(offs.astype(np.int32)))
    a = data.numpy()
    want_ptr, want_rows = [0], []
    for t in range(-(-m // 32)):
        want_rows += [d for d in range(nd) if np.any(a[d, 32 * t:32 * t + 32] != 0)]
        want_ptr.append(len(want_rows))
    for got in (tiles.ptr, tiles.rows, tiles.offs):
        assert got.dtype == torch.int32
    np.testing.assert_array_equal(tiles.ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(tiles.rows.numpy(), want_rows)
    np.testing.assert_array_equal(tiles.offs.numpy(), offs[want_rows])
    padded = np.zeros((nd, len(want_ptr) * 32), np.float32)
    padded[:, :m] = a
    tile_of_entry = np.repeat(np.arange(len(want_ptr) - 1), np.diff(want_ptr))
    want_vals = np.stack([padded[d, 32 * t:32 * t + 32] for d, t in zip(want_rows,
                                                                         tile_of_entry)])
    assert tiles.vals.dtype == data.dtype
    np.testing.assert_array_equal(tiles.vals.numpy().view(np.uint32), want_vals.view(np.uint32))
    assert tiles.nocc == len(want_rows) < nd * (len(want_ptr) - 1) // 2  # mostly padding

    def rows_of(t):
        return want_rows[want_ptr[t]:want_ptr[t + 1]]
    assert 1 not in rows_of(band[1]) and 1 in rows_of(band[1] + 1)  # -0.0 is zero
    a[3] = np.where(np.isnan(a[3]), np.nan, 0.0)
    only_nan = td.dia_tile_list(torch.from_numpy(a), torch.from_numpy(offs.astype(np.int32)))
    t3 = only_nan.ptr.numpy()
    assert 3 in only_nan.rows.numpy()[t3[band[3]]:t3[band[3] + 1]]  # NaN is not zero


def test_packed_dia_rebuilds_its_tile_list_when_the_plane_changes():
    """The list is kept while the plane is the same tensor at the same
    version; an in-place change or a new plane gets a new list."""
    m, nd = 100, 9
    offs, data, _ = _wide(4, m, m, nd, -60, 60)
    p = td.pack_dia_operator(torch.from_numpy(data), offs, (m, m))
    first = p.tiles()
    assert p.tiles() is first
    p.data[0, :64] = 0.0  # in place: the version counter moves
    second = p.tiles()
    assert second is not first and second.nocc == first.nocc - 2
    np.testing.assert_array_equal(second.ptr.numpy(), td.dia_tile_list(
        p.data, p._offsets_on("cpu")).ptr.numpy())
    p.data = p.data.clone()
    assert p.tiles() is not second
    with torch.inference_mode():
        q = td.pack_dia_operator(torch.from_numpy(data), offs, (m, m))
    assert q.tiles() is None  # no version counter: the kernel walks every diagonal


def test_packed_dia_keeps_no_tile_list_for_a_trainable_plane():
    """A plane that requires grad gets no list (an optimiser's write through
    `.data` leaves its version counter as it was), so `mv` walks every
    diagonal and sees such a write; a write through `.data` to a plane that
    does not require grad is picked up after `drop_tiles()`."""
    m, nd = 100, 9
    offs, data, rng = _wide(4, m, m, nd, -60, 60)
    x = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    w = td.pack_dia_operator(torch.from_numpy(data).requires_grad_(True), offs, (m, m))
    assert w.tiles() is None
    w.data.data[:, :40] -= 0.5  # a manual SGD step
    assert w.data._version == 0
    want = td._dia_spmv_plain(w.data.detach(), w._offsets_on("cpu"), x)
    assert torch.equal(w.mv(x).detach().view(torch.int32), want.view(torch.int32))
    p = td.pack_dia_operator(torch.from_numpy(data), offs, (m, m))
    first = p.tiles()
    p.data.data[0, :64] = 0.0
    assert p.data._version == 0 and p.tiles() is first
    p.drop_tiles()
    fresh = td.dia_tile_list(p.data, p._offsets_on("cpu"))
    assert p.tiles() is not first and p.tiles().nocc == fresh.nocc == first.nocc - 2
    np.testing.assert_array_equal(p.tiles().rows.numpy(), fresh.rows.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 1000, 1025, 31868])
def test_nonfinite_check_flags_each_slice_of_x(k, dtype):
    """The nonfinite check's plain version (the wrapper's on the CPU) sets
    one flag per slice of x: min(32, ceil(k / 1024)) slices of ceil(k /
    slices) entries, 1 where the slice holds a NaN or an Inf."""
    n = min(32, -(-k // 1024))
    per = -(-k // n)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(k).astype(np.float32))
    x = x.to(dtype)
    assert td.dia_nonfinite_kernel(x).tolist() == [0] * n
    x[k - 1] = float("inf")
    x[(k // 3) % k] = float("nan")
    flags = td.dia_nonfinite_kernel(x)
    assert flags.dtype == torch.int32
    want = [int(b in ((k - 1) // per, ((k // 3) % k) // per)) for b in range(n)]
    assert flags.tolist() == want


def _skip_walk(data, offsets, x):
    """A torch emulation of the kernel's walk over a tile list: each row adds
    only its tile's occupied plane rows, in plane order, from +0 in fp32;
    a row is NaN where a skipped term meets a nonfinite x in range."""
    nd, m = data.shape
    k = x.shape[0]
    tiles = td.dia_tile_list(data, offsets)
    occ = torch.zeros((nd, -(-m // 32)), dtype=torch.bool)
    for t in range(occ.shape[1]):
        occ[tiles.rows[tiles.ptr[t]:tiles.ptr[t + 1]].long(), t] = True
    row_occ = occ.repeat_interleave(32, dim=1)[:, :m]
    i = torch.arange(m)
    acc = torch.zeros(m)
    nan = torch.zeros(m, dtype=torch.bool)
    for d in range(nd):
        j = i + int(offsets[d])
        inside = (j >= 0) & (j < k)
        xv = torch.where(inside, x[j.clamp(0, k - 1)], torch.zeros((), dtype=x.dtype))
        acc = torch.where(row_occ[d], acc + (data[d] * xv).float(), acc)
        nan |= ~row_occ[d] & inside & ~torch.isfinite(xv)
    return torch.where(nan, acc + 0.0 * float("inf"), acc), nan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_case", ["finite", "nan_skipped", "inf_skipped"])
def test_skipping_empty_tiles_is_bitwise_exact(dtype, x_case):
    """Walking only the occupied tiles equals the plain version bit for bit
    (planes with zero tiles, a -0.0 tile and a NaN; x with a NaN or +Inf
    that only skipped terms meet, which makes their rows NaN). NaN rows
    match by position: their payload is the host's, the card's canonical."""
    nd, m, k = 29, 190, 230
    data, _ = _tiled_plane(5, nd, m, dtype)
    offs = np.random.default_rng(6).choice(np.arange(-180, 200), nd, replace=False)
    offsets = torch.from_numpy(offs.astype(np.int32))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(k).astype(np.float32)).to(dtype)
    if x_case != "finite":
        j = 117  # zero every tile whose terms reach x[j]: only skipped terms meet it
        for d in range(nd):
            i = j - int(offs[d])
            if 0 <= i < m:
                data[d, (i // 32) * 32:(i // 32) * 32 + 32] = 0.0
        x[j] = float("nan") if x_case == "nan_skipped" else float("inf")
    want = td._dia_spmv_plain(data, offsets, x)
    got, poisoned = _skip_walk(data, offsets, x)
    assert bool(poisoned.any()) == (x_case != "finite")
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got)) and bool(nan[poisoned].all())
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))
    assert int((~nan).sum()) > m // 2
