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
    """The ctypes argument list of `dia_spmv` has one type per parameter of
    the C entry point in csrc/dia_spmv.cu (ctypes refuses a call whose count
    differs, and only on the card)."""
    import re
    from pathlib import Path

    from tpusparse_torch.kernels import _build

    captured = {}
    monkeypatch.setattr(_build, "bind", lambda name, argtypes: captured.update(argtypes))
    td._kernel_fns.__wrapped__()
    src = (Path(td.__file__).resolve().parents[1] / "csrc" / "dia_spmv.cu").read_text()
    params = re.search(r'extern "C" int dia_spmv\(([^)]*)\)', src).group(1).split(",")
    assert len(captured["dia_spmv"]) == len(params) == 11
