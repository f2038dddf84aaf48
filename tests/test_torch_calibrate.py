"""The port's router calibration against the JAX package's: tests/test_calibrate.py's
cases on the port, each then held against JAX on the same inputs. The fit
lives in its own file, applies only to operands on a card of the name it
was stamped with, and never to a CPU tensor; `calibrate()` itself needs the
card and raises here."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse as ts
import tpusparse_torch as tt
from tpusparse import ops as jops
from tpusparse.utils import calibrate as jcal
from tpusparse_torch import ops
from tpusparse_torch.utils.calibrate import (
    _CAL_KEYS,
    calibration_path,
    load_calibration,
    load_gemm_tiles,
    save_calibration,
    save_gemm_tile,
)

CARD = "NVIDIA H100 80GB HBM3"  # a card name to stamp fits with


@pytest.fixture
def restore_constants():
    """Each test starts from JAX's constants with nothing set and no fit
    read (another file on the same worker may have set every constant), and
    the state found is put back after it."""
    saved = (dict(ops._COST), set(ops._SET_KEYS), dict(ops._FITS))
    jsaved = jops.get_cost_constants()
    ops._COST.clear()
    ops._COST.update(ops._COST_DEFAULTS)
    ops._SET_KEYS.clear()
    ops._FITS.clear()
    ops._ROUTE_CACHE.clear()
    yield
    ops._COST.clear()
    ops._COST.update(saved[0])
    ops._SET_KEYS.clear()
    ops._SET_KEYS.update(saved[1])
    ops._FITS.clear()
    ops._FITS.update(saved[2])
    ops._ROUTE_CACHE.clear()
    jops.set_cost_constants(**jsaved)


def _pair(rng):
    """test_routing_honors_constants' input in both packages."""
    j = ts.random_csr(3, (1024, 1024), 0.02)
    t = tt.CSR(torch.from_numpy(np.array(j.data)), np.asarray(j.indices), np.asarray(j.indptr),
               j.shape)
    b = rng.random((1024, 256), dtype=np.float32)
    return j, t, b


def test_defaults_equal_jax():
    assert ops._COST_DEFAULTS == jops._COST_DEFAULTS
    assert set(_CAL_KEYS) == set(jcal._CAL_KEYS) == set(ops._COST_DEFAULTS)


def test_set_get_roundtrip(restore_constants):
    before = ops.get_cost_constants()
    after = ops.set_cost_constants(tiled_bw=123e9)
    assert after["tiled_bw"] == 123e9
    assert ops.get_cost_constants()["tiled_bw"] == 123e9
    assert after["dia_bw"] == before["dia_bw"]
    assert after == jops.set_cost_constants(tiled_bw=123e9)


def test_set_unknown_key_raises():
    with pytest.raises(KeyError, match="unknown cost constant"):
        ops.set_cost_constants(warp_size=32)


def test_save_load_roundtrip(tmp_path):
    consts = {k: float(i + 1) for i, k in enumerate(_CAL_KEYS)}
    p = str(tmp_path / "cal.json")
    save_calibration(consts, p)
    assert load_calibration(p) == consts
    with open(p) as f:
        payload = json.load(f)
    assert payload["backend"] == "cpu" and payload["device_kind"] == "cpu"
    save_calibration(consts, p, device_name=CARD)
    assert load_calibration(p, device_name=CARD) == consts
    jp = str(tmp_path / "jcal.json")
    jcal.save_calibration(consts, jp)
    assert jcal.load_calibration(jp) == load_calibration(p, device_name=CARD)


def test_tile_sections_roundtrip(tmp_path):
    p = str(tmp_path / "cal.json")
    save_calibration({"tiled_bw": 1.0}, p)
    save_gemm_tile("64x64x64xfloat32", (32, 64, 16), p)
    assert load_gemm_tiles(p) == {"64x64x64xfloat32": [32, 64, 16]}
    assert load_calibration(p) == {"tiled_bw": 1.0}  # the constants are kept
    jp = str(tmp_path / "jcal.json")
    jcal.save_gemm_tile("64x64x64xfloat32", (32, 64, 16), jp)
    assert jcal.load_gemm_tiles(jp) == load_gemm_tiles(p)


def test_load_missing_returns_none(tmp_path):
    assert load_calibration(str(tmp_path / "nope.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert load_calibration(str(bad)) is None
    assert jcal.load_calibration(str(bad)) is None


def test_calibration_env_path(tmp_path, monkeypatch):
    p = str(tmp_path / "env_cal.json")
    monkeypatch.setenv("TPUSPARSE_TORCH_CALIBRATION", p)
    monkeypatch.setenv("TPUSPARSE_CALIBRATION", str(tmp_path / "jax.json"))
    assert calibration_path() == p
    assert jcal.calibration_path() != p  # the packages keep separate fits
    monkeypatch.delenv("TPUSPARSE_TORCH_CALIBRATION")
    assert calibration_path().endswith("/.tpusparse_torch/calibration.json")


def test_import_loader_applies_fit(tmp_path, monkeypatch, restore_constants):
    p = str(tmp_path / "cal.json")
    save_calibration({"tiled_bw": 42e9}, p, device_name=CARD)
    monkeypatch.setenv("TPUSPARSE_TORCH_CALIBRATION", p)
    cost, fit = ops._load_calibration_into_cost(CARD, force=True)
    assert cost["tiled_bw"] == 42e9 and fit == CARD
    # the CPU routes on JAX's constants, a card of another name too
    assert ops.get_cost_constants()["tiled_bw"] == jops._COST_DEFAULTS["tiled_bw"]
    assert ops._load_calibration_into_cost("another card", force=True) == (ops._COST, None)
    # an explicit override wins over the fit, as in JAX
    ops.set_cost_constants(tiled_bw=7e9)
    assert ops._load_calibration_into_cost(CARD)[0]["tiled_bw"] == 7e9


def test_load_rejects_other_device_fit(tmp_path):
    p = tmp_path / "cal.json"
    p.write_text(json.dumps({"constants": {"tiled_bw": 42e9}, "backend": "cuda",
                             "device_kind": CARD}))
    # no card here: a fit of the card does not apply
    assert load_calibration(str(p)) is None
    assert load_calibration(str(p), device_name="another card") is None
    p.write_text(json.dumps({"constants": {"tiled_bw": 42e9}}))  # no stamp
    assert load_calibration(str(p), device_name=CARD) is None


def test_fit_in_home_changes_no_cpu_route(tmp_path, monkeypatch, rng, restore_constants):
    """A fit that makes gathers free, for the CPU and for a card, saved
    where the router looks: a CPU tensor still routes as JAX's defaults do,
    while the same operand routed as if on the card follows the fit, and
    the route cache keeps the two decisions apart."""
    j, t, b = _pair(rng)
    free = dict(gather_row_bw=1e18, gather_per_nnz_floor=1e-15)
    p = str(tmp_path / "cal.json")
    monkeypatch.setenv("TPUSPARSE_TORCH_CALIBRATION", p)
    save_calibration(free, p, device_name=CARD)
    ops._FITS.clear()
    ops._ROUTE_CACHE.clear()
    cpu_route = ops._route_spmm(t, torch.from_numpy(b), None)
    assert cpu_route == jops._route_spmm(j, jnp.asarray(b), None) != "gather"
    monkeypatch.setattr(ops, "_device_name", lambda device: CARD)
    assert ops._route_spmm(t, torch.from_numpy(b), None) == "gather"
    monkeypatch.undo()
    assert ops._route_spmm(t, torch.from_numpy(b), None) == cpu_route
    # a fit stamped for the CPU does not reach a CPU tensor either
    save_calibration(free, p)
    ops._FITS.clear()
    assert ops._route_spmm(t, torch.from_numpy(b), None) == cpu_route


def test_routing_honors_constants(rng, restore_constants):
    j, t, b = _pair(rng)
    for consts, want_gather in ((dict(gather_row_bw=1e18, gather_per_nnz_floor=1e-15), True),
                                (dict(gather_row_bw=1e3, gather_per_nnz_floor=1e3), False)):
        ops.set_cost_constants(**consts)
        jops.set_cost_constants(**consts)
        route = ops._route_spmm(t, torch.from_numpy(b), None)
        assert (route == "gather") == want_gather
        assert route == jops._route_spmm(j, jnp.asarray(b), None)


def test_install_fit_replaces_overrides(restore_constants):
    ops.set_cost_constants(tiled_bw=7e9)
    ops._install_fit(CARD, {"tiled_bw": 42e9})
    assert ops._load_calibration_into_cost(CARD)[0]["tiled_bw"] == 42e9
    assert ops.get_cost_constants()["tiled_bw"] == 7e9  # the CPU's stays


def test_calibrate_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.calibrate(save=False)


# -- 'auto' as the default -------------------------------------------------------


def _recording_router(monkeypatch):
    routes = []
    route = ops._route_spmm
    monkeypatch.setattr(ops, "_route_spmm",
                        lambda *a, **k: routes.append(route(*a, **k)) or routes[-1])
    return routes


def test_dsmm_with_no_method_routes_as_jax_auto(rng, monkeypatch):
    j = ts.random_csr(4, (48, 40), 0.1)
    t = _port_csr(j)
    x = rng.standard_normal((6, 48)).astype(np.float32)
    routes = _recording_router(monkeypatch)
    got = tt.dsmm(torch.from_numpy(x), t)
    want = jops.dsmm(jnp.asarray(x), j)
    jt = jops.transpose_csr(j)
    assert routes == [jops._route_spmm(jt, jnp.asarray(x).T, None)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-5)


def _port_csr(j):
    return tt.CSR(torch.from_numpy(np.array(j.data)), np.asarray(j.indices, np.int32),
                  np.asarray(j.indptr, np.int32), tuple(j.shape))


@pytest.mark.parametrize("family", ["gcn", "gat"])
def test_graph_models_with_no_method_route_as_jax_auto(family, monkeypatch):
    """GCN and GAT built without `spmm_method` take 'auto' in both packages:
    each aggregation routes as JAX's does, the log-probabilities agree at the
    fp32 tier, and the dense float64 references (`gcn_reference`,
    `gat_layer_reference`) on the port's parameters equal JAX's on its."""
    from tpusparse.models import gat as jgat
    from tpusparse.models import gcn as jgcn
    from tpusparse_torch.models import gat as tgat
    from tpusparse_torch.models import gcn as tgcn

    adj = tt.random_graph(5, 40, avg_degree=4.0, device="cpu")
    x = np.random.default_rng(6).standard_normal((40, 10)).astype(np.float32)
    if family == "gcn":
        a_t = tt.normalized_adjacency(adj)
        jm, tm = jgcn.GCN(hidden=(16,), num_classes=4), tt.GCN(10, hidden=(16,), num_classes=4,
                                                              device="cpu")
    else:
        a_t = tt.add_self_loops(adj)
        jm = jgat.GAT(hidden=(6,), num_heads=3, num_classes=4)
        tm = tt.GAT(10, hidden=(6,), num_heads=3, num_classes=4, device="cpu")
    assert jm.spmm_method == "auto"
    a_j = ts.CSR(jnp.asarray(a_t.data.numpy()), a_t.indices, a_t.indptr, a_t.shape)
    params = jm.init(jax.random.PRNGKey(3), a_j, jnp.asarray(x))
    tt.load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    routes = _recording_router(monkeypatch)
    with torch.no_grad():
        got = tm(a_t, torch.from_numpy(x)).numpy()
    widths = [16, 4] if family == "gcn" else [6] * 3 + [4] * 3
    assert routes == [jops._route_spmm(a_j, jnp.zeros((40, w)), None) for w in widths]
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, a_j, jnp.asarray(x))),
                               rtol=1e-4, atol=5e-5)
    dense = a_t.to_dense().numpy()
    if family == "gcn":
        want = jgcn.gcn_reference(dense, params, x)
        np.testing.assert_allclose(tgcn.gcn_reference(dense, tm, x), want, rtol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)
    else:
        kw = dict(features=6, num_heads=3, concat=True)
        want = jgat.gat_layer_reference(dense, params["params"]["gat1"], x, **kw)
        np.testing.assert_allclose(tgat.gat_layer_reference(dense, tm.gat1, x, **kw), want,
                                   rtol=1e-12)
        with torch.no_grad():
            np.testing.assert_allclose(tm.gat1(a_t, torch.from_numpy(x)).numpy(), want,
                                       rtol=1e-4, atol=5e-5)
