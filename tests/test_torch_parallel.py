"""Parity of the port's sharded SpMM, solvers, DIA matvec and scaling
projection (tpusparse_torch.parallel) with the JAX package's
(tpusparse.parallel).

The port runs as 4 processes on a gloo group (`torch_parallel_worker.py`,
launched once for the module); the JAX side runs the same functions on the
same inputs over 4 of the 8 CPU devices, Pallas in interpret mode. A case
per entry point also runs the port at world size 1 in this process, the
form the card runs.

Tolerances: plan arrays and byte counts exact; products and matvecs at the
JAX suite's fp32 tier (rtol 1e-4, atol 5e-5); CG and the power iteration at
JAX's own test bounds (rtol 1e-3, atol 1e-4); the projection's rows at
rtol 1e-6 given the same constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse as ts
import tpusparse.parallel as jpar
from tpusparse import linalg as jlinalg
from tpusparse.parallel.dia import make_sharded_dia_matvec as j_dia_matvec
from tpusparse.parallel.dia import sharded_dia_cg as j_dia_cg
from tpusparse.parallel.linalg import make_sharded_matvec as j_matvec
from tpusparse.parallel.linalg import sharded_cg as j_cg
from tpusparse.parallel.linalg import sharded_power_iteration as j_power
from tpusparse.parallel.projection import halo_comm_bytes_per_dev as j_halo_bytes

import tpusparse_torch as tt
from tpusparse_torch import parallel as tpar
from tpusparse_torch.parallel.projection import halo_comm_bytes_per_dev

import torch_parallel_worker as W

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
SOLVER_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_parallel.py's bounds


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of the 'spmm' group on 4 gloo ranks."""
    return W.launch("spmm", tmp_path_factory.mktemp("torch_parallel"))


@pytest.fixture(scope="module")
def ws1():
    """World size 1 on gloo in this process: the card's configuration."""
    tpar.initialize_distributed(device="cpu")
    return tpar.make_mesh(device="cpu"), tpar.make_mesh((1,), ("model",), device="cpu")


def _jmesh(shape, names=("data", "model")):
    return jpar.make_mesh(shape, names, devices=jax.devices()[: int(np.prod(shape))])


def _j(sp):
    return ts.CSR.from_scipy(sp)


def _t(sp):
    return tt.CSR.from_scipy(sp, device="cpu")


def _j_halo(hsp, a, b, mesh):
    """JAX's halo_spmm on the 'model' axis, jitted."""
    return jax.jit(lambda d, bb: jpar.halo_spmm(hsp, d, bb, mesh))(a.data, jnp.asarray(b))


# -- plans -------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bs,ndev", [((128, 96), (8, 16), 4), ((200, 130), (8, 16), 4),
                                           ((200, 130), (8, 16), 3), ((64, 64), (8, 8), 1)])
def test_row_sharded_plan_equals_jax(shape, bs, ndev):
    sp = W.rand_csr(0, shape, 0.08)
    got, want = tpar.shard_plan_rows(_t(sp), ndev, bs), jpar.shard_plan_rows(_j(sp), ndev, bs)
    for name in ("block_cols", "nslots", "scatter_idx"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    for name in ("rows_per_dev", "ell_width", "ndev", "shape", "blocksize"):
        assert getattr(got, name) == getattr(want, name)
    vals = np.random.default_rng(1).random(sp.nnz).astype(np.float32)
    np.testing.assert_array_equal(got.pack_values(torch.from_numpy(vals)).numpy(),
                                  np.asarray(want.pack_values(jnp.asarray(vals))))


@pytest.mark.parametrize("shape,bs,ndev,density", [
    ((128, 128), (8, 16), 4, 0.06), ((160, 250), (8, 16), 4, 0.06), ((64, 64), (8, 8), 2, 0.06),
    ((64, 300), (8, 16), 4, 0.004)])  # the last with empty chunks
def test_halo_plan_equals_jax(shape, bs, ndev, density):
    sp = W.rand_csr(2, shape, density)
    got, want = tpar.shard_plan_2d(_t(sp), ndev, bs), jpar.shard_plan_2d(_j(sp), ndev, bs)
    for name in ("block_cols", "nslots", "scatter_idx"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    for name in ("rows_per_dev", "cols_per_dev", "ell_width", "ndev"):
        assert getattr(got, name) == getattr(want, name)
    vals = np.random.default_rng(1).random(sp.nnz).astype(np.float32)
    np.testing.assert_array_equal(got.pack_values(torch.from_numpy(vals)).numpy(),
                                  np.asarray(want.pack_values(jnp.asarray(vals))))


def test_local_plan_carries_its_chunks_block_count():
    """JAX's local plan has nblocks 0 and picks its executor by VMEM; the
    port's carries the chunk's real count, so at one rank it is the whole
    plan's and `_block_exec` takes the entry point it takes on one card."""
    sp = W.rand_csr(0, (200, 130), 0.08)
    rsp = tpar.shard_plan_rows(_t(sp), 4, (8, 16))
    for i in range(4):
        assert rsp.local_plan(i).nblocks == int(rsp.nslots[i].sum())
        assert rsp.local_plan(i) is rsp.local_plan(i)
    whole = tt.build_plan(_t(sp), (8, 16))
    assert tpar.shard_plan_rows(_t(sp), 1, (8, 16)).local_plan(0).nblocks == whole.nblocks


# -- products ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 96), (200, 130)])
def test_sharded_spmm_matches_jax(ranks, shape):
    sp = W.rand_csr(0, shape, 0.08)
    b = W.dense_b(1, shape[1], 24)
    a = _j(sp)
    rsp, mesh = jpar.shard_plan_rows(a, 4, (8, 16)), _jmesh((1, 4))
    want = jax.jit(lambda d, bb: jpar.sharded_spmm(rsp, d, bb, mesh))(a.data, jnp.asarray(b))
    np.testing.assert_allclose(ranks[f"sharded_{shape}"], np.asarray(want), **TOL)
    assert int(ranks[f"sharded_{shape}_bytes"]) == 0


@pytest.mark.parametrize("shape", [(128, 128), (160, 250)])
def test_halo_spmm_matches_jax(ranks, shape):
    sp = W.rand_csr(2, shape, 0.06)
    b = W.dense_b(3, shape[1], 16)
    a = _j(sp)
    want = _j_halo(jpar.shard_plan_2d(a, 4, (8, 16)), a, b, _jmesh((1, 4)))
    np.testing.assert_allclose(ranks[f"halo_{shape}"], np.asarray(want), **TOL)


def test_halo_spmm_on_a_2d_mesh_matches_jax(ranks):
    sp = W.rand_csr(4, (64, 64), 0.1)
    b = W.dense_b(5, 64, 8)
    a = _j(sp)
    want = _j_halo(jpar.shard_plan_2d(a, 2, (8, 8)), a, b, _jmesh((2, 2)))
    np.testing.assert_allclose(ranks["halo_2d_mesh"], np.asarray(want), **TOL)


def test_ring_adds_in_jaxs_order(ranks):
    """Each strip product is exact, the ring's fp32 sum is not: the port
    equals JAX bit for bit, and JAX's order (strip i, then i + 1, ...) gives
    1, 2, 2, 0 by chunk where the column order would give 1 everywhere."""
    sp, b = W.ring_order_case()
    a = _j(sp)
    want = np.asarray(_j_halo(jpar.shard_plan_2d(a, 4, (8, 8)), a, b, _jmesh((1, 4))))
    np.testing.assert_array_equal(ranks["ring_order"], want)
    np.testing.assert_array_equal(want[::8, 0], [1.0, 2.0, 2.0, 0.0])


def test_ring_bytes_equal_the_model_and_jaxs_count(ranks):
    sp = W.rand_csr(3, (256, 256), 0.06)
    a = _j(sp)
    jhsp = jpar.shard_plan_2d(a, 4, (8, 16))
    jmesh = jpar.make_mesh((4,), ("model",), devices=jax.devices()[:4])
    counted = jpar.count_ppermute_bytes(lambda d, bb: jpar.halo_spmm(jhsp, d, bb, jmesh),
                                        a.data, jnp.zeros((256, 24), jnp.float32))
    hsp = tpar.shard_plan_2d(_t(sp), 4, (8, 16))
    assert int(ranks["halo_bytes"]) == halo_comm_bytes_per_dev(hsp, 24) == counted > 0
    assert j_halo_bytes(jhsp, 24) == counted


# -- solvers ---------------------------------------------------------------------------


def test_sharded_matvec_matches_jax(ranks):
    sp, v, vk = W.matvec_inputs()
    a = _j(sp)
    mv = jax.jit(j_matvec(jpar.shard_plan_rows(a, 4, (8, 8)), a.data, _jmesh((4,), ("model",))))
    np.testing.assert_allclose(ranks["matvec_1d"], np.asarray(mv(jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(ranks["matvec_2d"], np.asarray(mv(jnp.asarray(vk))), **TOL)


def test_sharded_cg_matches_jax(ranks):
    sp, b = W.cg_inputs()
    a, mesh = _j(sp), _jmesh((4,), ("model",))
    want = jax.jit(lambda bb: j_cg(a, bb, mesh, blocksize=(8, 8), tol=1e-8, maxiter=300)[0])(
        jnp.asarray(b))
    np.testing.assert_allclose(ranks["cg"], np.asarray(want), **SOLVER_TOL)
    r = sp.astype(np.float64) @ ranks["cg"].astype(np.float64) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


def test_sharded_power_iteration_matches_jax(ranks):
    """The eigenvalue against JAX's, and the eigen residual as JAX's test
    bounds it (the two start from their own seeded draws, as
    `linalg.power_iteration` does in each package)."""
    sp = W.spd_csr(3)
    a, mesh = _j(sp), _jmesh((4,), ("model",))
    lam = jax.jit(lambda: j_power(a, mesh, blocksize=(8, 8), iters=150)[0])()
    np.testing.assert_allclose(float(ranks["power_lam"]), float(lam), **SOLVER_TOL)
    v = ranks["power_v"].astype(np.float64)
    assert np.linalg.norm(sp @ v - float(ranks["power_lam"]) * v) < 1e-2


def test_sharded_dia_matvec_and_cg_match_jax(ranks):
    mesh = _jmesh((4,), ("model",))
    v, vk, b, v2 = W.dia_inputs()
    a = ts.csr_to_dia(_j(W.laplace2d()))
    mv = jax.jit(j_dia_matvec(a, mesh))
    np.testing.assert_allclose(ranks["dia_1d"], np.asarray(mv(jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(ranks["dia_2d"], np.asarray(mv(jnp.asarray(vk))), **TOL)
    x = jax.jit(lambda bb: j_dia_cg(a, bb, mesh, tol=1e-7, maxiter=500)[0])(jnp.asarray(b))
    np.testing.assert_allclose(ranks["dia_cg"], np.asarray(x), **SOLVER_TOL)
    res = W.laplace2d().astype(np.float64) @ ranks["dia_cg"].astype(np.float64) - b
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-4
    # 250 rows over 4 ranks: the zero-padded tail
    mv2 = jax.jit(j_dia_matvec(ts.csr_to_dia(_j(W.tridiag250())), mesh))
    np.testing.assert_allclose(ranks["dia_tail"], np.asarray(mv2(jnp.asarray(v2))), **TOL)
    with pytest.raises(ValueError, match="bandwidth") as e:
        j_dia_matvec(ts.csr_to_dia(_j(W.wide250())), mesh)
    assert str(ranks["dia_wide_error"]) == str(e.value)


# -- the projection --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sharded", "halo"])
def test_projection_rows_equal_jax(kind, monkeypatch):
    """Given JAX's constants and 180e9 for the ring, the rows equal JAX's."""
    from tpusparse import ops as jops

    from tpusparse_torch import ops as tops

    sp = W.rand_csr(5, (2048, 2048), 0.02)
    monkeypatch.setattr(tops, "_COST", dict(jops.get_cost_constants()))
    if kind == "sharded":
        got = tpar.project_sharded_spmm(_t(sp), 512, (1, 2, 4, 8), (128, 128))
        want = jpar.project_sharded_spmm(_j(sp), 512, (1, 2, 4, 8), (128, 128))
    else:
        got = tpar.project_halo_spmm(_t(sp), 512, (1, 2, 4, 8), (128, 128), link_bw=180e9)
        want = jpar.project_halo_spmm(_j(sp), 512, (1, 2, 4, 8), (128, 128), ici_bw=180e9)
    for g, w in zip(got, want, strict=True):
        assert g.ndev == w.ndev and g.comm_bytes_per_dev == w.comm_bytes_per_dev
        np.testing.assert_allclose([g.t_compute_s, g.t_comm_s, g.t_total_s, g.efficiency],
                                   [w.t_compute_s, w.t_comm_s, w.t_total_s, w.efficiency],
                                   rtol=1e-6)
    table = tpar.projection_table(got, kind)
    assert table.count("\n") == 5 and table == jpar.projection_table(want, kind)


def test_projection_defaults_to_nvlink():
    from tpusparse_torch.parallel.projection import NVLINK_BW

    sp = W.rand_csr(5, (1024, 1024), 0.02)
    (p,) = tpar.project_halo_spmm(_t(sp), 256, (2,), (128, 128))
    hsp = tpar.shard_plan_2d(_t(sp), 2, (128, 128))
    assert NVLINK_BW == 450e9
    assert p.t_comm_s == pytest.approx(hsp.cols_per_dev * 256 * 4.0 / NVLINK_BW, rel=1e-12)


# -- world size 1, in process ------------------------------------------------------------


def test_world_size_1_products_equal_one_card(ws1):
    """At one rank the local plan is the whole plan: `sharded_spmm` equals
    `spmm(method='tiled')` bit for bit, `halo_spmm` sends nothing."""
    mesh, _ = ws1
    sp = W.rand_csr(0, (200, 130), 0.08)
    a = _t(sp)
    b = torch.from_numpy(W.dense_b(1, 130, 24))
    single = tt.spmm(a, b, method="tiled", blocksize=(8, 16))
    got = tpar.sharded_spmm(tpar.shard_plan_rows(a, 1, (8, 16)), a.data, b, mesh)
    assert torch.equal(got, single)
    hsp = tpar.shard_plan_2d(a, 1, (8, 16))
    assert tpar.count_p2p_bytes(tpar.halo_spmm, hsp, a.data, b, mesh) == 0
    torch.testing.assert_close(tpar.halo_spmm(hsp, a.data, b, mesh), single, **TOL)
    with pytest.raises(ValueError, match="plan for 4 ranks"):
        tpar.sharded_spmm(tpar.shard_plan_rows(a, 4, (8, 16)), a.data, b, mesh)


def test_world_size_1_solvers_match_one_card(ws1):
    _, mesh = ws1
    sp, v, vk = W.matvec_inputs()
    a = _t(sp)
    mv = tpar.make_sharded_matvec(tpar.shard_plan_rows(a, 1, (8, 8)), a.data, mesh)
    for x in (v, vk):
        torch.testing.assert_close(mv(torch.from_numpy(x)), tt.spmm(
            a, torch.from_numpy(x if x.ndim == 2 else x[:, None]), method="tiled",
            blocksize=(8, 8)).reshape(x.shape), **TOL)
    with pytest.raises(ValueError, match="length-128"):
        mv(torch.zeros(64))
    with pytest.raises(ValueError, match="square"):
        tpar.make_sharded_matvec(tpar.shard_plan_rows(_t(W.rand_csr(0, (64, 32), 0.1)), 1),
                                 torch.zeros(1), mesh)
    sp, b = W.cg_inputs()
    x, _ = tpar.sharded_cg(_t(sp), torch.from_numpy(b), mesh, blocksize=(8, 8), tol=1e-8,
                           maxiter=300)
    want, _ = tt.linalg.cg(_t(sp), torch.from_numpy(b), tol=1e-8, maxiter=300)
    torch.testing.assert_close(x, want, **SOLVER_TOL)
    lam, vec = tpar.sharded_power_iteration(_t(W.spd_csr(3)), mesh, blocksize=(8, 8), iters=150)
    lam1, vec1 = tt.linalg.power_iteration(_t(W.spd_csr(3)), iters=150)
    torch.testing.assert_close(lam, lam1, **SOLVER_TOL)
    torch.testing.assert_close(vec, vec1, **SOLVER_TOL)
    jlam, _ = jlinalg.power_iteration(_j(W.spd_csr(3)), iters=150)
    np.testing.assert_allclose(float(lam), float(jlam), **SOLVER_TOL)


def test_world_size_1_dia_matches_one_card(ws1):
    _, mesh = ws1
    v, vk, b, _ = W.dia_inputs()
    a = tt.csr_to_dia(_t(W.laplace2d()))
    mv = tpar.make_sharded_dia_matvec(a, mesh)
    for x in (v, vk):
        torch.testing.assert_close(mv(torch.from_numpy(x)), tt.dia_spmm(a, torch.from_numpy(x)),
                                   **TOL)
    x, _ = tpar.sharded_dia_cg(a, torch.from_numpy(b), mesh, tol=1e-7, maxiter=500)
    res = W.laplace2d().astype(np.float64) @ x.numpy().astype(np.float64) - b
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-4
    with pytest.raises(ValueError, match="square"):
        tpar.make_sharded_dia_matvec(tt.csr_to_dia(_t(W.rand_csr(0, (64, 32), 0.1))), mesh)


def test_make_mesh_checks_its_shape(ws1):
    with pytest.raises(ValueError, match="world size 1"):
        tpar.make_mesh((2, 1), device="cpu")
    mesh, _ = ws1
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
