"""Parity of the port's MNIST training (tpusparse_torch.models.mlp,
tpusparse_torch.utils.data, convert.to_flax_params) with the JAX package:
the same flax weights, carried over with load_flax_params, and the same
batches go through both train steps; Pallas runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.utils.config as jconfig
from tpusparse.models.mlp import MnistNet as JMnistNet
from tpusparse.models.mlp import make_train_state as jmake_train_state
from tpusparse.models.mlp import train_step as jtrain_step
from tpusparse.utils import data as jdata

import tpusparse_torch as tt
from tpusparse_torch.utils import data as tdata

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
# variant id: (MnistNet variant, GEMM kernel switch on both sides)
VARIANTS = {
    "xla": ("xla", False),
    "dense": ("dense", False),
    "dense_gemm_kernel": ("dense", True),
    "sparse": ("sparse", False),
    "blocksparse": ("blocksparse", False),
}


@pytest.fixture
def gemm_switch():
    """Sets the GEMM kernel switch of both packages; restores it after."""
    prev_j = jconfig.get_config().use_pallas_gemm
    prev_t = tt.get_config().use_gemm_kernel

    def set_(on):
        jconfig.set_config(use_pallas_gemm=on)
        tt.set_config(use_gemm_kernel=on)

    yield set_
    jconfig.set_config(use_pallas_gemm=prev_j)
    tt.set_config(use_gemm_kernel=prev_t)


def _batches(steps, seed=0):
    tx, ty, _, _ = tdata.synthetic_mnist(seed=seed, n_train=32 * steps, n_test=8)
    return tx.reshape(steps, 32, 784), ty.reshape(steps, 32)


def _flagship_pair(variant):
    """Full-width flagship (784 -> 256 -> 10) in both packages from one set
    of flax weights."""
    jnet = JMnistNet(variant=variant, hidden=256)
    params, tx, opt_state = jmake_train_state(jnet, jax.random.PRNGKey(0))
    tnet = tt.MnistNet(variant, hidden=256, device="cpu")
    tt.load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    return jnet, params, tx, opt_state, tnet


def _assert_trees_close(got, want):
    want = jax.tree_util.tree_map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = want
        for k in path:
            w = w[k.key]
        np.testing.assert_allclose(g, w, **TOL, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("vid", sorted(VARIANTS))
def test_train_steps_match_jax(vid, gemm_switch):
    variant, kernel = VARIANTS[vid]
    gemm_switch(kernel)
    jnet, params, tx, opt_state, tnet = _flagship_pair(variant)
    opt = tt.make_train_state(tnet)
    images, labels = _batches(3)
    step = jax.jit(jtrain_step(jnet, tx))
    for i in range(3):
        params, opt_state, jloss = step(params, opt_state, jnp.asarray(images[i]),
                                        jnp.asarray(labels[i]))
        tloss = tt.train_step(tnet, opt, torch.from_numpy(images[i]),
                              torch.from_numpy(labels[i]))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _assert_trees_close(tt.to_flax_params(tnet), params)


def test_train_epoch_matches_stepwise():
    images, labels = _batches(3, seed=1)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    nets = [tt.MnistNet("sparse", hidden=32, device="cpu",
                        generator=torch.Generator().manual_seed(2)) for _ in range(2)]
    opts = [tt.make_train_state(n) for n in nets]
    step_losses = torch.stack([tt.train_step(nets[0], opts[0], x[i], y[i]) for i in range(3)])
    losses = tt.train_epoch(nets[1], opts[1], x, y)
    assert losses.shape == (3,)
    torch.testing.assert_close(losses, step_losses, rtol=0, atol=0)
    for p, q in zip(nets[0].parameters(), nets[1].parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_blocksparse_grads_stay_inside_the_mask():
    net = tt.MnistNet("blocksparse", hidden=64, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    images, labels = _batches(1)
    loss = tt.nll_loss(net(torch.from_numpy(images[0])), torch.from_numpy(labels[0]))
    loss.backward()
    for layer in (net.fc1, net.fc2):
        g = layer.kernel_blocks.grad
        assert torch.count_nonzero(g * (1 - layer.mask)) == 0
        assert torch.count_nonzero(g * layer.mask) > 0
    # so the optimizer keeps the weights inside the pattern, momentum and all
    opt = tt.make_train_state(net)
    opt.step()
    images, labels = _batches(2, seed=1)
    tt.train_epoch(net, opt, torch.from_numpy(images), torch.from_numpy(labels))
    for layer in (net.fc1, net.fc2):
        assert torch.count_nonzero(layer.kernel_blocks * (1 - layer.mask)) == 0


@pytest.mark.parametrize("variant", ["xla", "dense", "sparse", "blocksparse"])
def test_mnist_training_loss_drops(variant):
    net = tt.MnistNet(variant, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = tt.make_train_state(net)
    tx, ty, _, _ = tdata.synthetic_mnist(n_train=512, n_test=64)
    losses = [
        float(tt.train_step(net, opt, torch.from_numpy(x), torch.from_numpy(y)))
        for x, y in tdata.batches(tx, ty, 32, seed=0)
    ]
    assert losses[-1] < losses[0] * 0.8, losses


def test_cpu_train_step_launches_no_kernel():
    from tpusparse_torch import kernels

    images, labels = _batches(1)
    for variant in ("sparse", "blocksparse", "dense"):
        net = tt.MnistNet(variant, hidden=16, device="cpu")
        kernels.reset_launch_counts()
        tt.train_step(net, tt.make_train_state(net), torch.from_numpy(images[0]),
                      torch.from_numpy(labels[0]))
        assert kernels.launches_by_kernel() == {
            "block_ell_spmm": 0, "spmm_int8": 0, "sddmm": 0, "gemm": 0, "gemm_s8": 0,
            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_q8": 0,
            "blk_flash_fwd": 0, "blk_flash_dq": 0, "blk_flash_dkv": 0, "naive_spmm": 0,
            "resident_spmm_batched": 0, "compact_spmm": 0, "grouped_spmm": 0,
            "footprint_spmm": 0, "windowed_gather": 0, "windowed_segsum": 0, "dia_spmv": 0,
            "dia_nonfinite": 0, "int8_kmajor": 0}


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_and_batches_equal_jax(seed):
    want = jdata.synthetic_mnist(seed=seed, n_train=100, n_test=20)
    got = tdata.synthetic_mnist(seed=seed, n_train=100, n_test=20)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for drop_last in (True, False):
        jb = list(jdata.batches(want[0], want[1], 32, seed=seed, drop_last=drop_last))
        tb = list(tdata.batches(got[0], got[1], 32, seed=seed, drop_last=drop_last))
        assert len(tb) == len(jb) == (3 if drop_last else 4)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def _write_idx(path, arr):
    dims = arr.shape
    header = np.array([0x0800 | len(dims), *dims], dtype=">u4").tobytes()
    path.write_bytes(header + arr.astype(np.uint8).tobytes())


def test_load_mnist_reads_idx_files_like_jax(tmp_path):
    rng = np.random.default_rng(0)
    for name, shape in (("train-images-idx3-ubyte", (6, 28, 28)),
                        ("train-labels-idx1-ubyte", (6,)),
                        ("t10k-images-idx3-ubyte", (4, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (4,))):
        _write_idx(tmp_path / name, rng.integers(0, 256 if len(shape) > 1 else 10, shape))
    got = tdata.load_mnist(str(tmp_path))
    want = jdata.load_mnist(str(tmp_path))
    assert got[0].shape == (6, 784) and got[3].shape == (4,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_load_mnist_without_files_is_synthetic(tmp_path):
    got = tdata.load_mnist(str(tmp_path))
    for g, w in zip(got, tdata.synthetic_mnist()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("variant", ["xla", "dense", "sparse", "blocksparse"])
def test_to_flax_params_inverts_load_flax_params(variant):
    net = tt.MnistNet(variant, hidden=16, device="cpu", generator=torch.Generator().manual_seed(1))
    tree = tt.to_flax_params(net)
    assert sorted(tree["params"]) == ["fc1", "fc2"]
    other = tt.MnistNet(variant, hidden=16, device="cpu", generator=torch.Generator().manual_seed(2))
    tt.load_flax_params(other, tree)
    for p, q in zip(net.parameters(), other.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    if variant == "xla":  # flax Dense keeps its kernel (in, out)
        assert tree["params"]["fc1"]["kernel"].shape == (784, 16)
