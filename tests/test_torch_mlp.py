"""Parity of the port's MNIST MLP forward, layers and dense matmul with the
JAX package: flax parameters are carried over with load_flax_params and the
same inputs go through both models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.dense as jdense
from tpusparse.models.mlp import MnistNet as JMnistNet
from tpusparse.models.mlp import nll_loss as jnll_loss

import tpusparse_torch.dense as tdense
from tpusparse_torch import get_config, load_flax_params, set_config
from tpusparse_torch.models import MnistNet, nll_loss

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
VARIANTS = ["xla", "dense", "sparse", "blocksparse"]


def _flagship(variant):
    """Full-width flagship (784 -> 256 -> 10, batch 32) in both packages,
    with the flax parameters carried into the port."""
    x = np.random.default_rng(0).standard_normal((32, 784)).astype(np.float32)
    jnet = JMnistNet(variant=variant, hidden=256)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    tnet = MnistNet(variant, hidden=256, device="cpu")
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    return x, want, tnet, params


@pytest.mark.parametrize("variant", VARIANTS)
def test_mnist_forward_matches_flax(variant):
    x, want, tnet, _ = _flagship(variant)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (32, 10)
    np.testing.assert_allclose(got, want, **TOL)
    labels = np.random.default_rng(1).integers(0, 10, 32)
    np.testing.assert_allclose(
        float(nll_loss(torch.from_numpy(got), torch.from_numpy(labels))),
        float(jnll_loss(jnp.asarray(want), jnp.asarray(labels))),
        **TOL,
    )


def test_sparse_patterns_match_jax_model():
    _, _, tnet, params = _flagship("sparse")
    p = params["params"]
    assert tnet.fc1.kernel_values.shape == p["fc1"]["kernel_values"].shape
    assert tnet.fc2.pattern.shape == (10, 256)


def test_seeded_generator_gives_same_weights_on_every_build():
    a = MnistNet("blocksparse", hidden=16, device="cpu", generator=torch.Generator().manual_seed(5))
    b = MnistNet("blocksparse", hidden=16, device="cpu", generator=torch.Generator().manual_seed(5))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    bound = 1.0 / np.sqrt(784)
    vals = a.fc1.kernel_blocks[a.fc1.mask.bool()]
    assert vals.abs().max() <= bound and vals.numel() == a.fc1.pattern.nnz


def test_sparse_model_gradients_match_jax():
    """The sparse model's backward runs on the SDDMM and transpose-plan
    kernels (here their plain versions), and its gradients match jax.grad."""
    x, _, tnet, params = _flagship("sparse")
    labels = np.random.default_rng(1).integers(0, 10, 32)
    jnet = JMnistNet(variant="sparse", hidden=256)
    want = jax.grad(
        lambda p: jnll_loss(jnet.apply(p, jnp.asarray(x)), jnp.asarray(labels))
    )(params)["params"]
    nll_loss(tnet(torch.from_numpy(x)), torch.from_numpy(labels)).backward()
    for lname in ("fc1", "fc2"):
        layer = getattr(tnet, lname)
        for leaf, p in (("kernel_values", layer.kernel_values), ("bias", layer.bias)):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[lname][leaf]), **TOL)


@pytest.mark.parametrize("transa,transb", [(False, False), (True, False), (False, True), (True, True)])
def test_dense_matmul_matches_jax(transa, transb):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((24, 40) if not transa else (40, 24)).astype(np.float32)
    b = rng.standard_normal((40, 12) if not transb else (12, 40)).astype(np.float32)
    want = np.asarray(jdense.matmul(jnp.asarray(a), jnp.asarray(b), transa=transa, transb=transb))
    got = tdense.matmul(torch.from_numpy(a), torch.from_numpy(b), transa=transa, transb=transb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_default_tier_rounds_operands_to_bf16():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 40)).astype(np.float32)
    b = rng.standard_normal((40, 8)).astype(np.float32)

    def rnd(x):
        return torch.from_numpy(x).to(torch.bfloat16).double().numpy()

    set_config(precision="default")
    try:
        got = tdense.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    finally:
        set_config(precision="high")
    np.testing.assert_allclose(got, rnd(a) @ rnd(b), **TOL)
    assert not np.allclose(got, a.astype(np.float64) @ b, rtol=1e-6, atol=0)


def test_set_config_validates():
    with pytest.raises(ValueError, match="precision"):
        set_config(precision="tf32")
    with pytest.raises(AttributeError, match="interpret"):
        set_config(interpret=True)
    assert get_config().precision == "high"


def test_dense_matmul_rejects_other_ranks():
    # every rank is taken now (tests/test_torch_gemm.py holds them against
    # JAX); what is refused is a transpose flag on a 1-D operand, and bmm of
    # operands below 3-D or with unequal batch dims
    with pytest.raises(ValueError, match="transa requires"):
        tdense.matmul(torch.zeros(4), torch.zeros(4, 5), transa=True)
    with pytest.raises(ValueError, match="transb requires"):
        tdense.matmul(torch.zeros(3, 4), torch.zeros(4), transb=True)
    with pytest.raises(ValueError, match="≥3-D"):
        tdense.bmm(torch.zeros(2, 3, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="batch dims"):
        tdense.bmm(torch.zeros(2, 3, 4), torch.zeros(3, 4, 5))
    assert tdense.matmul(torch.zeros(2, 3, 4), torch.zeros(4, 5)).shape == (2, 3, 5)


def test_load_flax_params_rejects_mismatches():
    net = MnistNet("sparse", hidden=256, device="cpu")
    _, _, _, params = _flagship("sparse")
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    missing = {"params": {"fc1": tree["fc1"]}}
    with pytest.raises(KeyError, match="layer mismatch"):
        load_flax_params(net, missing)
    extra = {"params": {**tree, "fc2": {**tree["fc2"], "scale": np.ones(10)}}}
    with pytest.raises(KeyError, match="fc2"):
        load_flax_params(net, extra)
    bad = {"params": {**tree, "fc2": {**tree["fc2"], "bias": np.ones(11, np.float32)}}}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(net, bad)
    with pytest.raises(KeyError, match="params"):
        load_flax_params(net, tree)
