"""Parity of the port's dp×tp sparse-MLP step and node-sharded GCN
(tpusparse_torch.parallel.train and .gcn) with the JAX package's.

The port runs as 4 processes on a gloo group (`torch_parallel_worker.py`
'train', launched once for the module) from weights carried out of JAX:
the sharded MLP state (`convert.load_sharded_train_state`) on a (2, 2)
mesh and the GCNs' flax parameters (`convert.load_flax_params`) on a
4-rank 'model' axis. The JAX side runs the same steps on 4 of the 8 CPU
devices, Pallas in interpret mode. The world-size-1 cases run the port in
this process, the form the card runs, against the single-card algebra.

Tolerances: the fp32 tier (rtol 1e-4, atol 5e-5) for the steps' losses and
parameters; the GCN forward at JAX's test bound (rtol 2e-4, atol 2e-5); the
mask exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.parallel as jpar
from tpusparse.models import gcn as jgcn
from tpusparse.parallel import gcn as jpgcn
from tpusparse.parallel import train as jtrain

import tpusparse_torch as tt
from tpusparse_torch import parallel as tpar
from tpusparse_torch.convert import load_flax_params, to_flax_params
from tpusparse_torch.models import gcn as tgcn

import torch_parallel_worker as W

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
GCN_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_parallel.py's bound


def _jax_mlp():
    """JAX's sharded MLP state on a (2, 2) mesh of CPU devices."""
    cfg = jtrain.ShardedMLPConfig(**W.MLP)
    mesh = jpar.make_mesh(W.MLP_MESH, devices=jax.devices()[:4])
    params, rsp, mask, tx, opt_state = jtrain.make_sharded_train_state(
        cfg, mesh, jax.random.PRNGKey(0))
    return cfg, mesh, params, rsp, mask, tx, opt_state


def _jax_gcn(hidden, classes, seed, a_hat, x):
    model = jgcn.GCN(hidden=hidden, num_classes=classes)
    return model, model.init(jax.random.PRNGKey(seed), a_hat, x)


def _jax_a_hat(adj):
    import tpusparse as ts

    return jgcn.normalized_adjacency(ts.CSR.from_scipy(adj.to_scipy()))


@pytest.fixture(scope="module")
def jax_state():
    _, _, params, _, mask, _, opt_state = _jax_mlp()
    inputs = {f"mlp_{k}": np.asarray(v) for k, v in params.items()}
    inputs.update({f"mlp_trace_{k}": np.asarray(v) for k, v in opt_state[0].trace.items()})
    inputs["mlp_mask"] = np.asarray(mask)
    adj, x = W.gcn_inputs()
    _, gparams = _jax_gcn((16,), 4, 0, _jax_a_hat(adj), jnp.asarray(x))
    inputs.update(W.flat_tree(gparams["params"], "gcn_"))
    a, x, _, _ = W.gcn_train_inputs()
    _, gparams = _jax_gcn((8,), 2, 1, _jax_a_hat(a), jnp.asarray(x))
    inputs.update(W.flat_tree(gparams["params"], "gcntrain_"))
    return inputs


@pytest.fixture(scope="module")
def ranks(jax_state, tmp_path_factory):
    """Rank 0's results of the 'train' group on 4 gloo ranks."""
    return W.launch("train", tmp_path_factory.mktemp("torch_parallel_train"), jax_state)


@pytest.fixture(scope="module")
def ws1():
    tpar.initialize_distributed(device="cpu")
    return tpar.make_mesh(device="cpu"), tpar.make_mesh((1,), ("model",), device="cpu")


# -- the dp×tp sparse-MLP step -------------------------------------------------------


def test_three_steps_from_jax_weights_match_jax(ranks):
    cfg, mesh, params, rsp, mask, tx, opt_state = _jax_mlp()
    step = jtrain.make_sharded_train_step(cfg, mesh, rsp, tx)
    losses = []
    for x, y in W.mnist_like(0, W.PARITY_STEPS):
        params, opt_state, loss = step(params, opt_state, mask, jnp.asarray(x),
                                       jnp.asarray(y.astype(np.int32)))
        losses.append(float(loss))
    np.testing.assert_allclose(ranks["mlp_losses"][:W.PARITY_STEPS], losses, **TOL)
    np.testing.assert_allclose(ranks["mlp_w1_after"], np.asarray(params["w1_blocks"]), **TOL)
    for k in ("b1", "w2", "b2"):
        np.testing.assert_allclose(ranks[f"mlp_{k}_after"], np.asarray(params[k]), **TOL)


def test_mask_is_preserved_and_loss_drops(ranks):
    np.testing.assert_array_equal(ranks["mlp_mask"], np.asarray(_jax_mlp()[4]))
    np.testing.assert_array_equal(ranks["mlp_w1_final"] * (1 - ranks["mlp_mask"]), 0.0)
    losses = ranks["mlp_losses"]
    assert losses.shape == (W.TRAIN_STEPS,) and np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses


def test_world_size_1_step_is_the_plain_sgd_step(ws1):
    """At one rank JAX's gradient factors are 1: each step equals SGD with
    momentum on the masked dense weight, by torch autograd."""
    mesh, _ = ws1
    cfg = tpar.ShardedMLPConfig(**W.MLP)
    params, rsp, mask, opt = tpar.make_sharded_train_state(
        cfg, mesh, torch.Generator().manual_seed(3))
    plan = rsp.local_plan(0)
    assert params["w1_blocks"].shape == mask.shape == (plan.num_slots, 8, 16)
    ref = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    ref_opt = torch.optim.SGD(list(ref.values()), lr=cfg.learning_rate, momentum=cfg.momentum)
    step = tpar.make_sharded_train_step(cfg, mesh, rsp)
    for x, y in W.mnist_like(1, 4):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        got = step(params, opt, mask, x, y)
        ref_opt.zero_grad()
        w1 = plan.blocks_to_dense(ref["w1_blocks"] * mask)[:cfg.hidden]
        h = torch.relu(w1 @ x.T + ref["b1"][:, None])
        logp = torch.log_softmax(ref["w2"] @ h + ref["b2"][:, None], dim=0)
        loss = -logp.gather(0, y[None, :]).sum() / x.shape[0]
        loss.backward()
        ref_opt.step()
        torch.testing.assert_close(got, loss.detach(), **TOL)
    for k in params:
        torch.testing.assert_close(params[k].detach(), ref[k].detach(), **TOL)
    assert torch.equal(params["w1_blocks"].detach() * (1 - mask),
                       torch.zeros_like(mask))


def test_carried_state_lands_where_asked():
    _, _, params, _, mask, _, opt_state = _jax_mlp()
    cfg = tpar.ShardedMLPConfig(**W.MLP)
    trace = {k: np.asarray(v) + 1.0 for k, v in opt_state[0].trace.items()}
    got, got_mask, opt = tt.convert.load_sharded_train_state(
        cfg, {k: np.asarray(v) for k, v in params.items()}, np.asarray(mask), trace,
        model_rank=1, device="cpu")
    np.testing.assert_array_equal(got["w1_blocks"].detach().numpy(),
                                  np.asarray(params["w1_blocks"])[1])
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask)[1])
    np.testing.assert_array_equal(opt.state[got["w2"]]["momentum_buffer"].numpy(),
                                  trace["w2"])
    assert all(p.requires_grad and p.device.type == "cpu" for p in got.values())


# -- the node-sharded GCN ---------------------------------------------------------------


def test_sharded_gcn_forward_matches_jax(ranks, jax_state):
    adj, x = W.gcn_inputs()
    a_hat = _jax_a_hat(adj)
    model, params = _jax_gcn((16,), 4, 0, a_hat, jnp.asarray(x))
    mesh = jpar.make_mesh((4,), ("model",), devices=jax.devices()[:4])
    rsp = jpar.shard_plan_rows(a_hat, 4, blocksize=(8, 8))
    want = jpgcn.make_sharded_gcn_forward(model, rsp, mesh)(
        params, rsp.pack_values(a_hat.data), jnp.asarray(x))
    np.testing.assert_allclose(ranks["gcn_forward"], np.asarray(want), **GCN_TOL)
    np.testing.assert_allclose(ranks["gcn_forward"], np.asarray(model.apply(params, a_hat,
                                                                             jnp.asarray(x))),
                               **GCN_TOL)


def test_sharded_gcn_steps_match_jax(ranks):
    import optax

    a, x, labels, mask = W.gcn_train_inputs()
    a_hat = _jax_a_hat(a)
    model, params = _jax_gcn((8,), 2, 1, a_hat, jnp.asarray(x))
    tx = optax.adam(1e-2)
    mesh = jpar.make_mesh((4,), ("model",), devices=jax.devices()[:4])
    rsp = jpar.shard_plan_rows(a_hat, 4, blocksize=(8, 8))
    step = jax.jit(jpgcn.make_sharded_gcn_train_step(model, rsp, mesh, tx))
    blocks, opt_state, losses = rsp.pack_values(a_hat.data), tx.init(params), []
    for _ in range(W.GCN_STEPS):
        params, opt_state, loss = step(params, opt_state, blocks, jnp.asarray(x),
                                       jnp.asarray(labels.astype(np.int32)), jnp.asarray(mask))
        losses.append(float(loss))
    np.testing.assert_allclose(ranks["gcn_losses"], losses, **TOL)
    assert ranks["gcn_losses"][-1] < ranks["gcn_losses"][0]


def test_world_size_1_gcn_is_the_single_card_gcn(ws1):
    """At one rank the sharded forward and Adam steps equal `GCN` and
    `models.gcn.train_step` on the same weights; the loss drops over 20
    steps."""
    _, mesh = ws1
    a, x, labels, mask = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                          for t in W.gcn_train_inputs())
    a_hat = tt.normalized_adjacency(a)
    model = tt.GCN(8, hidden=(8,), num_classes=2, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    twin = tt.GCN(8, hidden=(8,), num_classes=2, device="cpu")
    load_flax_params(twin, to_flax_params(model))
    rsp = tpar.shard_plan_rows(a_hat, 1, (8, 8))
    blocks = rsp.pack_values(a_hat.data)
    fwd = tpar.make_sharded_gcn_forward(model, rsp, mesh)
    with torch.no_grad():
        torch.testing.assert_close(fwd(model, blocks, x), twin(a_hat, x), **TOL)
    step = tpar.make_sharded_gcn_train_step(model, rsp, mesh)
    opt, twin_opt = tgcn.make_train_state(model), tgcn.make_train_state(twin)
    losses = []
    for i in range(20):
        losses.append(float(step(model, opt, blocks, x, labels, mask)))
        want = float(tgcn.train_step(twin, twin_opt, a_hat, x, labels, mask))
        if i < 3:
            np.testing.assert_allclose(losses[-1], want, **TOL)
    assert losses[-1] < losses[0], losses
