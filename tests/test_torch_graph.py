"""Parity of the port's graph models and their helpers (tpusparse_torch.
models.gcn / gat / appnp, elementwise.sp_add / row_softmax, linalg.speye)
with the JAX package: the same numpy inputs go through both, flax parameters
are carried into the port's modules, and the JAX side runs the naive Pallas
kernel in interpret mode at small sizes (its 'reference' route at full
width, which computes the same sum), the port its plain PyTorch versions.

Tolerances:
  - the generators' and the pattern helpers' arrays are equal; values that
    both sides compute in fp32 in another order are held at the fp32 tier
    (rtol 1e-4, atol 5e-5);
  - gradients: the fp32 tier against the largest gradient (atol 2e-4 of it,
    tests/test_torch_bert.py's bound), rtol 1e-3;
  - Adam: optax's `adam` and `torch.optim.Adam` compute the same update
    m̂ / (√v̂ + eps) but round otherwise, and on the first steps the update
    is about lr·sign(g), so a gradient element near 0 whose sign differs
    between the packages moves its parameter by up to 2·lr. The losses of 3
    steps are held at the fp32 tier; the parameters after 3 steps at atol
    1e-5 + 1e-3·lr, except the elements whose JAX first-step gradient is
    under 1e-3 of the largest (their Adam direction is rounding-sensitive),
    which are held at 6·lr, the most three such steps can move them apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusparse.elementwise import row_softmax as j_row_softmax
from tpusparse.elementwise import sp_add as j_sp_add
from tpusparse.linalg import speye as j_speye
from tpusparse.models import appnp as jappnp
from tpusparse.models import gat as jgat
from tpusparse.models import gcn as jgcn
from tpusparse.types import CSR as JCSR

import tpusparse_torch as tt
from tpusparse_torch import kernels
from tpusparse_torch.models import gat as tgat
from tpusparse_torch.models import gcn as tgcn

TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_TOL = 2e-4
STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(val, name) if isinstance(val, dict) else {name: np.asarray(val)})
    return out


def _jcsr(t):
    return JCSR(jnp.asarray(t.data.numpy()), t.indices, t.indptr, t.shape)


def _assert_csr_equal(t, j, exact=True):
    np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
    np.testing.assert_array_equal(t.indptr, np.asarray(j.indptr))
    if exact:
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    else:
        np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), **TOL)


# -- generators and pattern helpers ----------------------------------------------------


@pytest.mark.parametrize("seed,n,deg", [(0, 48, 6.0), (3, 100, 3.9), (7, 31, 2.0)])
def test_random_graph_equals_jax(seed, n, deg):
    t = tt.random_graph(seed, n, avg_degree=deg, device="cpu")
    _assert_csr_equal(t, jgcn.random_graph(seed, n, avg_degree=deg))
    assert t.data.dtype == torch.float32


def test_two_cluster_graph_equals_jax():
    t, tl = tt.two_cluster_graph(4, 20, device="cpu")
    j, jl = jgcn.two_cluster_graph(4, 20)
    _assert_csr_equal(t, j)
    np.testing.assert_array_equal(tl, jl)


def test_speye_sp_add_and_self_loops_equal_jax():
    adj = tt.random_graph(1, 40, 5.0, device="cpu")
    eye = tt.speye(40, device="cpu")
    _assert_csr_equal(eye, j_speye(40))
    _assert_csr_equal(tt.sp_add(adj, eye, alpha=2.0, beta=-0.5),
                      j_sp_add(_jcsr(adj), j_speye(40), alpha=2.0, beta=-0.5))
    _assert_csr_equal(tt.add_self_loops(adj), jgat.add_self_loops(_jcsr(adj)))


def test_sp_add_is_differentiable_in_both():
    a = tt.random_graph(2, 30, 4.0, device="cpu")
    b = tt.random_graph(3, 30, 4.0, device="cpu")
    da = a.data.clone().requires_grad_(True)
    db = b.data.clone().requires_grad_(True)
    w = torch.arange(1.0, 1.0 + tt.sp_add(a, b).nnz)
    (tt.sp_add(tt.CSR(da, a.indices, a.indptr, a.shape),
               tt.CSR(db, b.indices, b.indptr, b.shape), 3.0, -2.0).data * w).sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(j_sp_add(
        JCSR(x, a.indices, a.indptr, a.shape), JCSR(y, b.indices, b.indptr, b.shape),
        3.0, -2.0).data * jnp.asarray(w.numpy())), argnums=(0, 1))(
        jnp.asarray(a.data.numpy()), jnp.asarray(b.data.numpy()))
    np.testing.assert_allclose(da.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(db.grad.numpy(), np.asarray(gb), **TOL)


@pytest.mark.parametrize("self_loops", [True, False])
def test_normalized_adjacency_matches_jax(self_loops):
    adj = tt.random_graph(5, 64, 6.0, device="cpu")
    got = tt.normalized_adjacency(adj, add_self_loops=self_loops)
    want = jgcn.normalized_adjacency(_jcsr(adj), add_self_loops=self_loops)
    _assert_csr_equal(got, want, exact=False)


def test_row_softmax_and_its_gradient_match_jax():
    rng = np.random.default_rng(6)
    d = (rng.random((25, 30)) < 0.2) * rng.standard_normal((25, 30)) * 3
    d[[4, 17]] = 0.0  # empty rows stay empty
    t = tt.CSR.from_dense(d.astype(np.float32), device="cpu")
    j = _jcsr(t)
    w = rng.standard_normal(t.nnz).astype(np.float32)
    got = tt.row_softmax(t, temperature=0.7)
    _assert_csr_equal(got, j_row_softmax(j, temperature=0.7), exact=False)
    data = t.data.clone().requires_grad_(True)
    (tt.row_softmax(tt.CSR(data, t.indices, t.indptr, t.shape), 0.7).data
     * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(j_row_softmax(
        JCSR(x, j.indices, j.indptr, j.shape), 0.7).data * jnp.asarray(w)))(j.data)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(want), **TOL)


# -- the models, carried from flax -------------------------------------------------


def _task(seed, n, f, classes):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    mask = (rng.random(n) < 0.4).astype(np.float32)
    return x, labels, mask


def _models(family, adj, f, method):
    """(flax module, port module, JAX graph, port graph, Adam learning
    rate) of one model family at the test's small widths."""
    if family == "gcn":
        a_t = tt.normalized_adjacency(adj)
        jm = jgcn.GCN(hidden=(16,), num_classes=4, spmm_method=method)
        tm = tt.GCN(f, hidden=(16,), num_classes=4, spmm_method=method, device="cpu")
        lr = 1e-2
    elif family == "gat":
        a_t = tt.add_self_loops(adj)
        jm = jgat.GAT(hidden=(6,), num_heads=3, num_classes=4, spmm_method=method)
        tm = tt.GAT(f, hidden=(6,), num_heads=3, num_classes=4, spmm_method=method,
                    device="cpu")
        lr = 5e-3
    else:
        a_t = tt.normalized_adjacency(adj)
        jm = jappnp.APPNP(hidden=(16,), num_classes=4, alpha=0.1, k=5)
        tm = tt.APPNP(f, hidden=(16,), num_classes=4, alpha=0.1, k=5, device="cpu")
        lr = 1e-2
    return jm, tm, _jcsr(a_t), a_t, lr


def _jax_steps(jm, params, a_j, x, labels, mask, lr, steps):
    tx = optax.adam(lr)
    step = jgcn.train_step(jm, tx)
    opt_state = tx.init(params)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, a_j, x, labels, mask)
        losses.append(float(loss))
    return params, losses


CARRIED = [("gcn", "naive"), ("gcn", "tiled"), ("gat", "naive"), ("gat", "tiled"),
           ("appnp", None)]


@pytest.mark.parametrize("family,method", CARRIED)
def test_carried_model_forward_grads_and_adam_steps_match_jax(family, method):
    adj = tt.random_graph(11, 40, avg_degree=4.0, device="cpu")
    x, labels, mask = _task(12, 40, 10, 4)
    jm, tm, a_j, a_t, lr = _models(family, adj, 10, method)
    jx, jl, jmask = jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask)
    # JAX's 'reference' route where the kernel is not under test (the init,
    # the Adam steps): it sums as the naive kernel does, and keeps the
    # interpret-mode kernel to the one forward and gradient checked below
    jref = jm.clone(spmm_method="reference") if method == "naive" else jm
    params = jref.init(jax.random.PRNGKey(3), a_j, jx)
    tt.load_flax_params(tm, _np_tree(params))
    tx, tl, tmask = torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask)

    def loss_fn(p):
        logp = jm.apply(p, a_j, jx)
        nll = -jnp.take_along_axis(logp, jl[:, None], axis=1)[:, 0]
        return (nll * jmask).sum() / jnp.maximum(jmask.sum(), 1), logp

    # the forward and the first step's gradients
    (_, jlogp), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    np.testing.assert_allclose(tm(a_t, tx).detach().numpy(), np.asarray(jlogp), **TOL)
    jgrads = _flat(_np_tree(jgrads)["params"])
    tgcn.masked_nll(tm(a_t, tx), tl, tmask).backward()
    tgrads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(tgrads) == set(jgrads)
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-3, atol=GRAD_TOL * scale,
                                   err_msg=name)

    # STEPS Adam steps from the same parameters
    tt.load_flax_params(tm, _np_tree(params))
    opt = (tgat if family == "gat" else tgcn).make_train_state(tm, learning_rate=lr)
    t_losses = [float(tgcn.train_step(tm, opt, a_t, tx, tl, tmask)) for _ in range(STEPS)]
    jparams, j_losses = _jax_steps(jref, params, a_j, jx, jl, jmask, lr, STEPS)
    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    want = _flat(_np_tree(jparams)["params"])
    for name, p in tm.named_parameters():
        got, sensitive = p.detach().numpy(), np.abs(jgrads[name]) < 1e-3 * scale
        np.testing.assert_allclose(got[~sensitive], want[name][~sensitive], rtol=0,
                                   atol=1e-5 + 1e-3 * lr, err_msg=name)
        np.testing.assert_allclose(got[sensitive], want[name][sensitive], rtol=0,
                                   atol=2 * STEPS * lr, err_msg=name)


def test_tree_keys_are_flax_names_and_a_missing_key_raises():
    adj = tt.random_graph(13, 20, 3.0, device="cpu")
    jm, tm, a_j, _, _ = _models("gat", adj, 6, "naive")
    params = _np_tree(jm.init(jax.random.PRNGKey(0), a_j, jnp.zeros((20, 6))))
    assert set(params["params"]["gat1"]) == {"DenseLinear_0", "att_src", "att_dst", "bias"}
    assert set(tt.to_flax_params(tm)["params"]["gat1"]) == set(params["params"]["gat1"])
    del params["params"]["head"]["att_dst"]
    with pytest.raises(KeyError, match="head"):
        tt.load_flax_params(tm, params)


def test_appnp_propagation_matches_jax():
    adj = tt.normalized_adjacency(tt.random_graph(14, 30, 4.0, device="cpu"))
    h = np.random.default_rng(15).standard_normal((30, 3)).astype(np.float32)
    got = tt.appnp_propagate(adj, torch.from_numpy(h), alpha=0.2, k=4)
    want = jappnp.appnp_propagate(_jcsr(adj), jnp.asarray(h), alpha=0.2, k=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gcn_step_launches_nothing_on_the_cpu():
    adj = tt.normalized_adjacency(tt.random_graph(16, 30, 4.0, device="cpu"))
    x, labels, mask = _task(17, 30, 5, 3)
    model = tt.GCN(5, hidden=(8,), num_classes=3, spmm_method="naive", device="cpu")
    kernels.reset_launch_counts()
    tgcn.train_step(model, tgcn.make_train_state(model), adj, torch.from_numpy(x),
                    torch.from_numpy(labels), torch.from_numpy(mask))
    assert not any(kernels.launches_by_kernel().values())


def test_full_width_gcn_forward_at_the_cora_shape():
    """Cora's published sizes (2708 nodes, 1433 features, 7 classes; Kipf &
    Welling 2017, Table 1) on a generated graph of its mean degree, the
    flax GCN with JAX's 'reference' route against the port's naive route."""
    adj = tt.random_graph(0, 2708, avg_degree=3.9, device="cpu")
    a_t = tt.normalized_adjacency(adj)
    a_j = _jcsr(a_t)
    x = (np.random.default_rng(1).random((2708, 1433)) < 0.0127).astype(np.float32)
    jm = jgcn.GCN(hidden=(64,), num_classes=7, spmm_method="reference")
    params = jm.init(jax.random.PRNGKey(0), a_j, jnp.asarray(x))
    tm = tt.GCN(1433, hidden=(64,), num_classes=7, spmm_method="naive", device="cpu")
    tt.load_flax_params(tm, _np_tree(params))
    got = tm(a_t, torch.from_numpy(x))
    assert got.shape == (2708, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(params, a_j, x)),
                               **TOL)
