"""The port's RigL (tpusparse_torch.nn.rigl) against the JAX package's:
tests/test_rigl.py's cases on dicts of tensors, each then held against JAX
on the same numpy inputs.

Tolerances: `rigl_update`, `harvest_csr` and the schedule exactly; the
end-to-end run's losses before the first update within the fp32 tier
(rtol 1e-4, atol 5e-5), its first update's mask equal to JAX's given JAX's
state at that step, and JAX's own criteria on the port's whole run."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpusparse as ts
import tpusparse_torch as tt
from tpusparse.nn import rigl as jr
from tpusparse_torch.nn import rigl as tr

TOL = dict(rtol=1e-4, atol=5e-5)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _same_update(mask, w, g, df):
    """The port's update, equal to JAX's on the same arrays; returned."""
    got = tr.rigl_update(_t(mask), _t(w), _t(g), df).numpy()
    want = np.asarray(jr.rigl_update(jnp.asarray(mask), jnp.asarray(w), jnp.asarray(g), df))
    np.testing.assert_array_equal(got, want)
    return got


def test_random_mask_exact_nnz():
    for density in (0.05, 0.3, 0.9):
        m = tr.random_mask(_gen(0), (37, 53), density, device="cpu")
        assert int(m.sum()) == round(density * 37 * 53)
        assert set(np.unique(m.numpy())) <= {0.0, 1.0}
        jm = jr.random_mask(jax.random.PRNGKey(0), (37, 53), density)
        assert int(m.sum()) == int(np.asarray(jm).sum())
    assert not torch.equal(tr.random_mask(_gen(1), (37, 53), 0.3, device="cpu"),
                           tr.random_mask(_gen(2), (37, 53), 0.3, device="cpu"))


def test_rigl_update_preserves_nnz_and_selects_correctly():
    mask = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    w = np.array([5.0, 0.1, 4.0, 0.2, 0, 0, 0, 0], np.float32)
    g = np.array([0.0, 0, 0, 0, 9.0, 1.0, 8.0, 2.0], np.float32)
    new = _same_update(mask, w, g, 0.5)
    assert int(new.sum()) == 4
    np.testing.assert_array_equal(new, [1, 0, 1, 0, 1, 0, 1, 0])


def test_rigl_update_nnz_constant_under_ties_and_extremes():
    rng = np.random.default_rng(0)
    mask = tr.random_mask(_gen(1), (64, 64), 0.1, device="cpu").numpy()
    nnz = int(mask.sum())
    w = np.round(rng.normal(size=(64, 64)), 1).astype(np.float32)
    g = np.round(rng.normal(size=(64, 64)), 1).astype(np.float32)  # heavy ties
    for df in (0.1, 0.3, 0.999):
        assert int(_same_update(mask, w * mask, g, df).sum()) == nnz, df


def test_rigl_update_records_no_graph():
    """The update is a selection: it takes weights and gradients that
    require grad and returns a plain mask of the input's dtype (JAX's
    counterpart refuses a traced mask; eager PyTorch has none)."""
    mask = tr.random_mask(_gen(2), (8, 8), 0.5, device="cpu")
    w = torch.randn(8, 8, requires_grad=True)
    new = tr.rigl_update(mask, w * mask, w, 0.3)
    assert new.grad_fn is None and new.dtype == mask.dtype
    assert int(new.sum()) == int(mask.sum())


def test_cosine_schedule_endpoints():
    assert tr.cosine_drop_fraction(0, 100, alpha=0.3) == pytest.approx(0.3)
    assert tr.cosine_drop_fraction(100, 100, alpha=0.3) == pytest.approx(0.0)
    assert tr.cosine_drop_fraction(200, 100, alpha=0.3) == pytest.approx(0.0)
    mid = tr.cosine_drop_fraction(50, 100, alpha=0.3)
    assert 0.0 < mid < 0.3
    for t in (0, 17, 50, 99, 100, 250):
        assert tr.cosine_drop_fraction(t, 100) == jr.cosine_drop_fraction(t, 100)


def test_mask_tree_roundtrip_and_sparsity():
    params = {"dense.kernel": torch.ones(16, 8), "dense.bias": torch.ones(8),
              "head.kernel": torch.ones(8, 4)}
    masks = tr.init_masks(params, 0.25, _gen(0))
    assert masks["dense.bias"] is None
    assert tr.sparsity_of(masks) == pytest.approx(0.75, abs=0.02)
    masked = tr.apply_masks(params, masks)
    assert torch.equal(masked["dense.kernel"], masks["dense.kernel"])
    assert torch.equal(masked["dense.bias"], torch.ones(8))
    g = tr.mask_grads(params, masks)
    assert torch.equal(g["head.kernel"], masks["head.kernel"])
    jmasks = {"dense": {"kernel": jnp.asarray(masks["dense.kernel"].numpy()), "bias": None},
              "head": {"kernel": jnp.asarray(masks["head.kernel"].numpy())}}
    assert tr.sparsity_of(masks) == jr.sparsity_of(jmasks)


def test_harvest_csr_matches_masked_dense():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    mask = tr.random_mask(_gen(4), (24, 40), 0.15, device="cpu")
    a = tr.harvest_csr(torch.from_numpy(w), mask)
    ja = jr.harvest_csr(jnp.asarray(w), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(a.data.numpy(), np.asarray(ja.data))
    np.testing.assert_array_equal(a.indices, np.asarray(ja.indices))
    np.testing.assert_array_equal(a.indptr, np.asarray(ja.indptr))
    assert a.shape == ja.shape and a.data.device.type == "cpu"
    np.testing.assert_allclose(a.to_dense().numpy(), w * mask.numpy(), rtol=1e-6)
    x = rng.normal(size=(40, 7)).astype(np.float32)
    y = tt.spmm(a, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), (w * mask.numpy()) @ x, rtol=1e-4, atol=1e-5)


def _regression_task():
    """test_rigl.py's task: a 30 %-dense true weight, its data, JAX's
    starting weight and masks."""
    rng = np.random.default_rng(5)
    n_in, n_out, nb = 32, 16, 256
    w_true = rng.normal(size=(n_in, n_out)).astype(np.float32)
    w_true *= rng.uniform(size=w_true.shape) < 0.3
    x = rng.normal(size=(nb, n_in)).astype(np.float32)
    y = x @ w_true
    params = {"kernel": jnp.asarray(rng.normal(size=(n_in, n_out)).astype(np.float32) * 0.1)}
    masks = jr.init_masks(params, 0.3, jax.random.PRNGKey(6))
    return w_true, x, y, jr.apply_masks(params, masks), masks


def _jax_first_interval(params, masks, x, y):
    """JAX's steps 0-49 of test_rigl.py's loop: the losses, and the params,
    dense grads and masks that step 49's update reads, with its result."""
    tx = optax.adam(3e-2)
    opt = tx.init(params)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    @jax.jit
    def step(params, opt, masks):
        def loss_fn(p):
            return jnp.mean((xj @ p["kernel"] - yj) ** 2)

        loss, dense_grads = jax.value_and_grad(loss_fn)(params)
        upd, opt2 = tx.update(jr.mask_grads(dense_grads, masks), opt, params)
        return jr.apply_masks(optax.apply_updates(params, upd), masks), opt2, loss, dense_grads

    losses = []
    for _ in range(50):
        params, opt, loss, dg = step(params, opt, masks)
        losses.append(float(loss))
    df = jr.cosine_drop_fraction(49, 300, alpha=0.3)
    return losses, params, dg, masks, jr.rigl_update_tree(masks, params, dg, df)


def test_end_to_end_sparse_training_loss_drops_and_topology_moves():
    """test_rigl.py's run on the port from JAX's start (Adam 3e-2, an
    update every 50 of 300 steps): the losses before the first update
    match JAX's; the first update, given JAX's state there, equals JAX's;
    and the port's whole run meets JAX's criteria (loss under 0.1× the
    first, topology moved, overlap with the true support above 0.45, the
    harvested `spmm` equal to the masked dense product)."""
    w_true, x, y, jparams, jmasks = _regression_task()
    jlosses, jp49, jg49, jm49, jnew = _jax_first_interval(jparams, jmasks, x, y)
    got = tr.rigl_update_tree({"kernel": _t(jm49["kernel"])}, {"kernel": _t(jp49["kernel"])},
                              {"kernel": _t(jg49["kernel"])},
                              tr.cosine_drop_fraction(49, 300, alpha=0.3))
    np.testing.assert_array_equal(got["kernel"].numpy(), np.asarray(jnew["kernel"]))

    n = torch.get_num_threads()
    torch.set_num_threads(1)  # 300 tiny steps: a thread pool only spins
    try:
        w = torch.nn.Parameter(_t(jparams["kernel"]))
        params = {"kernel": w}
        masks = {"kernel": _t(jmasks["kernel"])}
        nnz0 = int(masks["kernel"].sum())
        mask0 = masks["kernel"].clone()
        opt = torch.optim.Adam([w], lr=3e-2, betas=(0.9, 0.999), eps=1e-8)
        xt, yt = _t(x), _t(y)
        losses = []
        for t in range(300):
            opt.zero_grad(set_to_none=True)
            loss = ((xt @ w - yt) ** 2).mean()
            loss.backward()
            dense = {"kernel": w.grad.clone()}
            w.grad = tr.mask_grads(dense, masks)["kernel"]
            opt.step()
            with torch.no_grad():
                w.copy_(tr.apply_masks(params, masks)["kernel"])
            losses.append(float(loss.detach()))
            if t % 50 == 49:
                masks = tr.rigl_update_tree(masks, params, dense,
                                            tr.cosine_drop_fraction(t, 300, alpha=0.3))
                assert int(masks["kernel"].sum()) == nnz0
                with torch.no_grad():
                    w.copy_(tr.apply_masks(params, masks)["kernel"])
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(losses[:50], jlosses, **TOL)
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])
    assert int((masks["kernel"] != mask0).sum()) > 0
    overlap = float((masks["kernel"].numpy() * (w_true != 0)).sum()) / nnz0
    assert overlap > 0.45, overlap
    a = tr.harvest_csr(w.detach().T.contiguous(), masks["kernel"].T.contiguous())
    pred_sparse = tt.spmm(a, xt.T.contiguous()).T
    pred_dense = xt @ (w.detach() * masks["kernel"])
    torch.testing.assert_close(pred_sparse, pred_dense, rtol=1e-4, atol=1e-5)


def test_rigl_ties_never_prune_strictly_stronger_weights():
    mask = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    w = np.array([5.0, 5.0, 5.0, 9.0, 0, 0, 0, 0], np.float32)
    g = np.array([0.0, 0, 0, 0, 1.0, 1.0, 1.0, 2.0], np.float32)
    new = _same_update(mask, w, g, 0.5)
    assert int(new.sum()) == 4
    assert new[3] == 1 and new[7] == 1
    assert new[:3].sum() == 1


def test_harvest_csr_keeps_the_weight_dtype():
    a = tr.harvest_csr(torch.randn(6, 5, dtype=torch.float64), torch.ones(6, 5))
    assert a.data.dtype == torch.float64 and a.nnz == 30
    ja = ts.CSR.from_dense(jnp.ones((6, 5)))
    np.testing.assert_array_equal(a.indptr, np.asarray(ja.indptr))
    np.testing.assert_array_equal(a.indices, np.asarray(ja.indices))


def test_harvest_csr_of_bf16_matches_jax():
    """bf16 weight and mask: JAX's 15 nonzeros, in bf16, exactly."""
    w = np.random.default_rng(0).standard_normal((8, 6))
    mask = np.random.default_rng(1).random((8, 6)) < 0.4
    a = tr.harvest_csr(torch.tensor(w, dtype=torch.bfloat16),
                       torch.tensor(mask, dtype=torch.bfloat16))
    ja = jr.harvest_csr(jnp.asarray(w, jnp.bfloat16), jnp.asarray(mask, jnp.bfloat16))
    assert a.data.dtype == torch.bfloat16 and ja.data.dtype == jnp.bfloat16
    assert a.nnz == ja.nnz == 15
    np.testing.assert_array_equal(a.data.float().numpy(), np.asarray(ja.data, np.float32))
    np.testing.assert_array_equal(a.indices, np.asarray(ja.indices))
    np.testing.assert_array_equal(a.indptr, np.asarray(ja.indptr))
