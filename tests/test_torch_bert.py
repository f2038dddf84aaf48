"""Parity of the port's BERT path (nn.attention.SelfAttention,
models.bert.BertAttentionLayer / BertEncoder, their LayerNorm and Embed,
and convert's nested trees) with the JAX package: the same flax parameters,
carried over with load_flax_params, and the same numpy inputs go through
both; the JAX flash kernels run in interpret mode.

Tolerances: forwards and SGD trajectories at the fp32 tier (rtol 1e-4,
atol 5e-5, the JAX suite's own); parameter gradients within 2e-4 of the
largest gradient of the module (atol), the gradient bound of the JAX suite
(tests/test_attention.py:179), and 1e-3 relative. The scale is the whole
module's because the rounding of a backward's sums follows the magnitudes
that flow through it: some gradients (the value bias, whose effect the
softmax and the LayerNorms nearly cancel; ln1's scale) come out some 1e-5
of the largest, and there both packages carry rounding of about 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusparse.models import BertAttentionLayer as JLayer
from tpusparse.models import BertEncoder as JEncoder
from tpusparse.nn import SelfAttention as JSelfAttention

import tpusparse_torch as tt

TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_TOL = 2e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    """{'a.b.c': leaf} of a nested dict."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(val, name) if isinstance(val, dict) else {name: val})
    return out


def _assert_grads_close(module, jgrads):
    """Every port parameter's gradient against JAX's, by flax path (the
    port's parameter names are the dotted flax paths)."""
    want = _flat(_np_tree(jgrads)["params"])
    got = {n: p.grad.numpy() for n, p in module.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=GRAD_TOL * scale,
                                   err_msg=name)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- SelfAttention -------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_self_attention_matches_flax(fused):
    x = _x((2, 128, 96))
    jmod = JSelfAttention(num_heads=4, head_dim=24, fused=fused)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jgrads = jax.grad(lambda p: jnp.mean(jmod.apply(p, jnp.asarray(x)) ** 2))(params)
    tmod = tt.SelfAttention(4, 24, fused=fused, hidden=96, device="cpu")
    tt.load_flax_params(tmod, _np_tree(params))
    out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jmod.apply(params, x)), **TOL)
    out.square().mean().backward()
    _assert_grads_close(tmod, jgrads)


def test_self_attention_causal_dense_matches_fused():
    x = torch.from_numpy(_x((1, 40, 48), seed=1))
    gen = torch.Generator().manual_seed(0)
    dense = tt.SelfAttention(4, 12, causal=True, hidden=48, device="cpu", generator=gen)
    fused = tt.SelfAttention(4, 12, fused=True, causal=True, hidden=48, device="cpu")
    fused.load_state_dict(dense.state_dict())
    torch.testing.assert_close(fused(x), dense(x), **TOL)
    with pytest.raises(ValueError, match="causal"):
        fused(x, mask=torch.ones(40, 40, dtype=torch.bool))


# -- BertAttentionLayer ---------------------------------------------------------


def _layer_pair(attention, hidden=48, num_heads=4, intermediate=96, x_shape=None, seed=0):
    jlayer = JLayer(hidden=hidden, num_heads=num_heads, intermediate=intermediate,
                    attention=attention)
    params = jlayer.init(jax.random.PRNGKey(seed), jnp.zeros(x_shape, jnp.float32))
    tlayer = tt.BertAttentionLayer(hidden, num_heads, intermediate, attention, device="cpu")
    tt.load_flax_params(tlayer, _np_tree(params))
    return jlayer, params, tlayer


@pytest.mark.parametrize("seq", [40, 128])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_layer_forward_and_grads_match_jax(attention, seq):
    x = _x((2, seq, 48), seed=seq)
    jlayer, params, tlayer = _layer_pair(attention, x_shape=x.shape)
    jloss = lambda p: jnp.mean(jlayer.apply(p, jnp.asarray(x)) ** 2)  # noqa: E731
    jgrads = jax.grad(jloss)(params)
    out = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jlayer.apply(params, x)), **TOL)
    tt.bert_loss(out).backward()
    _assert_grads_close(tlayer, jgrads)


def test_full_width_layer_matches_jax():
    """One BERT-base layer (hidden 768, 12 heads of 64, intermediate 3072)
    on the flash path, batch 1, seq 128: forward and every gradient."""
    x = _x((1, 128, 768), seed=3)
    jlayer, params, tlayer = _layer_pair("flash", 768, 12, 3072, x.shape)
    jgrads = jax.grad(lambda p: jnp.mean(jlayer.apply(p, jnp.asarray(x)) ** 2))(params)
    out = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jlayer.apply(params, x)), **TOL)
    tt.bert_loss(out).backward()
    _assert_grads_close(tlayer, jgrads)


def test_dense_layer_mask_matches_jax():
    x = _x((2, 40, 48), seed=4)
    keep = np.random.default_rng(5).random((2, 1, 1, 40)) < 0.7  # key padding mask
    keep[..., 0] = True
    jlayer, params, tlayer = _layer_pair("dense", x_shape=x.shape)
    want = jlayer.apply(params, jnp.asarray(x), jnp.asarray(keep))
    got = tlayer(torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert not np.allclose(got.detach().numpy(), np.asarray(jlayer.apply(params, x)), **TOL)


def test_layer_variants_raise_as_jax_does():
    x = torch.zeros(1, 64, 48)
    mask = torch.ones(64, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown attention 'nope'"):
        tt.BertAttentionLayer(48, 4, 96, "nope", device="cpu")
    with pytest.raises(ValueError, match="unknown attention"):
        tt.BertEncoder(1, 48, 4, 96, 100, 64, attention="nope", device="cpu")
    jx = jnp.zeros((1, 64, 48))
    for variant in ("local", "sparse", "bigbird"):
        layer = tt.BertAttentionLayer(48, 4, 96, variant, device="cpu")
        # a mask given to a pattern variant is refused first, as in JAX
        with pytest.raises(ValueError, match="does not accept a mask"):
            layer(x, mask)
        with pytest.raises(ValueError, match="does not accept a mask"):
            JLayer(hidden=48, num_heads=4, intermediate=96, attention=variant).init(
                jax.random.PRNGKey(0), jx, jnp.ones((64, 64), bool))
        # and without one it runs, as the JAX layer does
        out = layer(x)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="causal"):
        tt.BertAttentionLayer(48, 4, 96, "flash", device="cpu")(x, mask)


# -- LayerNorm, Embed and the seeded init ---------------------------------------


def test_layer_norm_uses_flax_eps():
    """Zero-mean rows of variance ~1e-6: flax's eps 1e-6 gives x/sqrt(2e-6);
    torch's default 1e-5 would give x/sqrt(1.1e-5), 2.3x smaller."""
    import flax.linen as fnn

    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 64))
    x = ((x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True) * 1e-3).astype(np.float32)
    jln = fnn.LayerNorm()
    want = np.asarray(jln.apply(jln.init(jax.random.PRNGKey(0), x), x))
    got = tt.LayerNorm(64, device="cpu")(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    torch_default = torch.nn.LayerNorm(64)(torch.from_numpy(x)).detach().numpy()
    assert not np.allclose(torch_default, want, **TOL)


def test_seeded_init_draws_from_the_flax_families():
    enc = tt.BertEncoder(1, 64, 4, 128, 1000, 64, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    w = enc.tok_emb.embedding.detach()
    assert abs(float(w.std()) - 1 / 8) < 0.01 and abs(float(w.mean())) < 0.01
    for ln in (enc.emb_ln, enc.layer0.ln1, enc.layer0.ln2):
        assert torch.equal(ln.scale, torch.ones(64)) and torch.equal(ln.bias, torch.zeros(64))
    k = enc.layer0.ffn_in.kernel.detach()  # U(±1/sqrt(fan_in)), fan_in 64
    assert float(k.abs().max()) <= 1 / 8 and float(k.abs().max()) > 0.12
    again = tt.BertEncoder(1, 64, 4, 128, 1000, 64, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    for (n, p), (_, q) in zip(enc.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n


# -- BertEncoder: forward and a short SGD trajectory ------------------------------


def _encoder_pair(attention, ids):
    cfg = dict(num_layers=2, hidden=48, num_heads=4, intermediate=96, vocab_size=100,
               max_position=64, attention=attention)
    jenc = JEncoder(**cfg)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    tenc = tt.BertEncoder(**cfg, device="cpu")
    tt.load_flax_params(tenc, _np_tree(params))
    return jenc, params, tenc


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_encoder_sgd_steps_match_jax(attention):
    ids = np.random.default_rng(7).integers(0, 100, size=(2, 40)).astype(np.int32)
    jenc, params, tenc = _encoder_pair(attention, ids)
    out = tenc(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jenc.apply(params, ids)), **TOL)

    tx = optax.sgd(0.01, momentum=0.9)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(p, o):
        loss, grads = jax.value_and_grad(
            lambda q: jnp.mean(jenc.apply(q, jnp.asarray(ids)) ** 2))(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    opt = tt.make_train_state(tenc)
    for _ in range(3):
        params, opt_state, jloss = jstep(params, opt_state)
        tloss = tt.bert_train_step(tenc, opt, torch.from_numpy(ids).long())
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = _flat(_np_tree(params)["params"])
    for name, p in tenc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], **TOL, err_msg=name)


# -- convert: nested trees ------------------------------------------------------


def test_convert_round_trips_the_nested_tree():
    ids = np.zeros((1, 8), np.int32)
    _, params, tenc = _encoder_pair("flash", ids)
    tree = _np_tree(params)
    back = tt.to_flax_params(tenc)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for name, leaf in _flat(back["params"]).items():
        np.testing.assert_array_equal(leaf, _flat(tree["params"])[name], err_msg=name)
    assert set(back["params"]["layer1"]["attention"]) == {"query", "key", "value", "out"}

    other = tt.BertEncoder(2, 48, 4, 96, 100, 64, attention="flash", device="cpu")
    tt.load_flax_params(other, back)
    for (n, p), (_, q) in zip(other.named_parameters(), tenc.named_parameters()):
        assert torch.equal(p, q), n

    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["params"]["layer1"]["attention"]["query"]["bias"]
    with pytest.raises(KeyError, match="layer1.attention.query"):
        tt.load_flax_params(other, missing)
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["params"]["layer0"]["ln1"]["mean"] = np.zeros(48, np.float32)
    with pytest.raises(KeyError, match="layer0.ln1"):
        tt.load_flax_params(other, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["params"]["pos_emb"]["embedding"] = np.zeros((65, 48), np.float32)
    with pytest.raises(ValueError, match="pos_emb.embedding: shape"):
        tt.load_flax_params(other, bad)
