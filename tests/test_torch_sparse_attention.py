"""Parity of the port's pattern attention (tpusparse_torch.nn.attention:
the pattern builders, `route_sparse_attention`, `LocalAttention`,
`SparseSelfAttention` on each engine, `BigBirdAttention`; the BERT layer's
'local', 'sparse' and 'bigbird' variants and a 'bigbird' encoder; and the
`ops.gather_spmm` and `dense.einsum` they run on) with the JAX package: the
same flax parameters, carried over with load_flax_params, and the same
numpy inputs go through both; the JAX block-flash kernels run in interpret
mode.

Tolerances as tests/test_torch_bert.py: forwards and SGD trajectories at
rtol 1e-4, atol 5e-5; parameter gradients within 2e-4 of the module's
largest gradient (atol) and 1e-3 relative.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusparse import dense as jdense
from tpusparse import nn as jnn
from tpusparse import ops as jops
from tpusparse.models import BertAttentionLayer as JLayer
from tpusparse.models import BertEncoder as JEncoder
from tpusparse.types import CSR as JCSR

import tpusparse_torch as tt
from tpusparse_torch.utils.config import set_config

TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_TOL = 2e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(val, name) if isinstance(val, dict) else {name: val})
    return out


def _assert_grads_close(module, jgrads):
    want = _flat(_np_tree(jgrads)["params"])
    got = {n: p.grad.numpy() for n, p in module.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=GRAD_TOL * scale,
                                   err_msg=name)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- patterns and routes ----------------------------------------------------------


@pytest.mark.parametrize("seq,window,num_global", [(128, 12, 2), (160, 20, 3), (512, 64, 0)])
def test_local_global_pattern_equals_jax(seq, window, num_global):
    for got, want in zip(tt.local_global_pattern(seq, window, num_global),
                         jnn.local_global_pattern(seq, window, num_global)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [
    (128, 32, 1, 1, 1, 3), (512, 64, 3, 1, 2, 0), (4096, 256, 3, 1, 2, 0), (256, 64, 1, 1, 1, 0),
    (256, 32, 3, 2, 2, 7),
], ids=lambda a: "x".join(map(str, a)))
def test_bigbird_patterns_equal_jax(args):
    """The same random blocks, from np.random.default_rng(seed)."""
    np.testing.assert_array_equal(tt.bigbird_block_mask(*args), jnn.bigbird_block_mask(*args))
    for got, want in zip(tt.bigbird_pattern(*args), jnn.bigbird_pattern(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_bigbird_patterns_refuse_an_untileable_seq():
    for fn in (tt.bigbird_block_mask, tt.bigbird_pattern):
        with pytest.raises(ValueError, match="multiple"):
            fn(100, block=32)


def _scattered(s=8192):
    rng = np.random.default_rng(0)
    return rng.integers(0, s, s).astype(np.int32), np.arange(s + 1, dtype=np.int32)


# the patterns of TestIrregularPatternRouting (tests/test_attention.py:640-678)
# and of the BERT layer's 'sparse' variant at seq 512 and 4096
ROUTES = {
    "banded_4096": (lambda: jnn.local_global_pattern(4096, 40, 3), 4096, 0, "blockflash"),
    "short_1024": (lambda: jnn.local_global_pattern(1024, 40, 3), 1024, 0, "dense"),
    "scattered_8192_b256": (_scattered, 8192, 256, "sddmm"),
    "untileable_96": (lambda: jnn.local_global_pattern(96, 4, 1), 96, 0, "dense"),
    "bert_sparse_512": (lambda: jnn.local_global_pattern(512, 64, 0), 512, 0, "dense"),
    "bert_sparse_4096": (lambda: jnn.local_global_pattern(4096, 64, 0), 4096, 0, "blockflash"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routes_equal_jax(name):
    pattern, seq, block, expect = ROUTES[name]
    ind, ptr = pattern()
    jmethod, jplan, jreport = jnn.route_sparse_attention(ind, ptr, seq, block)
    method, plan, report = tt.route_sparse_attention(ind, ptr, seq, block)
    assert method == jmethod == expect
    assert (plan is None) == (jplan is None)
    if plan is not None:
        for attr in ("kv_list", "kv_cnt", "q_list", "q_cnt", "q_slot", "tile_masks"):
            w, g = getattr(jplan, attr), getattr(plan, attr)
            assert (g is None) == (w is None), attr
            if w is not None:
                np.testing.assert_array_equal(g, w, err_msg=attr)
        assert ("token-exact masks" in report) == ("token-exact masks" in jreport)
    assert report.endswith(f"-> {method}") or plan is None


# -- ops.gather_spmm and dense.einsum ----------------------------------------------


@pytest.mark.parametrize("b_shape", [(60, 7), (3, 60, 5)], ids=["2d", "3d"])
def test_gather_spmm_and_its_grads_equal_jax(b_shape):
    rng = np.random.default_rng(1)
    dense_a = (rng.random((40, 60)) < 0.1) * rng.standard_normal((40, 60))
    dense_a[5] = 0.0  # an empty row
    ja = JCSR.from_dense(dense_a.astype(np.float32))
    b = rng.standard_normal(b_shape).astype(np.float32)
    g = rng.standard_normal(b_shape[:-2] + (40, b_shape[-1])).astype(np.float32)
    jout, vjp = jax.vjp(lambda data, bb: jops.gather_spmm(
        JCSR(data, ja.indices, ja.indptr, ja.shape), bb), ja.data, jnp.asarray(b))
    jd, jb = vjp(jnp.asarray(g))
    ta = tt.CSR.from_dense(dense_a.astype(np.float32), device="cpu")
    data = ta.data.clone().requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = tt.gather_spmm(tt.CSR(data, ta.indices, ta.indptr, ta.shape), tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), **TOL)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_einsum_equals_jax_and_rounds_in_the_default_tier(precision):
    a, b = _x((2, 3, 4, 16, 24), 2), _x((2, 3, 4, 48, 24), 3)
    spec = "bhnqd,bhnkd->bhnqk"
    want = np.asarray(jdense.einsum(spec, jnp.asarray(a), jnp.asarray(b)))
    set_config(precision=precision)
    try:
        got = tt.einsum(spec, torch.from_numpy(a), torch.from_numpy(b))
    finally:
        set_config(precision="high")
    assert got.dtype == torch.float32
    if precision == "high":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:  # the operands rounded to bf16 first (JAX on the CPU does not round)
        ra, rb = (torch.from_numpy(x).bfloat16().double() for x in (a, b))
        np.testing.assert_allclose(got.numpy(), torch.einsum(spec, ra, rb).numpy(), **TOL)
        assert not np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# -- modules against flax ------------------------------------------------------------


def _module_parity(jmod, tmod, x):
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jgrads = jax.grad(lambda p: jnp.mean(jmod.apply(p, jnp.asarray(x)) ** 2))(params)
    tt.load_flax_params(tmod, _np_tree(params))
    out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jmod.apply(params, x)), **TOL)
    out.square().mean().backward()
    _assert_grads_close(tmod, jgrads)


def test_local_attention_matches_flax():
    x = _x((2, 128, 32), 4)
    _module_parity(jnn.LocalAttention(num_heads=2, head_dim=16, window=32),
                   tt.LocalAttention(2, 16, window=32, hidden=32, device="cpu"), x)


def test_local_attention_refuses_an_untileable_seq():
    with pytest.raises(ValueError, match="multiple of window 48"):
        tt.LocalAttention(2, 8, window=48, hidden=16, device="cpu")(torch.zeros(1, 64, 16))


SPARSE_CASES = {
    # (seq, kwargs): the three forced engines, 'auto' on a bigbird token
    # pattern, and a seq that no block tiles
    "blockflash_band": (128, dict(window=12, num_global=2, method="blockflash", block=64)),
    "dense_band": (128, dict(window=12, num_global=2, method="dense")),
    "sddmm_band": (128, dict(window=12, num_global=2, method="sddmm")),
    "auto_bigbird": (128, dict(pattern_fn=partial(jnn.bigbird_pattern, block=32, window_blocks=1,
                                                  num_global_blocks=1, num_random_blocks=1,
                                                  seed=3))),
    "auto_untileable_96": (96, dict(window=4, num_global=1)),
}


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_self_attention_matches_flax(name):
    seq, kw = SPARSE_CASES[name]
    x = _x((2, seq, 32), 5)
    tkw = dict(kw)
    if "pattern_fn" in kw:
        tkw["pattern_fn"] = partial(tt.bigbird_pattern, **kw["pattern_fn"].keywords)
    tmod = tt.SparseSelfAttention(2, 16, **tkw, hidden=32, device="cpu")
    _module_parity(jnn.SparseSelfAttention(num_heads=2, head_dim=16, **kw), tmod, x)
    want = {"blockflash_band": "blockflash", "dense_band": "dense", "sddmm_band": "sddmm",
            "auto_bigbird": "dense", "auto_untileable_96": "dense"}[name]
    assert tmod.engine(seq)[0] == want


def test_sparse_self_attention_refuses_as_jax_does():
    with pytest.raises(ValueError, match="unknown method"):
        tt.SparseSelfAttention(2, 8, method="nope", hidden=16, device="cpu")
    layer = tt.SparseSelfAttention(2, 8, window=4, method="blockflash", hidden=16, device="cpu")
    with pytest.raises(ValueError, match="not tileable"):
        layer(torch.zeros(1, 96, 16))


def _bigbird_parity(head_dim):
    x = _x((2, 128, 32), 6)
    kw = dict(block=32, window_blocks=3, num_global_blocks=1, num_random_blocks=1)
    tmod = tt.BigBirdAttention(2, head_dim, **kw, hidden=32, device="cpu")
    _module_parity(jnn.BigBirdAttention(num_heads=2, head_dim=head_dim, **kw), tmod, x)
    plan = tmod.plan(128)
    assert plan.tile_masks is None and 0 < plan.density < 1


def test_bigbird_attention_matches_flax():
    _bigbird_parity(16)


@pytest.mark.parametrize("head_dim", [136])
def test_bigbird_attention_matches_flax_above_head_dim_128(head_dim):
    """The module's output and every gradient at a head dim where the card
    runs the block kernels' wide teams."""
    _bigbird_parity(head_dim)


# -- the BERT layer's pattern variants and a 'bigbird' encoder -------------------------


def _layer_pair(attention, hidden=48, num_heads=4, intermediate=96, x_shape=None, **kw):
    jlayer = JLayer(hidden=hidden, num_heads=num_heads, intermediate=intermediate,
                    attention=attention, **kw)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32))
    tlayer = tt.BertAttentionLayer(hidden, num_heads, intermediate, attention, **kw,
                                   device="cpu")
    tt.load_flax_params(tlayer, _np_tree(params))
    return jlayer, params, tlayer


LAYER_CASES = {
    "local_w32": ("local", dict(window=32)),
    "sparse_w16_g2": ("sparse", dict(window=16, num_global=2)),
    "bigbird_w32": ("bigbird", dict(window=32)),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_pattern_layer_forward_and_grads_match_jax(name):
    attention, kw = LAYER_CASES[name]
    x = _x((2, 128, 48), 7)
    jlayer, params, tlayer = _layer_pair(attention, x_shape=x.shape, **kw)
    jgrads = jax.grad(lambda p: jnp.mean(jlayer.apply(p, jnp.asarray(x)) ** 2))(params)
    out = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jlayer.apply(params, x)), **TOL)
    tt.bert_loss(out).backward()
    _assert_grads_close(tlayer, jgrads)


def test_full_width_bigbird_layer_matches_jax():
    """One BERT-base layer (hidden 768, 12 heads of 64, intermediate 3072)
    with attention='bigbird', block = window = 64, batch 1, seq 128."""
    x = _x((1, 128, 768), 8)
    jlayer, params, tlayer = _layer_pair("bigbird", 768, 12, 3072, x.shape)
    with torch.no_grad():
        out = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jlayer.apply(params, x)), **TOL)
    assert tlayer.attention.block == 64


def test_bigbird_encoder_sgd_steps_match_jax():
    ids = np.random.default_rng(9).integers(0, 100, size=(2, 128)).astype(np.int32)
    cfg = dict(num_layers=2, hidden=48, num_heads=4, intermediate=96, vocab_size=100,
               max_position=128, attention="bigbird", window=32)
    jenc = JEncoder(**cfg)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    tenc = tt.BertEncoder(**cfg, device="cpu")
    tt.load_flax_params(tenc, _np_tree(params))
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


def test_pattern_variants_carry_their_flax_trees():
    """to_flax_params gives each variant the flax tree (the same names under
    `attention` as SelfAttention), and load_flax_params takes it back."""
    x = jnp.zeros((1, 128, 48), jnp.float32)
    for attention, kw in LAYER_CASES.values():
        jparams = JLayer(hidden=48, num_heads=4, intermediate=96, attention=attention,
                         **kw).init(jax.random.PRNGKey(2), x)
        layer = tt.BertAttentionLayer(48, 4, 96, attention, **kw, device="cpu")
        tt.load_flax_params(layer, _np_tree(jparams))
        back = tt.to_flax_params(layer)
        assert set(back["params"]["attention"]) == {"query", "key", "value", "out"}
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(_np_tree(jparams)))
        for name, leaf in _flat(back["params"]).items():
            np.testing.assert_array_equal(leaf, _flat(_np_tree(jparams)["params"])[name])
