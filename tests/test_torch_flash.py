"""Parity of the port's fused attention (tpusparse_torch.kernels.
flash_attention) with the JAX package's: the same numpy inputs go through
both; the JAX side runs its Pallas kernels in interpret mode, the port its
plain PyTorch versions (the wrappers take them for CPU tensors).

Tolerances:
  - fp32 tier ('high'): rtol 1e-4, atol 5e-5, the JAX suite's own;
  - gradients of `flash_attention_diff` against `jax.grad`: max-abs error
    within 2e-4 of the largest gradient, the bound of the JAX suite's
    tests/test_attention.py:179;
  - 'default' tier against the JAX 'default' tier: within 2e-3 of scale.
    The bf16 class of tests/test_attention.py:341 is 3e-2; here it is
    tighter because both sides round the same values to bf16 at the same
    places (at s <= 512 the JAX kernel runs one k tile, so p is taken from
    the row's global max on both sides) and only the fp32 summation order
    differs, which may flip a rare bf16 rounding (measured: at most 1.9e-4);
  - bf16 inputs: outputs are bf16 on both sides, one bf16 ulp being
    2^-8..2^-7 of the value: within 1e-2 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import flash_attention as jfa

from tpusparse_torch.kernels import flash_attention as tfa

TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_TOL = 2e-4
DEFAULT_TOL = 2e-3
BF16_TOL = 1e-2
# (b, h, s, d): plain, causal at a tile multiple, ragged, narrow and wide heads
SHAPES = {
    "2x3x256x64": (2, 3, 256, 64),
    "1x2x384x64": (1, 2, 384, 64),
    "ragged_1x1x200x64": (1, 1, 200, 64),
    "narrow_2x4x128x24": (2, 4, 128, 24),
    "wide_1x2x128x128": (1, 2, 128, 128),
}


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _over_scale(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_and_backward_match_jax(name, causal):
    q, k, v, do = _inputs(SHAPES[name], seed=len(name) + causal)
    jo, jlse = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   return_lse=True)
    jgrads = jfa.flash_attention_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                                     jnp.asarray(do), causal=causal)
    to, tlse = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal, return_lse=True)
    assert to.dtype == torch.float32 and tlse.shape == SHAPES[name][:3]
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    # the backward from the same o, lse and do as JAX's
    tgrads = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do),
                                     causal=causal)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=gname)


@pytest.mark.parametrize("shape,q_offset,kv_offset,rows", [
    # rows 256:512 against keys 0:256 of a 512-long causal attention: all
    # allowed (tests/test_attention.py:290-319)
    ((1, 1, 512, 64), 256, 0, slice(256, None)),
    # a ragged chunk whose rows see a growing prefix of its keys
    ((1, 2, 200, 64), 64, 0, slice(None)),
], ids=["sliced_512", "ragged_q_offset_64"])
def test_offsets_match_jax(shape, q_offset, kv_offset, rows):
    q, k, v, do = _inputs(shape, seed=7)
    cut = rows.start or 0
    q = q[..., rows, :]
    k, v, do = (x[..., : shape[2] - cut, :] for x in (k, v, do))
    kw = dict(causal=True, q_offset=q_offset, kv_offset=kv_offset)
    jo, jlse = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), return_lse=True, **kw)
    to, tlse = tfa.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    jgrads = jfa.flash_attention_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                                     jnp.asarray(do), **kw)
    tgrads = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), to, tlse, _t(do), **kw)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=gname)
    if rows.start:  # the sliced case against a float64 reference as well
        s_ref = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / 8.0
        p = np.exp(s_ref - s_ref.max(-1, keepdims=True))
        ref = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
        assert _over_scale(to.numpy(), ref) < 2e-5


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_diff_grads_match_jax_grad(causal):
    """All three gradients of `flash_attention_diff` (the autograd Function
    over the dq and dk/dv wrappers) against `jax.grad` of the JAX one; the
    ragged case exercises the padded-row masking."""
    s = 200 if causal else 128
    q, k, v = _inputs((1, 2, s, 64), seed=11, n=3)
    want = jax.grad(
        lambda *a: jnp.sum(jfa.flash_attention_diff(*a, causal, None) ** 2),
        argnums=(0, 1, 2),
    )(*map(jnp.asarray, (q, k, v)))
    ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
    tfa.flash_attention_diff(*ts, causal).square().sum().backward()
    for gname, t, w in zip(("dq", "dk", "dv"), ts, want):
        assert _over_scale(t.grad.numpy(), w) < GRAD_TOL, gname


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_default_tier_matches_jax_default_tier(causal):
    """'default' on fp32 inputs: pre-scaled q, k, v and do stored as bf16, p
    and dS rounded to bf16 before their products. The JAX package does the
    same on the CPU, so its 'default' tier is the reference here."""
    q, k, v, do = _inputs((1, 2, 200, 64), seed=13)
    kw = dict(causal=causal, precision="default")
    jo, jlse = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), return_lse=True, **kw)
    jgrads = jfa.flash_attention_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                                     jnp.asarray(do), **kw)
    to, tlse = tfa.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
    tgrads = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), **kw)
    assert _over_scale(to, jo) < DEFAULT_TOL
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert _over_scale(got, want) < DEFAULT_TOL, gname
    # and it is not the fp32 tier: the bf16 rounding shows
    o_high = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert _over_scale(to, o_high.numpy()) > 1e-4


def test_bf16_inputs_match_jax():
    q, k, v, do = _inputs((1, 2, 200, 64), seed=17)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = jfa.flash_attention(jq, jk, jv, causal=True, return_lse=True)
    jgrads = jfa.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, causal=True)
    bf = torch.bfloat16
    to, tlse = tfa.flash_attention(_t(q, bf), _t(k, bf), _t(v, bf), causal=True,
                                   return_lse=True)
    assert to.dtype == bf and tlse.dtype == torch.float32
    assert _over_scale(to, np.asarray(jo, np.float32)) < BF16_TOL
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    tgrads = tfa.flash_attention_bwd(_t(q, bf), _t(k, bf), _t(v, bf),
                                     _t(np.asarray(jo, np.float32), bf), _t(jlse),
                                     _t(do, bf), causal=True)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == bf
        assert _over_scale(got, np.asarray(want, np.float32)) < BF16_TOL, gname


def test_rows_that_see_no_key_give_zero():
    """Causal with kv_offset > q_offset: rows 0-99 see no key. The port gives
    them o = 0, lse = -1e30 and no gradient; the JAX kernel gives them the
    mean of v over its tile (exp(-1e30 - (-1e30)) = 1), a limit of the
    reference logged in ROADMAP section 3."""
    s, blind = 128, 100
    q, k, v, g = _inputs((1, 1, s, 64), seed=19)
    kw = dict(causal=True, q_offset=0, kv_offset=blind)
    ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = tfa.flash_attention(*ts, return_lse=True, **kw)
    assert torch.count_nonzero(o[..., :blind, :]) == 0
    assert bool((lse[..., :blind] == -1e30).all()) and bool((lse[..., blind:] > -1e29).all())
    jo = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), **kw))
    assert np.abs(jo[..., :blind, :]).max() > 0.1  # the reference's limit
    np.testing.assert_allclose(o[..., blind:, :].detach().numpy(), jo[..., blind:, :], **TOL)
    # gradients against float64 autograd of a dense softmax over the rows
    # that see a key (the blind rows' output is the constant 0)
    (o * _t(g)).sum().backward()
    refs = [torch.from_numpy(x.astype(np.float64)).requires_grad_(True) for x in (q, k, v)]
    rq, rk, rv = refs
    pos = torch.arange(s)
    vis = blind + pos[None, :] <= pos[:, None]
    sc = torch.where(vis, rq @ rk.transpose(-1, -2) / 8.0, -torch.inf)[..., blind:, :]
    ref_o = torch.softmax(sc, -1) @ rv
    (ref_o * torch.from_numpy(g[..., blind:, :].astype(np.float64))).sum().backward()
    assert torch.count_nonzero(ts[0].grad[..., :blind, :]) == 0
    for gname, t, r in zip(("dq", "dk", "dv"), ts, refs):
        assert _over_scale(t.grad.numpy(), r.grad.numpy()) < GRAD_TOL, gname


def test_sm_scale_is_rounded_to_the_input_type():
    """A custom sm_scale, pre-scaled into q in q's type (bf16 rounds it)."""
    q, k, v = _inputs((1, 2, 128, 24), seed=23, n=3)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, None),
                               (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        jo = jfa.flash_attention(*(jnp.asarray(x).astype(jdtype) for x in (q, k, v)),
                                 sm_scale=0.3)
        to = tfa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), sm_scale=0.3)
        if tol is None:
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        else:
            assert _over_scale(to, np.asarray(jo, np.float32)) < tol


def test_block_args_are_accepted_and_ignored():
    q, k, v = (_t(x) for x in _inputs((1, 1, 130, 64), seed=29, n=3))
    want = tfa.flash_attention(q, k, v, causal=True)
    got = tfa.flash_attention(q, k, v, causal=True, block_q=128, block_k=256)
    assert torch.equal(got, want)


def test_shape_errors():
    z = torch.zeros
    with pytest.raises(ValueError, match="shapes differ"):
        tfa.flash_attention(z(2, 128, 64), z(2, 128, 64), z(2, 128, 32))
    with pytest.raises(ValueError, match="seq, head_dim"):
        tfa.flash_attention(z(8), z(8), z(8))
    # a head dim above 128 is no longer refused: the kernels chunk it
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 16, 129), seed=5)[:3])
    want = torch.softmax(q @ k.transpose(1, 2) * 0.5, -1) @ v
    torch.testing.assert_close(tfa.flash_attention(q, k, v, sm_scale=0.5), want,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="shapes differ"):
        tfa.flash_attention_bwd(z(1, 8, 16), z(1, 8, 16), z(1, 9, 16), z(1, 8, 16),
                                z(1, 8), z(1, 8, 16))


def test_kernel_wrappers_check_their_operands_and_launch_nothing_on_cpu():
    q, k, v, do = (_t(x) for x in _inputs((2, 64, 24), seed=31))
    kw = dict(sm_scale=0.2)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_fwd_kernel(q.double(), k.double(), v.double(), **kw)
    with pytest.raises(TypeError, match="one type"):
        tfa.flash_fwd_kernel(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, **kw)
    with pytest.raises(ValueError, match=r"\(bh, s, d\)"):
        tfa.flash_fwd_kernel(q[None], k[None], v[None], **kw)
    tfa.reset_launch_counts()
    o, lse = tfa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do * o).sum(-1)
    with pytest.raises(TypeError, match="lse"):
        tfa.flash_dq_kernel(q, k, v, do, lse.double(), delta, **kw)
    tfa.flash_dq_kernel(q, k, v, do, lse, delta, **kw)
    tfa.flash_dkv_kernel(q, k, v, do, lse, delta, **kw)
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_q8": 0}


# -- head dims above 128 ---------------------------------------------------------
# q, k, v (1, 2, 64, 192) fp32 at 'highest': the JAX wrappers pad d to a
# multiple of 128 (tpusparse/kernels/flash_attention.py:232, 634, 1036, 1232,
# 1541); the port's kernels take any d, in 128-wide chunks on the card.
WIDE_SHAPE = (1, 2, 64, 192)
# the forwards alone at the widths the card's wide forward splits apart:
# (kind, (b, h, s, d), causal, q_offset); d 136 takes a second 128-column
# slice of 8 columns, d 256 two whole slices, d 320 and 640 more than one
# 256-wide chunk of o; every row sees at least one key
WIDE_FORWARDS = {
    "flash_d136": ("flash", (1, 2, 80, 136), False, 0),
    "flash_causal_d256_q64": ("flash", (1, 2, 64, 256), True, 64),
    "flash_causal_d320": ("flash", (1, 1, 72, 320), True, 0),
    "flash_causal_d640": ("flash", (1, 1, 64, 640), True, 0),
    "block_d136": ("block", (1, 2, 64, 136), False, 0),
    "block_d320": ("block", (1, 2, 64, 320), False, 0),
}
# the flash backward at the widths the card's wide backward splits apart:
# ((b, h, s, d), causal, q_offset); d 136 takes a 64-column slice of 8
# columns, d 256 the four slices of two teams, d 320 the one-team instance,
# d 640 two 512-wide chunks of the output with S and dP over d in pieces
WIDE_BACKWARDS = {
    "d136": ((1, 2, 80, 136), False, 0),
    "causal_d256_q64": ((1, 2, 64, 256), True, 64),
    "causal_d320": ((1, 1, 72, 320), True, 0),
    "causal_d640": ((1, 1, 64, 640), True, 0),
}


def _wide_forward_matches_jax(path):
    kind, shape, causal, q_off = WIDE_FORWARDS[path]
    q, k, v, _ = _inputs(shape, seed=shape[-1])
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if kind == "flash":
        kw = dict(causal=causal, q_offset=q_off, precision="highest")
        jo, jlse = jfa.flash_attention(jq, jk, jv, return_lse=True, **kw)
        to, tlse = tfa.flash_attention(_t(q), _t(k), _t(v), return_lse=True, **kw)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    else:
        from tpusparse.nn import bigbird_block_mask as j_bigbird_block_mask

        from tpusparse_torch.kernels import block_flash_attention as tbf

        mask = j_bigbird_block_mask(64, 16, 3, 1, 1, seed=5)
        jplan, tplan = jfa.BlockAttnPlan(mask, 16, 16, 64), tbf.BlockAttnPlan(mask, 16, 16, 64)
        jo = jfa.block_flash_attention(jq, jk, jv, jplan, precision="highest")
        to = tbf.block_flash_attention(_t(q), _t(k), _t(v), tplan, precision="highest")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("path", ["flash", "diff", "block", "q8", "self_attention",
                                  *WIDE_FORWARDS])
def test_head_dims_above_128_match_jax(path):
    if path in WIDE_FORWARDS:
        return _wide_forward_matches_jax(path)
    q, k, v, do = _inputs(WIDE_SHAPE, seed=41)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kw = dict(precision="highest")
    if path == "flash":
        jo, jlse = jfa.flash_attention(jq, jk, jv, causal=True, return_lse=True, **kw)
        to, tlse = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, return_lse=True, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
        jgrads = jfa.flash_attention_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), causal=True, **kw)
        tgrads = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do),
                                         causal=True, **kw)
        for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=gname)
    elif path == "diff":
        want = jax.grad(lambda *a: jnp.sum(jfa.flash_attention_diff(*a, False, None, "highest")
                                           ** 2), argnums=(0, 1, 2))(jq, jk, jv)
        ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
        tfa.flash_attention_diff(*ts, False, None, "highest").square().sum().backward()
        for gname, t, w in zip(("dq", "dk", "dv"), ts, want):
            assert _over_scale(t.grad.numpy(), w) < GRAD_TOL, gname
    elif path == "block":
        from tpusparse.nn import bigbird_block_mask as j_bigbird_block_mask

        from tpusparse_torch.kernels import block_flash_attention as tbf

        mask = j_bigbird_block_mask(64, 16, 3, 1, 1, seed=3)
        jplan, tplan = jfa.BlockAttnPlan(mask, 16, 16, 64), tbf.BlockAttnPlan(mask, 16, 16, 64)
        jo = jfa.block_flash_attention(jq, jk, jv, jplan, **kw)
        to = tbf.block_flash_attention(_t(q), _t(k), _t(v), tplan, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        want = jax.grad(lambda *a: jnp.sum(jfa.block_flash_attention_diff(*a, jplan, None,
                                                                          "highest") ** 2),
                        argnums=(0, 1, 2))(jq, jk, jv)
        ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
        tbf.block_flash_attention_diff(*ts, tplan, None, "highest").square().sum().backward()
        for gname, t, w in zip(("dq", "dk", "dv"), ts, want):
            assert _over_scale(t.grad.numpy(), w) < GRAD_TOL, gname
    elif path == "q8":
        # q given as bf16-representable values: the two differ only by p's
        # rounding to bf16 (tests/test_torch_serving_attention.py's bound)
        qb = torch.from_numpy(q).to(torch.bfloat16).float()
        tkv = tfa.quantize_kv(_t(k), _t(v))
        jkv = jfa.quantize_kv(jk, jv)
        got = tfa.flash_attention_q8(qb, *tkv, causal=True)
        want = jfa.flash_attention_q8(jnp.asarray(qb.numpy()), *jkv, causal=True)
        assert got.shape == WIDE_SHAPE and _over_scale(got, want) < 2e-3
    else:
        import tpusparse_torch as tt
        from tpusparse.nn import SelfAttention as JSelfAttention

        x = np.random.default_rng(42).standard_normal((1, 64, 384)).astype(np.float32)
        jmod = JSelfAttention(num_heads=2, head_dim=192, fused=True)
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        tmod = tt.SelfAttention(2, 192, fused=True, hidden=384, device="cpu")
        tt.load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
        got = tmod(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jmod.apply(params, x)),
                                   **TOL)


@pytest.mark.parametrize("name", sorted(WIDE_BACKWARDS))
def test_wide_backward_matches_jax(name):
    """The port's flash_attention_bwd (its plain versions on the CPU) from
    JAX's o and lse, against JAX's flash_attention_bwd at 'highest'."""
    shape, causal, q_off = WIDE_BACKWARDS[name]
    q, k, v, do = _inputs(shape, seed=shape[-1] + 1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kw = dict(causal=causal, q_offset=q_off, precision="highest")
    jo, jlse = jfa.flash_attention(jq, jk, jv, return_lse=True, **kw)
    jgrads = jfa.flash_attention_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), **kw)
    tgrads = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), **kw)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=gname)
