"""Parity of the port's sequence-parallel attention
(tpusparse_torch.parallel.attention) with the JAX package's
(tpusparse.parallel.attention).

The port runs as 4 processes on a gloo group (`torch_parallel_worker.py`
'attention', launched once for the module); the JAX side runs the same
functions on the same inputs over a 4-device mesh of CPU devices, its flash
kernels in interpret mode. The world-size-1 cases run the port in this
process, the form the card runs, against its one-rank form.

Tolerances: outputs within 2e-5 of scale and the ring's gradients within
2e-4 of scale (JAX's own bounds, tests/test_parallel.py:140-203); the band
and unfused Ulysses at the fp32 tier (rtol 1e-4, atol 5e-5); bf16 outputs
within 1e-2 of scale. The gradients of the global loss are held to the
unsharded oracle's by their ratio, 1 within 1e-4: a factor of the axis size
anywhere fails it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.parallel as jpar
from tpusparse.kernels.flash_attention import _reference_attention

import tpusparse_torch as tt
from tpusparse_torch import parallel as tpar
from tpusparse_torch.kernels.flash_attention import flash_attention_diff

import torch_parallel_worker as W

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
OUT_SCALE, GRAD_SCALE, BF16_SCALE = 2e-5, 2e-4, 1e-2
RATIO = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of the 'attention' group on 4 gloo ranks."""
    return W.launch("attention", tmp_path_factory.mktemp("torch_parallel_attention"))


@pytest.fixture(scope="module")
def ws1():
    """A one-rank 'seq' axis on gloo in this process."""
    tpar.initialize_distributed(device="cpu")
    return tpar.make_mesh((1,), ("seq",), device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh((W.WORLD,), ("seq",), devices=jax.devices()[:W.WORLD])


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_grads(fn, arrays):
    """fn(q, k, v) and its gradients of sum(fn²), jitted."""
    args = tuple(jnp.asarray(a) for a in arrays)
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_ratio_one(got, want, name) -> None:
    """<got, want> / <want, want> is 1: no factor of the axis size."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ratio = float((got * want).sum() / (want * want).sum())
    assert abs(ratio - 1.0) < RATIO, (name, ratio)


def _band_oracle(q, k, v, window):
    s = q.shape[2]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    scores = jnp.where(np.abs(i - j) <= window, scores, -1e9)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(scores, -1), v)


def _dense_oracle(q, k, v, mask=None, causal=False):
    s = q.shape[2]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        scores = jnp.where(np.tril(np.ones((s, s), bool)), scores, -1e9)
    if mask is not None:
        scores = jnp.where(mask, scores, -1e9)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(scores, -1), v)


# -- ring-local band ------------------------------------------------------------------


def test_ring_local_matches_jax_and_the_oracle(ranks, jmesh):
    arrays = W.band_inputs()
    w = W.BAND["window"]
    out, grads = _jax_grads(lambda q, k, v: jpar.ring_local_attention(q, k, v, w, jmesh), arrays)
    np.testing.assert_allclose(ranks["band"], out, **TOL)
    _, oracle = _jax_grads(lambda q, k, v: _band_oracle(q, k, v, w), arrays)
    for name, g, o in zip("qkv", grads, oracle):
        np.testing.assert_allclose(ranks[f"band_grad_{name}"], g, **TOL)
        _assert_ratio_one(ranks[f"band_grad_{name}"], o, f"d{name}")


def test_ring_local_world_size_1_is_the_local_attention_core(ws1):
    q, k, v = (torch.from_numpy(a) for a in W.band_inputs())
    w = W.BAND["window"]
    got = tpar.ring_local_attention(q, k, v, w, ws1)
    b, h, s, hd = q.shape

    def blocks(x):
        return x.reshape(b, h, s // w, w, hd)

    pad = [torch.nn.functional.pad(blocks(x), (0, 0, 0, 0, 1, 1)) for x in (k, v)]
    want = tt.nn.attention.banded_blocks(blocks(q), *pad, w, 0, s).reshape(b, h, s, hd)
    torch.testing.assert_close(got, want, **TOL)


# -- Ulysses -----------------------------------------------------------------------------


def test_ulysses_per_head_mask_matches_jax(ranks, jmesh):
    *arrays, mask = W.ulysses_inputs()
    out, grads = _jax_grads(lambda q, k, v: jpar.ulysses_attention(q, k, v, jmesh, mask=mask),
                            arrays)
    assert ranks["ulysses_mask"].shape == W.ULYSSES_SHAPE
    np.testing.assert_allclose(ranks["ulysses_mask"], out, **TOL)
    _, oracle = _jax_grads(lambda q, k, v: _dense_oracle(q, k, v, mask=mask), arrays)
    for name, g, o in zip("qkv", grads, oracle):
        np.testing.assert_allclose(ranks[f"ulysses_mask_grad_{name}"], g, **TOL)
        _assert_ratio_one(ranks[f"ulysses_mask_grad_{name}"], o, f"d{name}")


def test_ulysses_causal_matches_jax(ranks, jmesh):
    arrays = W.ulysses_inputs()[:3]
    out, grads = _jax_grads(
        lambda q, k, v: jpar.ulysses_attention(q, k, v, jmesh, causal=True), arrays)
    np.testing.assert_allclose(ranks["ulysses_causal"], out, **TOL)
    _, oracle = _jax_grads(lambda q, k, v: _dense_oracle(q, k, v, causal=True), arrays)
    for name, g, o in zip("qkv", grads, oracle):
        np.testing.assert_allclose(ranks[f"ulysses_causal_grad_{name}"], g, **TOL)
        _assert_ratio_one(ranks[f"ulysses_causal_grad_{name}"], o, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_fused_matches_jax(ranks, jmesh, causal):
    arrays = W.flash_inputs()
    out, grads = _jax_grads(lambda q, k, v: jpar.ulysses_attention(
        q, k, v, jmesh, fused=True, causal=causal), arrays)
    assert _scale_err(ranks[f"ulysses_fused_{causal}"], out) < OUT_SCALE
    for name, g in zip("qkv", grads):
        assert _scale_err(ranks[f"ulysses_fused_{causal}_grad_{name}"], g) < GRAD_SCALE, name


def test_ulysses_mask_reaches_only_the_unfused_form(ws1):
    q = torch.zeros((1, 4, 16, 8))
    with pytest.raises(ValueError, match="causal masks only"):
        tpar.ulysses_attention(q, q, q, ws1, fused=True, mask=torch.ones((16, 16), dtype=bool))


def test_ulysses_world_size_1_is_plain_attention(ws1):
    *arrays, mask = W.ulysses_inputs()
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = tpar.ulysses_attention(q, k, v, ws1, mask=torch.from_numpy(mask))
    want = _dense_oracle(*(jnp.asarray(a) for a in arrays), mask=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- ring flash ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_jax_and_the_oracle(ranks, jmesh, causal):
    arrays = W.flash_inputs()
    out, grads = _jax_grads(
        lambda q, k, v: jpar.ring_flash_attention(q, k, v, jmesh, causal=causal), arrays)
    sc = 1.0 / np.sqrt(arrays[0].shape[-1])
    ref, oracle = _jax_grads(lambda q, k, v: _reference_attention(q, k, v, causal, sc), arrays)
    got = ranks[f"ring_flash_{causal}"]
    assert _scale_err(got, out) < OUT_SCALE
    assert _scale_err(got, ref) < OUT_SCALE
    for name, g, o in zip("qkv", grads, oracle):
        mine = ranks[f"ring_flash_{causal}_grad_{name}"]
        assert _scale_err(mine, g) < GRAD_SCALE, name
        assert _scale_err(mine, o) < GRAD_SCALE, name


def test_ring_flash_preserves_bf16(ranks, jmesh):
    assert str(ranks["ring_flash_bf16_dtype"]) == "torch.bfloat16"
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in W.flash_inputs())
    want = jax.jit(lambda *a: jpar.ring_flash_attention(*a, jmesh))(q, k, v)
    assert want.dtype == jnp.bfloat16
    assert _scale_err(ranks["ring_flash_bf16"], np.asarray(want, np.float32)) < BF16_SCALE


def test_ring_flash_sends_three_hops_of_its_kv_block(ranks):
    """Forward: P - 1 hops, each this rank's (k, v) block."""
    b, h, s, d = W.FLASH_SHAPE
    assert int(ranks["ring_bytes"]) == (W.WORLD - 1) * 2 * b * h * (s // W.WORLD) * d * 4


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_and_fused_ulysses_at_world_size_1_are_flash_attention_diff(ws1, causal):
    """One block, the same kernel calls: equal bit for bit, o and every
    gradient, and nothing sent."""
    before = tpar.p2p_bytes()
    outs = {}
    for name, fn in (("ring", lambda q, k, v: tpar.ring_flash_attention(q, k, v, ws1,
                                                                        causal=causal)),
                     ("ulysses", lambda q, k, v: tpar.ulysses_attention(
                         q, k, v, ws1, fused=True, causal=causal)),
                     ("diff", lambda q, k, v: flash_attention_diff(q, k, v, causal))):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in W.flash_inputs())
        o = fn(q, k, v)
        o.square().sum().backward()
        outs[name] = (o.detach(), q.grad, k.grad, v.grad)
    for name in ("ring", "ulysses"):
        for got, want in zip(outs[name], outs["diff"]):
            assert torch.equal(got, want), name
    assert tpar.p2p_bytes() == before


def test_shape_errors(ranks):
    assert "must divide" in str(ranks["error_ulysses_heads"])
    assert "must divide" in str(ranks["error_ring_flash_seq"])
    assert "must divide" in str(ranks["error_band_seq"])
