"""Parity of the port's attention over an int8 K/V cache (`quantize_kv`,
`flash_attention_q8` and the plain version of its kernel in
tpusparse_torch.kernels.flash_attention) with the JAX package's: the same
numpy inputs go through both; the JAX side runs its Pallas kernel in
interpret mode, the port its plain PyTorch version.

Tolerances:
  - `quantize_kv`: exact;
  - the port rounds q and p to bf16 before their products, the 'default'
    tier at which `Precision.DEFAULT` runs on the TPU; JAX's CPU run keeps
    both in fp32. With q given as bf16-representable values the two differ
    only by p's rounding, one bf16 ulp (2^-9 relative) per probability:
    within 2e-3 of scale; with any fp32 q, by q's rounding too: within 1e-2
    (the rounded-tier limit of the card checks);
  - against a float64 softmax of the same bf16-rounded operands: within
    1e-2 of scale with p unrounded; within 5e-4 with p rounded to bf16 at
    the row max as the plain version rounds it (where the fp32 and float64
    exp differ by an ulp, a rare p rounds to the neighbouring bf16 value,
    2^-8 of it; measured 6.8e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import flash_attention as jfa

import tpusparse_torch as tt
from tpusparse_torch.kernels import flash_attention as tfa

P_ROUNDING_TOL = 2e-3
ROUNDED_TOL = 1e-2


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _over_scale(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _kv(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return q, k, v


def _quantized(k, v):
    """(port (kq, ks, vq, vs), JAX's) of the same k, v."""
    return (tt.quantize_kv(torch.from_numpy(k), torch.from_numpy(v)),
            jfa.quantize_kv(jnp.asarray(k), jnp.asarray(v)))


def test_quantize_kv_equals_jax():
    q, k, v = _kv((2, 3, 64, 32), 0)
    k[1, 2] = 0.0  # an all-zero head: scale 1
    v[0, 1, :, :5] = np.round(v[0, 1, :, :5] * 4) / 4  # quarter steps
    port, jax_ = _quantized(k, v)
    for got, want in zip(port, jax_):
        assert np.array_equal(got.numpy(), np.asarray(want))
    kq, ks, vq, vs = port
    assert kq.dtype == vq.dtype == torch.int8 and ks.dtype == vs.dtype == torch.float32
    assert ks.shape == (2, 3) and float(ks[1, 2]) == 1.0 and not kq[1, 2].any()


def _oracle(q, kq, ks, vq, vs, causal, sm_scale, round_p=False):
    """float64 masked softmax attention of bf16-rounded q over the int8
    cache, the scales applied as the kernel applies them."""
    qd = _bf16(q).astype(np.float64)
    sc = np.einsum("...qd,...kd->...qk", qd, kq.numpy().astype(np.float64))
    sc = sc * (np.float32(sm_scale) * ks.numpy().astype(np.float64))[..., None, None]
    s = q.shape[-2]
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True)
    if round_p:
        p = _bf16(p.astype(np.float32)).astype(np.float64)
    o = np.einsum("...qk,...kd->...qd", p, vq.numpy().astype(np.float64)) / l
    return o * vs.numpy()[..., None, None]


@pytest.mark.parametrize("shape,causal", [((1, 2, 256, 64), False), ((1, 1, 128, 64), True)])
def test_plain_matches_jax(shape, causal):
    q, k, v = _kv(shape, 1)
    (kq, ks, vq, vs), (jkq, jks, jvq, jvs) = _quantized(k, v)
    for qx, tol in ((_bf16(q), P_ROUNDING_TOL), (q, ROUNDED_TOL)):
        got = tt.flash_attention_q8(torch.from_numpy(qx), kq, ks, vq, vs, causal=causal)
        want = jfa.flash_attention_q8(jnp.asarray(qx), jkq, jks, jvq, jvs, causal=causal)
        assert got.dtype == torch.float32 and got.shape == shape
        assert _over_scale(got, want) < tol


@pytest.mark.parametrize("shape,causal", [((1, 2, 256, 64), False), ((2, 1, 200, 40), True)])
def test_plain_matches_float64_of_rounded_operands(shape, causal):
    q, k, v = _kv(shape, 2)
    kq, ks, vq, vs = tt.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    sm_scale = 1 / shape[-1] ** 0.5
    got = tt.flash_attention_q8(torch.from_numpy(q), kq, ks, vq, vs, causal=causal)
    assert _over_scale(got, _oracle(q, kq, ks, vq, vs, causal, sm_scale)) < ROUNDED_TOL
    exact_p = _oracle(q, kq, ks, vq, vs, causal, sm_scale, round_p=True)
    assert _over_scale(got, exact_p) < 5e-4


def test_bf16_q_matches_jax():
    q, k, v = _kv((1, 2, 128, 64), 3)
    (kq, ks, vq, vs), (jkq, jks, jvq, jvs) = _quantized(k, v)
    got = tt.flash_attention_q8(torch.from_numpy(q).bfloat16(), kq, ks, vq, vs, causal=True)
    want = jfa.flash_attention_q8(jnp.asarray(q, jnp.bfloat16), jkq, jks, jvq, jvs, causal=True)
    assert got.dtype == torch.bfloat16
    assert _over_scale(got, np.asarray(want, np.float32)) < ROUNDED_TOL


def test_rows_that_see_no_key_give_zero():
    """Causal with kv_offset 200 over s = 256, the JAX kernel at 128-row
    tiles: rows 0-127 skip every tile, and JAX gives them 0 as the port does;
    rows 128-199 see no key in the one tile they visit, where JAX gives the
    mean of vs·vq over that tile's 128 keys (exp(-1e30 - (-1e30)) = 1) and
    the port 0. Rows 200-255 agree (ROADMAP section 3)."""
    q, k, v = _kv((1, 1, 256, 64), 4)
    (kq, ks, vq, vs), (jkq, jks, jvq, jvs) = _quantized(k, v)
    q = _bf16(q)
    got = tt.flash_attention_q8(torch.from_numpy(q), kq, ks, vq, vs, causal=True,
                                kv_offset=200).numpy()
    want = np.asarray(jfa.flash_attention_q8(jnp.asarray(q), jkq, jks, jvq, jvs, causal=True,
                                             kv_offset=200, block_q=128, block_k=128))
    assert not got[..., :200, :].any()
    assert not want[..., :128, :].any()
    mean_v = (vq[..., :128, :].double().mean(-2) * float(vs.reshape(-1)[0])).numpy()
    np.testing.assert_allclose(want[0, 0, 128:200], np.broadcast_to(mean_v[0, 0], (72, 64)),
                               rtol=1e-5, atol=1e-6)
    assert _over_scale(got[..., 200:, :], want[..., 200:, :]) < P_ROUNDING_TOL


def test_q_offset_chunk_matches_jax():
    """Rows 256:512 of a causal attention over keys 0:256 (a chunk with
    q_offset 256): every row sees keys."""
    q, k, v = _kv((1, 2, 256, 64), 5)
    (kq, ks, vq, vs), (jkq, jks, jvq, jvs) = _quantized(k, v)
    q = _bf16(q)
    got = tt.flash_attention_q8(torch.from_numpy(q), kq, ks, vq, vs, causal=True, q_offset=256)
    want = jfa.flash_attention_q8(jnp.asarray(q), jkq, jks, jvq, jvs, causal=True, q_offset=256)
    assert _over_scale(got, want) < P_ROUNDING_TOL


def test_guards_raise_as_jax_does():
    q = torch.zeros((1, 2, 64, 32))
    kq = torch.zeros((1, 2, 64, 32), dtype=torch.int8)
    s = torch.ones((1, 2))
    with pytest.raises(ValueError, match="shapes differ"):
        tt.flash_attention_q8(q, kq[:, :, :32], s, kq, s)
    with pytest.raises(TypeError, match="int8"):
        tt.flash_attention_q8(q, kq.float(), s, kq, s)
    with pytest.raises(ValueError, match="leading shape"):
        tt.flash_attention_q8(q, kq, s.reshape(2), kq, s)
    wide = torch.zeros((1, 64, 160))  # any head dim, as JAX takes it
    assert tt.flash_attention_q8(wide, wide.to(torch.int8), torch.ones(1), wide.to(torch.int8),
                                 torch.ones(1)).shape == wide.shape
    tfa.reset_launch_counts()
    o = tt.flash_attention_q8(q, kq, s, kq, s, block_q=64, block_k=32)  # knobs ignored
    assert o.shape == q.shape and tfa.launch_counts()["flash_q8"] == 0
