"""Parity of the port's GPT decoder (tpusparse_torch.models.gpt) and its
int8 serving twin (tpusparse_torch.models.serving) with the JAX package's,
on the 2-layer, 64-wide fixture of tests/test_gpt.py, the flax parameters
carried across by `convert.load_flax_params`.

Tolerances:
  - the fp32 model (forward, prefill and its cache, decode at every
    position): rtol 1e-4, atol 5e-5, the JAX suite's fp32 tier; `generate`:
    the same tokens;
  - `fused=True` (the causal flash kernels) against JAX's fused forward:
    rtol 2e-3, atol 2e-3, the bound of tests/test_gpt.py:79;
  - `quantize_gpt`: the int8 weights, scales and biases, and the bf16
    embeddings, exactly. The int8 KV cache of a prefill quantizes k and v,
    which both sides compute in fp32 in other orders: its scales within
    rtol 1e-5, its int8 values within 1 (a value an ulp from a rounding
    boundary may round apart);
  - `QuantizedGPT` logits: within 1e-4 of scale. Both sides multiply the
    same bf16-rounded operands exactly and sum in fp32, in other orders; an
    activation that lands an ulp apart may round to the neighbouring bf16
    value, 2^-8 of it, and the int8 cache appends may round apart the same
    way. Its `generate`: the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.models import GPTDecoder as JGPT
from tpusparse.models import generate as jgenerate
from tpusparse.models import quantize_gpt as jquantize_gpt

import tpusparse_torch as tt
from tpusparse_torch import kernels

TOL = dict(rtol=1e-4, atol=5e-5)
FUSED_TOL = dict(rtol=2e-3, atol=2e-3)
QUANT_TOL = 1e-4  # of scale
CFG = dict(num_layers=2, hidden=64, num_heads=4, intermediate=128, vocab_size=50,
           max_position=32)


@pytest.fixture(scope="module")
def small():
    """(JAX model, its params, port model with the same weights, ids)."""
    m = JGPT(**CFG)
    ids = np.random.default_rng(0).integers(0, 50, (2, 8)).astype(np.int32)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    port = tt.GPTDecoder(**CFG, device="cpu")
    tt.load_flax_params(port, jax.tree_util.tree_map(np.asarray, params))
    return m, params, port, ids


def _t(ids) -> torch.Tensor:
    return torch.from_numpy(np.asarray(ids, np.int64))


def _over_scale(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_params_carry_across(small):
    _, params, port, _ = small
    back = tt.to_flax_params(port)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_forward_and_prefill_match_jax(small):
    m, params, port, ids = small
    with torch.no_grad():
        logits = port(_t(ids))
        lp, (ck, cv) = port.prefill(_t(ids[:, :4]))
    torch.testing.assert_close(logits, torch.from_numpy(np.array(m.apply(params, ids))), **TOL)
    jlp, (jck, jcv) = m.apply(params, ids[:, :4], method=JGPT.prefill)
    torch.testing.assert_close(lp, torch.from_numpy(np.array(jlp)), **TOL)
    assert len(ck) == 2 and ck[0].shape == (2, 4, 32, 16)
    for got, want in zip(ck + cv, jck + jcv):
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def test_decode_every_position_matches_jax(small):
    """The KV-cache gate: token-by-token decode against the cache matches
    JAX's decode_step and the full causal forward at every position."""
    m, params, port, ids = small
    with torch.no_grad():
        _, cache = port.prefill(_t(ids[:, :4]))
    _, jcache = m.apply(params, ids[:, :4], method=JGPT.prefill)
    for pos in range(4, 8):
        with torch.no_grad():
            lg, cache = port.decode_step(_t(ids[:, pos]), cache, pos)
            full = port(_t(ids[:, : pos + 1]))[:, -1, :]
        jlg, jcache = m.apply(params, ids[:, pos], jcache, pos, method=JGPT.decode_step)
        torch.testing.assert_close(lg, torch.from_numpy(np.array(jlg)), **TOL)
        torch.testing.assert_close(lg, full, rtol=2e-4, atol=2e-5)  # tests/test_gpt.py:52


def test_generate_matches_jax(small):
    m, params, port, ids = small
    got = tt.generate(port, _t(ids[:, :4]), 5)
    want = np.asarray(jgenerate(m, params, jnp.asarray(ids[:, :4]), 5))
    assert got.shape == (2, 5) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exceeds max_position"):
        tt.generate(port, _t(ids[:, :4]), 29)


def test_fused_forward_matches_jax(small):
    """fused=True runs the causal flash kernels (their plain versions here):
    one flash_fwd per layer on the card, none on the CPU."""
    _, params, port, _ = small
    ids = np.random.default_rng(1).integers(0, 50, (1, 32)).astype(np.int32)
    fused = tt.GPTDecoder(**CFG, fused=True, device="cpu")
    fused.load_state_dict(port.state_dict())
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = fused(_t(ids))
    assert not any(kernels.launches_by_kernel().values())
    want = JGPT(**CFG, fused=True).apply(params, ids)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **FUSED_TOL)
    torch.testing.assert_close(got, port(_t(ids)).detach(), **FUSED_TOL)


@pytest.fixture(scope="module")
def quantized(small):
    m, params, port, ids = small
    return tt.quantize_gpt(port), jquantize_gpt(m, params)


def _lin_equal(lin, jlin):
    for name in ("qw", "sw", "b"):
        assert np.array_equal(getattr(lin, name).numpy(), np.asarray(getattr(jlin, name))), name


def test_quantize_gpt_equals_jax(quantized):
    qm, jqm = quantized
    for blk, jblk in zip(qm.blocks, jqm.blocks):
        for name in ("qkv", "o", "fc1", "fc2"):
            _lin_equal(getattr(blk, name), getattr(jblk, name))
        for ln, jln in ((blk.ln1, jblk.ln1), (blk.ln2, jblk.ln2)):
            assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(ln, jln))
        assert blk.qkv.qw.dtype == torch.int8 and blk.qkv.qw.shape == (64, 192)
    _lin_equal(qm.lm_head, jqm.lm_head)
    for emb, jemb in ((qm.tok_emb, jqm.tok_emb), (qm.pos_emb, jqm.pos_emb)):
        assert emb.dtype == torch.bfloat16
        assert np.array_equal(emb.float().numpy(), np.asarray(jemb, np.float32))


def test_quantized_prefill_and_decode_match_jax(quantized, small):
    qm, jqm = quantized
    ids = small[3]
    with torch.no_grad():
        lg, cache = qm.prefill(_t(ids[:, :4]))
    jlg, jcache = jqm.prefill(jnp.asarray(ids[:, :4]))
    assert _over_scale(lg, jlg) < QUANT_TOL
    # the port keeps the head-major layout at every batch; JAX's batch-2
    # cache is flat (b, L, h·d): the same int8 values, within 1
    for (kq, ks, vq, vs), (jkq, jks, jvq, jvs) in zip(cache, jcache):
        assert kq.dtype == torch.int8 and kq.shape == (2, 4, 32, 16) and ks.shape == (2, 4)
        for got, want in ((kq, jkq), (vq, jvq)):
            flat = got.transpose(1, 2).reshape(2, 32, 64).numpy().astype(np.int32)
            assert np.abs(flat - np.asarray(want, np.int32)).max() <= 1
        np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-5)
        np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=1e-5)
    for pos in range(4, 8):
        with torch.no_grad():
            lg, cache = qm.decode_step(_t(ids[:, pos]), cache, pos)
        jlg, jcache = jqm.decode_step(jnp.asarray(ids[:, pos]), jcache, pos)
        assert _over_scale(lg, jlg) < QUANT_TOL, pos


def test_quantized_generate_matches_jax(quantized, small):
    qm, jqm = quantized
    ids = small[3]
    got = qm.generate(_t(ids[:, :4]), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jqm.generate(jnp.asarray(ids[:, :4]), 6)))
    with pytest.raises(ValueError, match="exceeds max_position"):
        qm.generate(_t(ids[:, :4]), 29)


def test_quantized_tracks_float_model(quantized, small):
    """The serving tier's honest error class against the fp32 model
    (tests/test_serving.py: 5e-2 on the prefill, 8e-2 per decode step)."""
    qm, _ = quantized
    port, ids = small[2], small[3]
    with torch.no_grad():
        lg, cache = qm.prefill(_t(ids[:, :4]))
        assert _over_scale(lg, port(_t(ids[:, :4]))) < 5e-2
        for pos in range(4, 8):
            lg, cache = qm.decode_step(_t(ids[:, pos]), cache, pos)
            assert _over_scale(lg, port(_t(ids[:, : pos + 1]))[:, -1]) < 8e-2


def test_quantized_gpt_owns_its_tensors():
    """quantize_gpt copies: updating the float model afterwards leaves the
    serving artifact as it was."""
    model = tt.GPTDecoder(**CFG, device="cpu")
    qm = tt.quantize_gpt(model)
    before = [t.clone() for t in (qm.final_ln[0], qm.lm_head.b, qm.blocks[0].ln1[1])]
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    after = (qm.final_ln[0], qm.lm_head.b, qm.blocks[0].ln1[1])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
