"""Parity of the port's block-pattern attention (tpusparse_torch.kernels.
block_flash_attention) with the JAX package's: `BlockAttnPlan`'s arrays, and
the forward, dq and dk/dv on the same numpy inputs. The JAX side runs its
Pallas kernels in interpret mode, the port its plain PyTorch versions (the
wrappers take them for CPU tensors).

Tolerances:
  - fp32 tier ('high'): rtol 1e-4, atol 5e-5, the JAX suite's own;
  - gradients of `block_flash_attention_diff` against `jax.grad`: max-abs
    error within 2e-4 of the largest gradient (tests/test_attention.py:179);
  - 'default' tier: the port rounds every product's operands to bf16, what
    the TPU's DEFAULT dot does; JAX on the CPU multiplies in full fp32
    there, so the reference is a float64 masked softmax of bf16-rounded
    q, k, v (within 1e-2 of scale: p is rounded to bf16 as well);
  - bf16 inputs against JAX's bf16: outputs one bf16 ulp (2^-8..2^-7)
    apart, within 1e-2 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import flash_attention as jfa
from tpusparse.nn import bigbird_block_mask as j_bigbird_block_mask
from tpusparse.nn import bigbird_pattern as j_bigbird_pattern
from tpusparse.nn import local_global_pattern as j_local_global_pattern

from tpusparse_torch.kernels import block_flash_attention as tbf

TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_TOL = 2e-4
ROUNDED_TOL = 1e-2
PLAN_ARRAYS = ("kv_list", "kv_cnt", "q_list", "q_cnt", "tile_masks", "q_slot", "block_mask")


def _plans(name):
    """(JAX plan, port plan) of one named pattern, built from the same arrays."""
    if name.startswith("block_"):  # a block mask: mask-free by construction
        s, b = {"block_bigbird_256_b64": (256, 64), "block_bigbird_256_b32": (256, 32),
                "block_sparse_160_b64": (160, 64)}[name]
        mask = (j_bigbird_block_mask(s, b, 3, 1, 1, seed=2) if s == 256
                else np.array([[1, 0, 1], [0, 1, 0], [1, 0, 0]], bool))
        return jfa.BlockAttnPlan(mask, b, b, s), tbf.BlockAttnPlan(mask, b, b, s)
    s, bq, bk, (ind, ptr) = {
        # a band that fills its diagonal blocks only in part: tile masks
        "tokens_band_256_b64": (256, 64, 64, j_local_global_pattern(256, 20, 3)),
        # unequal blocks and s not a multiple of either
        "tokens_band_160_b64x32": (160, 64, 32, j_local_global_pattern(160, 20, 3)),
        # full blocks: the mask-free kernels
        "tokens_bigbird_256_b64": (256, 64, 64, j_bigbird_pattern(256, 64, 1, 1, 1, seed=0)),
        # a band without global keys: rows past the band's start find the first
        # sub-tile of their q-block's list wholly masked
        "tokens_band_first_empty_256_b64": (256, 64, 64, j_local_global_pattern(256, 20, 0)),
    }[name]
    return (jfa.BlockAttnPlan.from_token_pattern(ind, ptr, s, bq, bk),
            tbf.BlockAttnPlan.from_token_pattern(ind, ptr, s, bq, bk))


PLAN_NAMES = ["block_bigbird_256_b64", "block_bigbird_256_b32", "block_sparse_160_b64",
              "tokens_band_256_b64", "tokens_band_160_b64x32", "tokens_bigbird_256_b64",
              "tokens_band_first_empty_256_b64"]


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_plan_arrays_equal_jax(name):
    jplan, tplan = _plans(name)
    for attr in PLAN_ARRAYS:
        want, got = getattr(jplan, attr), getattr(tplan, attr)
        if want is None:
            assert got is None, attr
        else:
            assert got.dtype == want.dtype, attr
            np.testing.assert_array_equal(got, want, err_msg=attr)
    for attr in ("L", "Lt", "nq", "nk", "block_q", "block_k", "seq", "token_nnz",
                 "density", "padding_ratio"):
        assert getattr(tplan, attr) == getattr(jplan, attr), attr


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_token_mask_is_the_pattern(name):
    """The plan's token-exact (s, s) mask: the tiles a JAX plan covers,
    narrowed by its tile masks (as tests/test_attention.py:605 rebuilds it)."""
    jplan, tplan = _plans(name)
    s, bq, bk = jplan.seq, jplan.block_q, jplan.block_k
    want = np.zeros((jplan.nq * bq, jplan.nk * bk), bool)
    for i in range(jplan.nq):
        for l in range(int(jplan.kv_cnt[i])):
            j = jplan.kv_list[i, l]
            tile = (np.ones((bq, bk), bool) if jplan.tile_masks is None
                    else jplan.tile_masks[i * jplan.L + l] != 0)
            want[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk] = tile
    np.testing.assert_array_equal(tplan.token_mask_np(), want[:s, :s])
    assert torch.equal(tplan.token_mask("cpu"), torch.from_numpy(want[:s, :s]))


def test_plan_guards_raise_as_jax_does():
    cases = [
        (lambda m: m.BlockAttnPlan(np.ones((2, 2), bool), 64, 64, 256), "cover"),
        # q-block 2 attends to nothing
        (lambda m: m.BlockAttnPlan(np.repeat((np.arange(4) != 2)[:, None], 4, axis=1),
                                   64, 64, 256), "at least one kv block"),
        (lambda m: m.BlockAttnPlan.from_token_pattern(
            np.array([0, 1], np.int32), np.array([0, 2, 2, 2, 2], np.int32), 4, 64, 64),
         "at least one key"),
        (lambda m: m.BlockAttnPlan.from_token_pattern(
            np.array([0], np.int32), np.array([0, 1], np.int32), 4, 64, 64), "covers 1 rows"),
    ]
    for build, match in cases:
        messages = []
        for mod in (jfa, tbf):
            with pytest.raises(ValueError, match=match) as err:
                build(mod)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


# -- forward, dq and dk/dv against the JAX kernels --------------------------------

# name: (plan name, bh, d)
KERNEL_CASES = {
    "maskfree_160_b64": ("block_sparse_160_b64", 2, 32),
    "masked_256_b64": ("tokens_band_256_b64", 2, 64),
    "masked_160_b64x32": ("tokens_band_160_b64x32", 3, 24),
    "bigbird_256_b64": ("block_bigbird_256_b64", 2, 64),
    # the plan kinds the tensor-core kernels tile apart: blocks of 32 (half
    # of each 64-row tile idle), rows whose first listed sub-tile is wholly
    # masked, and a token pattern of full blocks at the widest tensor-core d
    "bigbird_256_b32": ("block_bigbird_256_b32", 2, 32),
    "masked_first_empty_256_b64": ("tokens_band_first_empty_256_b64", 2, 32),
    "tokens_bigbird_256_b64_d128": ("tokens_bigbird_256_b64", 1, 128),
    # head dims above 128, where the card runs the wide teams: S wider than
    # one slice (136), beyond one 256-wide instance (320), and 512-wide
    # chunks of the output (640); mask-free and tile-masked plans
    "wide_maskfree_160_b64_d136": ("block_sparse_160_b64", 2, 136),
    "wide_masked_160_b64x32_d136": ("tokens_band_160_b64x32", 2, 136),
    "wide_bigbird_256_b32_d320": ("block_bigbird_256_b32", 1, 320),
    "wide_masked_first_empty_256_b64_d320": ("tokens_band_first_empty_256_b64", 2, 320),
    "wide_maskfree_160_b64_d640": ("block_sparse_160_b64", 1, 640),
    "wide_masked_160_b64x32_d640": ("tokens_band_160_b64x32", 1, 640),
}


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _over_scale(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_forward_and_backward_match_jax(name):
    plan_name, bh, d = KERNEL_CASES[name]
    jplan, tplan = _plans(plan_name)
    q, k, v, do = _inputs((bh, jplan.seq, d), seed=len(name))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa.block_flash_attention(jq, jk, jv, jplan, return_lse=True)
    jgrads = jfa.block_flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, jplan)
    to, tlse = tbf.block_flash_attention(_t(q), _t(k), _t(v), tplan, return_lse=True)
    assert to.dtype == torch.float32 and tlse.shape == (bh, jplan.seq)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    # the backward from the same o, lse and do as JAX's
    tgrads = tbf.block_flash_attention_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), tplan)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=gname)


@pytest.mark.parametrize("name", ["maskfree_160_b64", "masked_160_b64x32"])
def test_diff_grads_match_jax_grad(name):
    """All three gradients of `block_flash_attention_diff` (the autograd
    Function over the dq and dk/dv wrappers) against `jax.grad`, with
    leading dims (b, h) flattened by the wrappers."""
    plan_name, bh, d = KERNEL_CASES[name]
    jplan, tplan = _plans(plan_name)
    q, k, v = _inputs((1, bh, jplan.seq, d), seed=11, n=3)
    want = jax.grad(
        lambda *a: jnp.sum(jfa.block_flash_attention_diff(*a, jplan) ** 2), argnums=(0, 1, 2),
    )(*map(jnp.asarray, (q, k, v)))
    ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
    tbf.block_flash_attention_diff(*ts, tplan).square().sum().backward()
    for gname, t, w in zip(("dq", "dk", "dv"), ts, want):
        assert t.grad.shape == t.shape
        assert _over_scale(t.grad, w) < GRAD_TOL, gname


def test_sm_scale_multiplies_the_product():
    """A custom sm_scale on the mask-free and masked plans."""
    for plan_name in ("block_sparse_160_b64", "tokens_band_256_b64"):
        jplan, tplan = _plans(plan_name)
        q, k, v = _inputs((2, jplan.seq, 16), seed=5, n=3)
        jo = jfa.block_flash_attention(*map(jnp.asarray, (q, k, v)), jplan, sm_scale=0.3)
        to = tbf.block_flash_attention(_t(q), _t(k), _t(v), tplan, sm_scale=0.3)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def _rounded_oracle(q, k, v, mask, sm_scale):
    """float64 masked softmax attention of bf16-rounded operands."""
    r = [torch.from_numpy(x).bfloat16().double() for x in (q, k, v)]
    sc = (r[0] @ r[1].transpose(-1, -2)) * sm_scale
    sc = sc.masked_fill(~torch.from_numpy(mask), -torch.inf)
    return torch.softmax(sc, -1) @ r[2]


@pytest.mark.parametrize("plan_name", ["block_sparse_160_b64", "tokens_band_160_b64x32"])
def test_default_tier_rounds_operands_to_bf16(plan_name):
    """'default' on fp32 inputs: every product's operands rounded to bf16, fp32
    sums. Held against the float64 softmax of the bf16-rounded operands; the
    fp32 tier differs from it by more than the rounding shows."""
    _, tplan = _plans(plan_name)
    q, k, v, do = _inputs((2, tplan.seq, 32), seed=13)
    scale = 32 ** -0.5
    ref = _rounded_oracle(q, k, v, tplan.token_mask_np(), scale)
    o, lse = tbf.block_flash_attention(_t(q), _t(k), _t(v), tplan, return_lse=True,
                                       precision="default")
    assert _over_scale(o, ref) < ROUNDED_TOL
    o_high = tbf.block_flash_attention(_t(q), _t(k), _t(v), tplan, precision="high")
    assert _over_scale(o, o_high) > 1e-4
    # the backward on the rounded operands against float64 autograd of the oracle
    leaves = [torch.from_numpy(x).bfloat16().double().requires_grad_(True) for x in (q, k, v)]
    sc = (leaves[0] @ leaves[1].transpose(-1, -2)) * scale
    sc = sc.masked_fill(~torch.from_numpy(tplan.token_mask_np()), -torch.inf)
    (torch.softmax(sc, -1) @ leaves[2]).backward(torch.from_numpy(do).bfloat16().double())
    grads = tbf.block_flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), tplan,
                                          precision="default")
    for gname, got, leaf in zip(("dq", "dk", "dv"), grads, leaves):
        assert _over_scale(got, leaf.grad) < ROUNDED_TOL, gname


def test_bf16_inputs_match_jax():
    jplan, tplan = _plans("tokens_band_256_b64")
    q, k, v, do = _inputs((2, 256, 32), seed=17)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = jfa.block_flash_attention(jq, jk, jv, jplan, return_lse=True)
    jgrads = jfa.block_flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, jplan)
    bf = torch.bfloat16
    to, tlse = tbf.block_flash_attention(_t(q, bf), _t(k, bf), _t(v, bf), tplan,
                                         return_lse=True)
    assert to.dtype == bf and tlse.dtype == torch.float32
    assert _over_scale(to, np.asarray(jo, np.float32)) < ROUNDED_TOL
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    tgrads = tbf.block_flash_attention_bwd(
        _t(q, bf), _t(k, bf), _t(v, bf), _t(np.asarray(jo, np.float32), bf), _t(jlse),
        _t(do, bf), tplan)
    for gname, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == bf
        assert _over_scale(got, np.asarray(want, np.float32)) < ROUNDED_TOL, gname


def test_rows_of_a_partial_tile_that_see_no_key_there_stay_exact():
    """A q-block whose first listed kv block holds none of some rows' keys:
    row i sees keys [i - 8, i], so q-block 1 lists kv blocks 0 and 1, and
    rows 72-127 see nothing in block 0. Their probabilities there are
    exactly 0 (not exp(0) = 1), so o is the masked softmax over their keys."""
    s = 192
    rows = np.arange(s)
    allowed = (rows[None, :] <= rows[:, None]) & (rows[None, :] >= rows[:, None] - 8)
    ind = np.nonzero(allowed)[1].astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(allowed.sum(1))]).astype(np.int32)
    plan = tbf.BlockAttnPlan.from_token_pattern(ind, ptr, s, 64, 64)
    assert plan.tile_masks is not None and plan.kv_cnt.tolist() == [1, 2, 2]
    q, k, v = _inputs((1, s, 16), seed=23, n=3)
    sc = (torch.from_numpy(q).double() @ torch.from_numpy(k).double().mT) * 0.25
    sc = sc.masked_fill(~torch.from_numpy(allowed), -torch.inf)
    ref = torch.softmax(sc, -1) @ torch.from_numpy(v).double()
    got = tbf.block_flash_attention(_t(q), _t(k), _t(v), plan)
    assert _over_scale(got, ref) < 1e-5


def test_wrappers_check_operands_and_launch_nothing_on_cpu():
    _, plan = _plans("block_sparse_160_b64")
    q, k, v, do = (_t(x) for x in _inputs((2, 160, 24), seed=31))
    kw = dict(sm_scale=0.2)
    with pytest.raises(TypeError, match="dtype"):
        tbf.blk_flash_fwd_kernel(q.double(), k.double(), v.double(), plan, **kw)
    with pytest.raises(TypeError, match="one type"):
        tbf.blk_flash_fwd_kernel(q, k.bfloat16(), v, plan, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tbf.blk_flash_fwd_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, plan,
                                 **kw)
    with pytest.raises(ValueError, match=r"\(bh, s, d\)"):
        tbf.blk_flash_fwd_kernel(q[None], k[None], v[None], plan, **kw)
    with pytest.raises(ValueError, match="plan is for seq 160"):
        tbf.blk_flash_fwd_kernel(q[:, :128].contiguous(), k[:, :128].contiguous(),
                                 v[:, :128].contiguous(), plan, **kw)
    z = torch.zeros(1, 160, 130)  # a head dim above 128 is no longer refused
    assert tbf.block_flash_attention(z, z, z, plan).shape == (1, 160, 130)
    with pytest.raises(ValueError, match="shapes differ"):
        tbf.block_flash_attention(q, k, v[..., :8], plan)
    tbf.reset_launch_counts()
    o, lse = tbf.blk_flash_fwd_kernel(q, k, v, plan, **kw)
    delta = (do * o).sum(-1)
    with pytest.raises(TypeError, match="lse"):
        tbf.blk_flash_dq_kernel(q, k, v, do, lse.double(), delta, plan, **kw)
    tbf.blk_flash_dq_kernel(q, k, v, do, lse, delta, plan, **kw)
    tbf.blk_flash_dkv_kernel(q, k, v, do, lse, delta, plan, **kw)
    assert tbf.launch_counts() == {"blk_flash_fwd": 0, "blk_flash_dq": 0, "blk_flash_dkv": 0}
