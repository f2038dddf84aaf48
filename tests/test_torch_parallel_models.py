"""Parity of the port's sharded models (tpusparse_torch.parallel's bert,
pipeline, moe and serving, and its dry run) with the JAX package's.

The port runs as 4 processes on a gloo group (`torch_parallel_worker.py`
'models', launched once for the module) from parameters carried out of
JAX: the BERT layers and encoder and the GPT through
`convert.load_flax_params`, the MoE dict through `convert.load_moe_params`,
the pipeline stages through `convert.load_stage_params`. The JAX side runs
the same functions on 4 CPU devices, its flash kernels in interpret mode.
The world-size-1 cases run the port in this process against its one-rank
form.

Tolerances: the fp32 tier (rtol 1e-4, atol 5e-5) for the BERT, pipeline
and MoE outputs and gradients; TP decode
logits within 5e-3 of scale (tests/test_serving.py:110-111) and the int8
cache exactly against the port's one-card step (within 1 of JAX's, as the
one-card cache is, test_torch_gpt.py). The gradients are held to the
unsharded oracle's by their ratio, 1 within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tpusparse as ts
import tpusparse.parallel as jpar
from tpusparse.models import BertAttentionLayer as JLayer
from tpusparse.models import BertEncoder as JEncoder
from tpusparse.models import GPTDecoder as JGPT
from tpusparse.models import quantize_gpt as jquantize
from tpusparse.parallel import moe as jmoe

import tpusparse_torch as tt
from tpusparse_torch import parallel as tpar
from tpusparse_torch.convert import load_moe_params, load_stage_params

import torch_parallel_worker as W

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
DECODE_SCALE = 5e-3
RATIO = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    """{'a.b.c': leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jlayer(kind):
    if kind == "encoder":
        model = JEncoder(**W.ENCODER)
        x = jnp.asarray(W.bert_ids().astype(np.int32))
    else:
        model = JLayer(**W.BERT, attention=kind)
        x = jnp.asarray(W.bert_input())
    return model, model.init(jax.random.PRNGKey(0), x), x


def _jmoe_params():
    return jmoe.init_moe_params(jax.random.PRNGKey(0), W.MOE["num_experts"], W.MOE["d_model"],
                                W.MOE["d_hidden"])


def _jgpt():
    m = JGPT(**W.GPT_SMALL)
    ids = jnp.asarray(W.gpt_ids().astype(np.int32))
    params = m.init(jax.random.PRNGKey(0), ids)
    return m, params, ids


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def jax_state():
    inputs = {}
    for kind in ("dense", "flash", "encoder"):
        inputs.update(W.flat_tree(_np_tree(_jlayer(kind)[1])["params"], f"bert_{kind}/"))
    inputs.update(W.flat_tree(_np_tree(_jmoe_params()), "moe/"))
    inputs.update(W.flat_tree(_np_tree(_jgpt()[1])["params"], "gpt/"))
    return inputs


@pytest.fixture(scope="module")
def ranks(jax_state, tmp_path_factory):
    """Rank 0's results of the 'models' group on 4 gloo ranks."""
    return W.launch("models", tmp_path_factory.mktemp("torch_parallel_models"), jax_state)


@pytest.fixture(scope="module")
def ws1():
    tpar.initialize_distributed(device="cpu")
    return tpar.make_mesh(device="cpu")


def _assert_ratio_one(got, want, name) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ratio = float((got * want).sum() / (want * want).sum())
    assert abs(ratio - 1.0) < RATIO, (name, ratio)


# -- Megatron BERT ---------------------------------------------------------------------


def test_param_specs_equal_jax():
    _, params, _ = _jlayer("dense")
    P = jax.sharding.PartitionSpec
    leaves = jax.tree_util.tree_flatten_with_path(jpar.bert_param_specs(params),
                                                  is_leaf=lambda v: isinstance(v, P))[0]
    jspecs = {".".join(k.key for k in path[1:]): spec for path, spec in leaves}
    specs = tpar.bert_param_specs(tt.BertAttentionLayer(**W.BERT, device="cpu"))
    assert set(specs) == set(jspecs)
    for name, spec in specs.items():
        assert P(*spec) == jspecs[name], name
    assert specs["attention.query.kernel"] == ("model", None)
    assert specs["attention.out.kernel"] == (None, "model")
    assert specs["ffn_in.bias"] == ("model",) and specs["ffn_out.bias"] == ()


@pytest.mark.parametrize("kind", ["dense", "flash", "encoder"])
def test_tp_forward_and_grads_match_jax(ranks, kind):
    model, params, x = _jlayer(kind)
    mesh = _jmesh(W.BERT_MESH, ("data", "model"))
    sharded, shardings = jpar.shard_bert_params(params, mesh)
    if kind == "encoder":
        from jax.sharding import NamedSharding, PartitionSpec as P

        fwd = jax.jit(model.apply, in_shardings=(shardings, NamedSharding(mesh, P("data", None))),
                      out_shardings=NamedSharding(mesh, P("data", None, None)))
    else:
        fwd = jpar.make_tp_forward(model, mesh, shardings)
    np.testing.assert_allclose(ranks[f"bert_{kind}"], np.asarray(fwd(sharded, x)), **TOL)
    grads = _flat(_np_tree(jax.grad(lambda p: jnp.mean(fwd(p, x) ** 2))(sharded))["params"])
    for name, g in grads.items():
        np.testing.assert_allclose(ranks[f"bert_{kind}_grad:{name}"], g, **TOL, err_msg=name)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_tp_layer_at_world_size_1_is_the_layer(ws1, attention):
    layer = tt.BertAttentionLayer(**W.BERT, attention=attention, device="cpu",
                                  generator=torch.Generator().manual_seed(4))
    x = torch.from_numpy(W.bert_input())
    local, specs = tpar.shard_bert_params(layer, ws1)
    got = tpar.make_tp_forward(layer, ws1, specs)(local, x)
    tt.bert_loss(got).backward()
    want = layer(x)
    tt.bert_loss(want).backward()
    torch.testing.assert_close(got, want, **TOL)
    for name, p in layer.named_parameters():
        torch.testing.assert_close(local[name].grad, p.grad, **TOL, msg=name)


def test_tp_heads_must_divide(ranks):
    assert "must divide" in str(ranks["error_bert_heads"])


# -- the pipeline ------------------------------------------------------------------------


def _pipe_seq(ws, bs, x):
    h = x
    for s in range(ws.shape[0]):
        h = jax.nn.relu(ts.mm(h, ws[s]) + bs[s])
    return h


def test_pipeline_matches_jax_and_the_sequential_gradient(ranks):
    ws, bs, x = (jnp.asarray(a) for a in W.pipe_inputs())
    mesh = _jmesh((W.WORLD,), ("stage",))

    def jpipe(ws, bs, x):
        return jpar.pipeline_apply(lambda p, h: jax.nn.relu(ts.mm(h, p[0]) + p[1]), (ws, bs), x,
                                   mesh, num_microbatches=W.PIPE["microbatches"])

    np.testing.assert_allclose(ranks["pipe"], np.asarray(jax.jit(jpipe)(ws, bs, x)), **TOL)
    np.testing.assert_allclose(ranks["pipe"], np.asarray(_pipe_seq(ws, bs, x)), **TOL)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jpipe(*a) ** 2), argnums=(0, 1, 2)))(ws, bs, x)
    oracle = jax.grad(lambda *a: jnp.sum(_pipe_seq(*a) ** 2), argnums=(0, 1, 2))(ws, bs, x)
    for name, g, o in zip(("ws", "bs", "x"), grads, oracle):
        np.testing.assert_allclose(ranks[f"pipe_grad_{name}"], np.asarray(g), **TOL)
        _assert_ratio_one(ranks[f"pipe_grad_{name}"], o, name)


def test_pipeline_at_world_size_1_is_the_loop(ws1):
    mesh = tpar.make_mesh((1,), ("stage",), device="cpu")
    ws, bs, x = W.pipe_inputs()
    params = load_stage_params((ws[:1], bs[:1]), device="cpu")
    got = tpar.pipeline_apply(lambda p, h: torch.relu(tt.mm(h, p[0]) + p[1]), params,
                              torch.from_numpy(x), mesh, num_microbatches=4)
    want = torch.relu(tt.mm(torch.from_numpy(x), params[0][0]) + params[1][0])
    torch.testing.assert_close(got, want, **TOL)


def test_pipeline_batch_must_divide(ranks):
    assert "must divide" in str(ranks["error_pipe_batch"])


# -- MoE -----------------------------------------------------------------------------------


def _moe_grads(fn, params, x):
    return jax.jit(jax.grad(lambda p, xx: jnp.sum(fn(p, xx) ** 2), argnums=(0, 1)))(params, x)


@pytest.mark.parametrize("form", ["moe", "moe_a2a"])
def test_moe_matches_jax_and_the_reference_gradient(ranks, form):
    params, x = _jmoe_params(), jnp.asarray(W.moe_x())
    mesh = _jmesh((W.WORLD,), ("expert",))
    cf = float(W.MOE["num_experts"])
    fn = ((lambda p, xx: jmoe.moe_forward(p, xx, mesh)) if form == "moe"
          else (lambda p, xx: jmoe.moe_forward_a2a(p, xx, mesh, capacity_factor=cf)))
    np.testing.assert_allclose(ranks[form], np.asarray(jax.jit(fn)(params, x)), **TOL)
    np.testing.assert_allclose(ranks[form], np.asarray(jmoe.moe_forward_reference(params, x)),
                               **TOL)
    (gp, gx) = _moe_grads(fn, params, x)
    (op, ox) = _moe_grads(jmoe.moe_forward_reference, params, x)
    for name in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(ranks[f"{form}_grad_{name}"], np.asarray(gp[name]), **TOL)
        _assert_ratio_one(ranks[f"{form}_grad_{name}"], op[name], name)
    np.testing.assert_allclose(ranks[f"{form}_grad_x"], np.asarray(gx), **TOL)
    _assert_ratio_one(ranks[f"{form}_grad_x"], ox, "x")


def test_moe_a2a_capacity_drop_matches_jax(ranks):
    params, x = _jmoe_params(), jnp.asarray(W.moe_x())
    mesh = _jmesh((W.WORLD,), ("expert",))
    want = np.asarray(jax.jit(lambda p, xx: jmoe.moe_forward_a2a(p, xx, mesh, capacity_factor=1.0))(
        params, x))
    got = ranks["moe_a2a_drop"]
    np.testing.assert_allclose(got, want, **TOL)
    ref = np.asarray(jmoe.moe_forward_reference(params, x))
    kept = np.isclose(got, ref, **TOL).all(axis=1)
    dropped = (got == 0.0).all(axis=1)
    assert (kept | dropped).all() and kept.any() and dropped.any()
    np.testing.assert_array_equal(dropped, (want == 0.0).all(axis=1))


def test_load_balance_loss_matches_jax(ranks):
    want = float(jmoe.load_balance_loss(_jmoe_params(), jnp.asarray(W.moe_x())))
    np.testing.assert_allclose(float(ranks["moe_balance"]), want, **TOL)


def test_moe_at_world_size_1_is_the_reference(ws1):
    mesh = tpar.make_mesh((1,), ("expert",), device="cpu")
    params = load_moe_params(_np_tree(_jmoe_params()), device="cpu")
    x = torch.from_numpy(W.moe_x())
    want = tpar.moe_forward_reference(params, x)
    torch.testing.assert_close(tpar.moe_forward(params, x, mesh), want, **TOL)
    got = tpar.moe_forward_a2a(params, x, mesh, capacity_factor=float(W.MOE["num_experts"]))
    torch.testing.assert_close(got, want, **TOL)


def test_init_moe_params_shapes_and_range():
    p = tpar.init_moe_params(torch.Generator().manual_seed(0), 4, 16, 32, device="cpu")
    assert p["router"].shape == (16, 4) and p["w_in"].shape == (4, 16, 32)
    assert p["w_out"].shape == (4, 32, 16)
    assert float(p["w_in"].abs().max()) <= 0.25 and float(p["w_out"].abs().max()) <= 32 ** -0.5
    again = tpar.init_moe_params(torch.Generator().manual_seed(0), 4, 16, 32, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_moe_shape_errors(ranks):
    assert "must divide" in str(ranks["error_moe_experts"])
    assert "divisible" in str(ranks["error_moe_a2a_experts"])
    assert "token count" in str(ranks["error_moe_a2a_tokens"])


# -- TP int8 decode -----------------------------------------------------------------------


def _over_scale(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", W.GPT_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_tp_decode_matches_jax_and_one_card(ranks, shape):
    m, params, ids = _jgpt()
    qm = jquantize(m, params)
    _, cache = qm.prefill(ids[:, :4])
    mesh = _jmesh(shape, ("data", "model"))
    qm_s, _ = jpar.shard_qgpt(qm, mesh)
    lg, jcache = jpar.make_tp_decode_step(qm_s, mesh)(ids[:, 4], cache, 4)
    tag = "x".join(map(str, shape))
    assert _over_scale(ranks[f"gpt_tp_{tag}"], lg) < DECODE_SCALE
    assert _over_scale(ranks[f"gpt_tp_{tag}"], ranks["gpt_single"]) < DECODE_SCALE
    # the gathered int8 cache: exactly one card's, within 1 of JAX's flat one
    assert bool(ranks[f"gpt_single_{tag}_match"])
    kq = ranks[f"gpt_tp_{tag}_kq"]
    assert kq.dtype == np.int8
    np.testing.assert_array_equal(kq[0], ranks["gpt_single_kq0"])
    b, h, L, d = kq.shape[1:]
    for layer in range(kq.shape[0]):
        flat = kq[layer].transpose(0, 2, 1, 3).reshape(b, L, h * d).astype(np.int32)
        assert np.abs(flat - np.asarray(jcache[layer][0], np.int32)).max() <= 1


def test_qgpt_specs_equal_jax():
    m, params, _ = _jgpt()
    P = jax.sharding.PartitionSpec
    for tp in (2, 4):
        want = jpar.qgpt_param_specs(jquantize(m, params), tp=tp)
        tm = tt.GPTDecoder(**W.GPT_SMALL, device="cpu")
        got = tpar.qgpt_param_specs(tt.quantize_gpt(tm), tp=tp)
        for gb, wb in zip(got.blocks, want.blocks):
            for f in ("q", "k", "v", "o", "fc1", "fc2"):
                for leaf in ("qw", "sw", "b"):
                    assert P(*getattr(getattr(gb, f), leaf)) == getattr(getattr(wb, f), leaf)
        for leaf in ("qw", "sw", "b"):
            assert P(*getattr(got.lm_head, leaf)) == getattr(want.lm_head, leaf), tp


def test_split_qkv_is_exact():
    from tpusparse_torch.parallel.serving import _split_qkv

    qm = tt.quantize_gpt(tt.GPTDecoder(**W.GPT_SMALL, device="cpu"))
    for blk, split in zip(qm.blocks, _split_qkv(qm).blocks):
        assert torch.equal(torch.cat([split.q.qw, split.k.qw, split.v.qw], 1), blk.qkv.qw)
        assert torch.equal(torch.cat([split.q.sw, split.k.sw, split.v.sw]), blk.qkv.sw)


def test_tp_decode_at_world_size_1_is_decode_step(ws1):
    gen = torch.Generator().manual_seed(2)
    qm = tt.quantize_gpt(tt.GPTDecoder(**W.GPT_SMALL, device="cpu", generator=gen))
    ids = torch.from_numpy(W.gpt_ids())
    with torch.no_grad():
        _, cache = qm.prefill(ids[:, :4])
        c1 = tuple(tuple(t.clone() for t in layer) for layer in cache)
        want, wc = qm.decode_step(ids[:, 4], c1, 4)
    qs, _ = tpar.shard_qgpt(qm, ws1)
    got, gc = tpar.make_tp_decode_step(qs, ws1, flat_cache=False)(ids[:, 4], cache, 4)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for la, lb in zip(gc, wc) for a, b in zip(la, lb))


def test_shard_qgpt_heads_must_divide(ranks):
    assert "must divide" in str(ranks["error_gpt_heads"])


# -- the dry run ----------------------------------------------------------------------------


def test_dryrun_multichip_on_four_cpu_ranks(ranks):
    """The dry run's body, every part a and part b path once, on the
    module's 4 gloo ranks (the spawning launcher runs on the cards in
    parallel_smoke.py)."""
    assert str(ranks["dryrun_error"]) == ""


DEVICE_NONE = {
    "init_moe_params": lambda: tpar.init_moe_params(torch.Generator(), 4, 8, 16),
    "dryrun_multichip": lambda: tpar.dryrun_multichip(2),
    "load_moe_params": lambda: load_moe_params(_np_tree(_jmoe_params())),
    "load_stage_params": lambda: load_stage_params((np.zeros((2, 3, 3)),)),
}


@pytest.mark.parametrize("name", sorted(DEVICE_NONE))
def test_device_none_means_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so device=None rightly runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEVICE_NONE[name]()
