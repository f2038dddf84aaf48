"""The port's examples (examples_torch/0*.py): each runs its `main(device=
'cpu')` in this process (06 on 4 gloo ranks), and its figures are held
against the JAX package run on the same numpy inputs (the examples'
`inputs()`), called directly; tests/test_examples.py runs JAX's scripts.
The flax-initialised modules (03's layers, 04's attention, 07's BigBird and
GPT) are carried into the port's with `convert.load_flax_params` here, not
in the examples, and held from JAX's parameters.

Tolerances:
  - routes, argmax indices, mask densities, `describe` strings, matrix
    patterns, int8 weights and generated tokens: equal;
  - fp32 outputs: the JAX suite's fp32 tier, rtol 1e-4, atol 5e-5
    (summation orders differ); the Krylov iterates at the same tier
    relative to their largest element (a fp32 rounding difference in one
    iteration moves every later one by the same relative amount);
  - Adam (03): 3 steps' losses at the fp32 tier; the parameters as
    tests/test_torch_graph.py holds them (an element whose first gradient is
    under 1e-3 of the largest may step the other way, up to 2·lr a step);
  - int8 outputs: within 1e-6 of scale (tests/test_torch_quant.py: both
    sides sum the same exact int32 products in fp32); the quantized GPT's
    logits within 1e-4 of scale (tests/test_torch_gpt.py), its generated
    tokens equal to JAX's decode steps run eagerly (`_jax_greedy`).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as ssp
import torch

import tpusparse as ts
from tpusparse import nn as jnn
from tpusparse.linalg import cg as jcg
from tpusparse.linalg import eigsh_lanczos as jeigsh
from tpusparse.linalg import ic_preconditioner as jic
from tpusparse.models import GPTDecoder as JGPT
from tpusparse.models import quantize_gpt as jquantize_gpt
from tpusparse.ops import _route_spmm as j_route_spmm
from tpusparse.parallel import make_mesh as jmake_mesh
from tpusparse.parallel import shard_plan_rows as jshard_plan_rows
from tpusparse.parallel import sharded_spmm as jsharded_spmm
from tpusparse.parallel.linalg import sharded_cg as jsharded_cg
from tpusparse.plan import build_plan as jbuild_plan
from tpusparse.utils.matrices import describe as jdescribe
from tpusparse.utils.matrices import get_matrix as jget_matrix

import tpusparse_torch as tt

ROOT = Path(__file__).resolve().parents[1]
PATHS = sorted((ROOT / "examples_torch").glob("0*.py"))
TOL = dict(rtol=1e-4, atol=5e-5)
INT8_SCALE_TOL = 1e-6
GPT_SCALE_TOL = 1e-4
WORLD = 4


def _load(stem: str):
    """The example as a module named by its file, importable by name (06's
    spawned ranks import it to unpickle their function)."""
    if str(ROOT / "examples_torch") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples_torch"))
    spec = importlib.util.spec_from_file_location(stem, ROOT / "examples_torch" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[stem] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def one_thread():
    """Tiny steps on one torch thread: a pool of threads only spins here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RESULTS = {}


def _run(stem: str) -> tuple:
    """(module, main(device='cpu')'s figures) of an example, run once."""
    if stem not in _RESULTS:
        mod = _load(stem)
        kw = {"world_size": WORLD} if stem.startswith("06") else {}
        _RESULTS[stem] = mod, mod.main(device="cpu", **kw)
    return _RESULTS[stem]


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float64)


def _over_scale(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close_to_scale(got, want, name=""):
    """The fp32 tier relative to the largest element of `want`."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(np.abs(want).max(), 1.0), err_msg=name)


def _jcsr(a: ssp.csr_matrix) -> ts.CSR:
    return ts.CSR.from_scipy(a)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_one_example_each():
    """Seven examples, one for each of the JAX package's, with its name."""
    jax_names = sorted(p.name for p in (ROOT / "examples").glob("0*.py"))
    assert len(PATHS) >= 7
    assert [p.name for p in PATHS] == jax_names


@pytest.mark.parametrize("path", PATHS, ids=[p.name for p in PATHS])
def test_example_runs_on_the_cpu(path, one_thread):
    """main(device='cpu') passes its own checks and launches no kernel."""
    _, fig = _run(path.stem)
    assert isinstance(fig, dict) and fig["launches"] == {}


def test_01_matches_jax(one_thread):
    mod, fig = _run("01_migrate_matmuls")
    inp, out = mod.inputs(), fig["out"]
    j = {k: jnp.asarray(v) for k, v in inp.items() if isinstance(v, np.ndarray)}
    np.testing.assert_allclose(out["mm"], ts.mm(j["a"], j["b"]), **TOL)
    np.testing.assert_allclose(out["mm_da"], jax.grad(lambda x: ts.mm(x, j["b"]).sum())(j["a"]),
                               **TOL)
    np.testing.assert_allclose(out["transb_mm"], ts.transb_mm(j["q"], j["k"]), **TOL)
    np.testing.assert_allclose(out["bmm"], ts.bmm(j["x4"], j["y4"]), **TOL)
    A = _jcsr(inp["a_sp"])
    assert fig["route"] == j_route_spmm(A, j["B"], None)
    np.testing.assert_allclose(out["spmm"], ts.spmm(A, j["B"]), **TOL)
    np.testing.assert_allclose(out["spmm_naive"], ts.spmm(A, j["B"], method="naive"), **TOL)
    da = jax.grad(lambda d: ts.spmm(ts.CSR(d, A.indices, A.indptr, A.shape), j["B"]).sum())(
        A.data)
    np.testing.assert_allclose(out["spmm_da"], da, **TOL)


def test_02_matches_jax(one_thread):
    mod, fig = _run("02_plans_and_executors")
    inp, out = mod.inputs(), fig["out"]
    A, B = _jcsr(inp["a_sp"]), jnp.asarray(inp["B"])
    np.testing.assert_allclose(out["implicit"], ts.spmm(A, B, method="tiled"), **TOL)
    plan = jbuild_plan(A)
    want = ts.ops.spmm_blocks(plan, plan.pack_values(A.data), B)
    np.testing.assert_allclose(out["explicit"], want, **TOL)
    np.testing.assert_allclose(out["batched"], ts.spmm(A, jnp.asarray(inp["B3"]), method="tiled"),
                               **TOL)
    tplan = tt.build_plan(tt.CSR.from_scipy(inp["a_sp"], device="cpu"))
    np.testing.assert_array_equal(np.asarray(tplan.block_cols), np.asarray(plan.block_cols))
    assert fig["report"]["nblocks"] == plan.report()["nblocks"]


def _jax_adam_losses(model, params, x, y, steps, lr):
    tx = optax.adam(lr)
    opt = tx.init(params)
    losses = []
    for _ in range(steps):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((model.apply(p, x) - y) ** 2))(params)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_03_first_loss_and_three_steps_match_jax(name, one_thread):
    mod, fig = _run("03_training")
    assert fig["losses"]["dense"][1] < 0.01 * fig["losses"]["dense"][0]
    inp = mod.inputs()
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    jmodel = (jnn.DenseLinear(10) if name == "dense"
              else jnn.SparseLinear.random(0, 64, 10, density=0.5))
    params = jmodel.init(jax.random.PRNGKey(0), x)
    tmodel = mod.models("cpu")[name]
    tt.load_flax_params(tmodel, _np_tree(params))
    grads = jax.grad(lambda p: jnp.mean((jmodel.apply(p, x) - y) ** 2))(params)
    t_losses = mod.train(tmodel, torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"]),
                         steps=3)
    jparams, j_losses = _jax_adam_losses(jmodel, params, x, y, 3, mod.LR)
    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    want, jg = _np_tree(jparams)["params"], _np_tree(grads)["params"]
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jg))
    for pname, p in tmodel.named_parameters():
        got, sensitive = p.detach().numpy(), np.abs(jg[pname]) < 1e-3 * scale
        np.testing.assert_allclose(got[~sensitive], want[pname][~sensitive], rtol=0,
                                   atol=1e-5 + 1e-3 * mod.LR, err_msg=pname)
        np.testing.assert_allclose(got[sensitive], want[pname][sensitive], rtol=0,
                                   atol=6 * mod.LR, err_msg=pname)


def test_04_matches_jax(one_thread):
    mod, fig = _run("04_bert_attention")
    inp = mod.inputs()
    np.testing.assert_allclose(fig["out"]["scores"],
                               ts.transb_mm(jnp.asarray(inp["q"]), jnp.asarray(inp["k"])), **TOL)
    xh = jnp.asarray(inp["xh"])
    jmods = {"dense": jnn.SelfAttention(num_heads=mod.HEADS, head_dim=mod.HD),
             "fused": jnn.SelfAttention(num_heads=mod.HEADS, head_dim=mod.HD, fused=True),
             "sparse": jnn.SparseSelfAttention(num_heads=mod.HEADS, head_dim=mod.HD, window=16)}
    tmods = mod.modules("cpu")
    for name, jm in jmods.items():
        params = jm.init(jax.random.PRNGKey(0), xh)
        tt.load_flax_params(tmods[name], _np_tree(params))
        with torch.no_grad():
            got = tmods[name](torch.from_numpy(inp["xh"]))
        np.testing.assert_allclose(got.numpy(), jm.apply(params, xh), **TOL, err_msg=name)
    jroute, _, _ = jnn.route_sparse_attention(*jnn.local_global_pattern(mod.SEQ, 16, 0), mod.SEQ)
    assert fig["sparse_route"] == jroute


def test_05_matches_jax(one_thread):
    mod, fig = _run("05_solvers")
    inp, out = mod.inputs(), fig["out"]
    s = lambda m: ts.CSR.from_scipy(m.tocsr())
    A = ts.sp_add(ts.sp_kron(s(inp["I"]), s(inp["T"])), ts.sp_kron(s(inp["T"]), s(inp["I"])))
    tA = mod.poisson(inp, "cpu")
    np.testing.assert_array_equal(tA.indptr, np.asarray(A.indptr))
    np.testing.assert_array_equal(tA.indices, np.asarray(A.indices))
    np.testing.assert_array_equal(tA.data.numpy(), np.asarray(A.data))
    b = jnp.asarray(inp["b"])
    want = {"cg": jcg(A, b, tol=1e-7, maxiter=mod.ITERS)[0],
            "ic": jcg(A, b, M=jic(A), tol=1e-7, maxiter=mod.ITERS)[0],
            "amg": jcg(A, b, M=ts.smoothed_aggregation_setup(A, coarse_size=50), tol=1e-7,
                       maxiter=mod.ITERS)[0]}
    for name, x in want.items():
        _close_to_scale(out[name], x, name)
    vals, _ = jeigsh(A, k=3, which="LA", iters=mod.LANCZOS_ITERS)
    np.testing.assert_allclose(fig["eigenvalues"], vals, **TOL)


def test_06_matches_jax_on_four_ranks(one_thread):
    mod, fig = _run("06_distributed")
    assert fig["world_size"] == WORLD
    inp, out = mod.inputs(), fig["out"]
    mesh = jmake_mesh((WORLD,), ("model",), devices=jax.devices()[:WORLD])
    A = _jcsr(inp["A"])
    rsp = jshard_plan_rows(A, WORLD, blocksize=mod.BLOCKSIZE)
    np.testing.assert_allclose(out["y"], jsharded_spmm(rsp, A.data, jnp.asarray(inp["B"]), mesh),
                               **TOL)
    S = ts.sp_add(A, ts.transpose_csr(A))
    spd = ts.sp_add(S, ts.linalg.speye(mod.N), 1.0, 30.0)
    x, _ = jsharded_cg(spd, jnp.asarray(inp["b"]), mesh, blocksize=mod.BLOCKSIZE, tol=1e-8,
                       maxiter=200)
    _close_to_scale(out["x"], x)


def test_06_runs_beside_a_process_group(one_thread):
    """With a process group up in the caller (a test worker that ran the
    parallel tests keeps one), the example spawns its ranks, at world size
    1 too, and gives the same figures."""
    from tpusparse_torch import parallel as tpar

    tpar.initialize_distributed(device="cpu")  # a no-op where one is up
    mod, fig = _run("06_distributed")
    again = mod.main(device="cpu", world_size=1)
    assert again["world_size"] == 1
    np.testing.assert_allclose(again["out"]["y"], fig["out"]["y"], **TOL)
    _close_to_scale(again["out"]["x"], fig["out"]["x"])


def test_07_matches_jax(one_thread):
    mod, fig = _run("07_serving_and_real_matrices")
    inp, out = mod.inputs(), fig["out"]
    # int8 serving: the int8 weights equal, the product within 1e-6 of scale
    w = ts.CSR.from_scipy(inp["w_sp"])
    jqa = ts.QuantizedMatrix(w, blocksize=(8, 16))
    tqa = tt.QuantizedMatrix(tt.CSR.from_scipy(inp["w_sp"], device="cpu"), blocksize=(8, 16))
    np.testing.assert_array_equal(tqa.qvals.numpy(), np.asarray(jqa.qvals))
    assert _over_scale(out["int8"], jqa @ jnp.asarray(inp["x"])) <= INT8_SCALE_TOL
    # the catalog, the router, the argmax reducer, the masks, the constants
    assert fig["describe"] == jdescribe("laplace2d_256")
    lap = jget_matrix("laplace2d_256")
    v = jnp.ones((lap.shape[1], 1), jnp.float32)
    assert fig["fem_route"] == j_route_spmm(lap, v, None)
    np.testing.assert_allclose(out["fem"], ts.spmm(lap, v[:, 0]), **TOL)
    a_small, bmat = _jcsr(inp["a_small"]), jnp.asarray(inp["bmat"])
    vals, arg = ts.spmm(a_small, bmat, reduce="max", return_arg=True)
    np.testing.assert_array_equal(out["argmax"], np.asarray(arg))
    np.testing.assert_array_equal(out["argmax_vals"], np.asarray(vals))
    assert fig["bigbird_density"] == float(jnn.bigbird_block_mask(128, block=32).mean())
    assert fig["cost_constants"] == ts.ops.get_cost_constants()
    ind, ptr = jnn.local_global_pattern(1024, 40, 3)
    assert fig["attention_route"] == jnn.route_sparse_attention(ind, ptr, 1024)[0]
    # dense int8 serving
    jqd = ts.QuantizedDense(jnp.asarray(inp["w"]))
    np.testing.assert_array_equal(tt.QuantizedDense(torch.from_numpy(inp["w"])).qw.numpy(),
                                  np.asarray(jqd.qw))
    assert _over_scale(out["dense_int8"], jqd @ jnp.asarray(inp["xd"])) <= INT8_SCALE_TOL
    # BigBird from JAX's parameters
    h = jnp.asarray(inp["h"])
    jbb = jnn.BigBirdAttention(**mod.BIGBIRD)
    params = jbb.init(jax.random.PRNGKey(0), h)
    layer = mod.bigbird("cpu")
    tt.load_flax_params(layer, _np_tree(params))
    with torch.no_grad():
        got = layer(torch.from_numpy(inp["h"]))
    np.testing.assert_allclose(got.numpy(), jbb.apply(params, h), **TOL)
    # quantized GPT serving from JAX's parameters
    ids = jnp.asarray(inp["ids"].astype(np.int32))
    jgpt = JGPT(**mod.GPT)
    gparams = jgpt.init(jax.random.PRNGKey(1), ids)
    tgpt = mod.gpt("cpu")
    tt.load_flax_params(tgpt, _np_tree(gparams))
    lg_q, lg_f, toks = mod.serve_gpt(tgpt, torch.from_numpy(inp["ids"]))
    jq = jquantize_gpt(jgpt, gparams)
    jlg_q, _ = jq.prefill(ids)
    np.testing.assert_allclose(lg_f.numpy(), jgpt.apply(gparams, ids), **TOL)
    assert _over_scale(lg_q, jlg_q) <= GPT_SCALE_TOL
    np.testing.assert_array_equal(toks.numpy(), _jax_greedy(jq, ids, 4))


def _jax_greedy(jq, ids, steps) -> np.ndarray:
    """JAX's `QuantizedGPT.generate` (tpusparse/models/serving.py:300), its
    decode steps run eagerly one by one. Its own `generate` runs them inside
    a `lax.scan`, compiled, which at 07's inputs gives other tokens from the
    second on ([96, 22, 10, 4]) than its eager steps ([96, 35, 68, 4], the
    port's): the compiled step rounds the int8 cache's appends otherwise,
    and the two top logits of that step are 0.003 apart."""
    logits, cache = jq.prefill(ids)
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(ids.dtype)
    out = []
    for i in range(steps):
        out.append(np.asarray(tok))
        lg, cache = jq.decode_step(tok, cache, ids.shape[1] + i)
        tok = jnp.argmax(lg, axis=-1).astype(ids.dtype)
    return np.stack(out, axis=1)
