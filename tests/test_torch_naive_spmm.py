"""Parity of the port's naive SpMM with its reducers (tpusparse_torch.kernels.
naive_spmm, tpusparse_torch.ops.naive_spmm and spmm's routes and rules,
tpusparse_torch.types.spmm_reference) with the JAX package. The JAX naive
kernel runs here in Pallas interpret mode; on CPU tensors the port's wrapper
runs its plain PyTorch version. The CUDA kernel itself is checked on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the fp32 tier of the JAX suite (rtol 1e-4, atol 5e-5) where the
two sides sum or divide in another order; max, min and the arg matrix are
exact (both take the same fp32 products and the same strict comparison);
the plain `div` divides as it runs while JAX's `spmm_reference` takes
1 / prod, so those two are held at rtol 1e-4, as tests/test_spmm_kernels.py
holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusparse.ops as jops
from tpusparse.kernels.naive_spmm import ell_pack as j_ell_pack
from tpusparse.kernels.naive_spmm import naive_spmm_pallas
from tpusparse.types import BSR as JBSR
from tpusparse.types import CSR as JCSR
from tpusparse.types import spmm_reference as j_spmm_reference

import tpusparse_torch.ops as tops
from tpusparse_torch import kernels
from tpusparse_torch.kernels import naive_spmm as nk
from tpusparse_torch.types import COO as TCOO
from tpusparse_torch.types import CSR as TCSR
from tpusparse_torch.types import csr_to_bsr, csr_to_coo, spmm_reference
from tpusparse_torch.types import random_csr as tt_random_csr

TOL = dict(rtol=1e-4, atol=5e-5)  # fp32 tier of the JAX suite
REDUCTIONS = ("sum", "mean", "max", "min", "mul", "div")
# reduce, return_arg: every reducer, and the arg output of max and min
MODES = [(r, False) for r in REDUCTIONS] + [("max", True), ("min", True)]


def _matrix(seed, m, k, density, empty_rows=(), ties=False):
    """A dense (m, k) fp32 matrix with the given rows empty. With `ties`,
    values and B come from a few small integers, so equal products are
    common and the arg tie-break is exercised."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    mask[list(empty_rows)] = False
    if ties:
        vals = rng.choice([-2.0, -1.0, 1.0, 2.0], (m, k))
    else:
        vals = rng.uniform(0.5, 1.5, (m, k)) * rng.choice([-1.0, 1.0], (m, k))
    return (mask * vals).astype(np.float32), rng


def _b(rng, k, n, ties=False):
    if ties:
        return rng.integers(-2, 3, (k, n)).astype(np.float32)
    return rng.uniform(0.5, 1.5, (k, n)).astype(np.float32)


def _pair(d):
    return JCSR.from_dense(jnp.asarray(d)), TCSR.from_dense(d, device="cpu")


def _assert_mode(got, want, reduce, return_arg):
    if return_arg:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32
    elif reduce in ("max", "min"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the kernel's plain version against the Pallas kernel -----------------------


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("reduce,return_arg", MODES)
def test_plain_matches_pallas(reduce, return_arg, ties):
    """Every reducer and arg output, ragged m, empty rows (3, 10, 11), and
    with `ties` many equal products: the first one must win."""
    d, rng = _matrix(1, 21, 17, 0.35, empty_rows=(3, 10, 11), ties=ties)
    b = _b(rng, 17, 7, ties)
    j, t = _pair(d)
    nnz = j.nnz if return_arg else 0
    want = naive_spmm_pallas(j_ell_pack(j), j.shape, jnp.asarray(b), reduce=reduce,
                             return_arg=return_arg, nnz=nnz)
    got = nk.naive_spmm_kernel(nk.ell_pack(t), t.shape, torch.from_numpy(b), reduce=reduce,
                               return_arg=return_arg, nnz=nnz)
    _assert_mode(got, want, reduce, return_arg)
    if reduce in ("max", "min"):  # empty rows write 0, their arg stays nnz
        vals = got[0] if return_arg else got
        assert torch.count_nonzero(vals[[3, 10, 11]]) == 0
        if return_arg:
            assert bool((got[1][[3, 10, 11]] == t.nnz).all())


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_rows_of_infinite_products_keep_the_identity(reduce):
    """A row whose products are all -inf (max) or +inf (min): the strict
    update never fires, so the value stays at the identity and the arg at
    nnz, in the Pallas kernel and in the port alike."""
    inf = np.float32(np.inf if reduce == "min" else -np.inf)
    d = np.zeros((4, 3), np.float32)
    d[0, :] = inf
    d[1, 1] = 2.0
    d[2, [0, 2]] = 1.0
    b = np.ones((3, 2), np.float32)
    j, t = _pair(d)
    want = naive_spmm_pallas(j_ell_pack(j), j.shape, jnp.asarray(b), reduce=reduce,
                             return_arg=True, nnz=j.nnz)
    got = nk.naive_spmm_kernel(nk.ell_pack(t), t.shape, torch.from_numpy(b), reduce=reduce,
                               return_arg=True, nnz=t.nnz)
    _assert_mode(got, want, reduce, True)
    assert bool((got[0][0] == inf).all()) and bool((got[1][0] == t.nnz).all())


def test_plain_takes_bf16_b():
    d, rng = _matrix(2, 19, 23, 0.3)
    b = torch.from_numpy(_b(rng, 23, 5)).to(torch.bfloat16)
    _, t = _pair(d)
    got = nk.naive_spmm_kernel(nk.ell_pack(t), t.shape, b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), d @ b.float().numpy(), **TOL)


def test_kernel_wrapper_guards():
    d, rng = _matrix(3, 8, 6, 0.5)
    _, t = _pair(d)
    ell, b = nk.ell_pack(t), torch.from_numpy(_b(rng, 6, 3))
    with pytest.raises(ValueError, match="unknown reduce"):
        nk.naive_spmm_kernel(ell, t.shape, b, reduce="prod")
    with pytest.raises(ValueError, match="min/max"):
        nk.naive_spmm_kernel(ell, t.shape, b, reduce="sum", return_arg=True)
    with pytest.raises(ValueError, match="incompatible"):
        nk.naive_spmm_kernel(ell, t.shape, b[:5])
    with pytest.raises(TypeError, match="dtype"):
        nk.naive_spmm_kernel(ell, t.shape, b.half())


def test_cpu_path_does_not_count_launches():
    d, rng = _matrix(4, 12, 9, 0.4)
    _, t = _pair(d)
    kernels.reset_launch_counts()
    tops.naive_spmm(t, torch.from_numpy(_b(rng, 9, 4)))
    assert kernels.launches_by_kernel()["naive_spmm"] == 0


# -- packing --------------------------------------------------------------------


@pytest.mark.parametrize("width", [None, 9])
def test_ell_pack_equals_jax(width):
    d, _ = _matrix(5, 30, 20, 0.2, empty_rows=(0, 29))
    j, t = _pair(d)
    for got, want in zip(nk.ell_pack(t, width), j_ell_pack(j, width)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_ell_pack_traced_and_width_equal_jax():
    d, _ = _matrix(6, 40, 25, 0.15, empty_rows=(7,))
    j, t = _pair(d)
    assert tops.resolve_ell_width(t) == jops.resolve_ell_width(j)
    for got, want in zip(tops.ell_pack_traced(t), jops.ell_pack_traced(j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = TCSR(torch.zeros(0), np.zeros(0, np.int32), np.zeros(5, np.int32), (4, 3))
    assert tops.resolve_ell_width(empty) == 1


# -- spmm_reference -----------------------------------------------------------------


@pytest.mark.parametrize("reduce,return_arg", MODES)
def test_spmm_reference_reducers_match_jax(reduce, return_arg):
    d, rng = _matrix(7, 26, 18, 0.3, empty_rows=(5, 6), ties=True)
    b = _b(rng, 18, 9, ties=True)
    j, t = _pair(d)
    got = spmm_reference(t, torch.from_numpy(b), reduce=reduce, return_arg=return_arg)
    want = j_spmm_reference(j, jnp.asarray(b), reduce=reduce, return_arg=return_arg)
    _assert_mode(got, want, reduce, return_arg)


def test_div_running_division_against_reciprocal_of_product():
    """The kernel's running division and the oracle's 1 / prod differ by
    rounding only."""
    d, rng = _matrix(8, 20, 15, 0.3, empty_rows=(2,))
    b = _b(rng, 15, 6)
    j, t = _pair(d)
    got = nk.naive_spmm_kernel(nk.ell_pack(t), t.shape, torch.from_numpy(b), reduce="div")
    want = j_spmm_reference(j, jnp.asarray(b), reduce="div")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.ones(6, np.float32))


# -- ops.naive_spmm and its gradient --------------------------------------------


def test_naive_spmm_sum_gradient_matches_jax_vjp():
    d, rng = _matrix(9, 24, 16, 0.3, empty_rows=(4,))
    b = _b(rng, 16, 5)
    g = rng.standard_normal((24, 5)).astype(np.float32)
    j, t = _pair(d)

    def jf(vals, bb):
        return jops.naive_spmm(JCSR(vals, j.indices, j.indptr, j.shape), bb)

    out, vjp = jax.vjp(jf, j.data, jnp.asarray(b))
    d_vals, d_b = vjp(jnp.asarray(g))
    data = t.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    got = tops.naive_spmm(TCSR(data, t.indices, t.indptr, t.shape), bt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(d_vals), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(d_b), **TOL)


@pytest.mark.parametrize("reduce,return_arg", [("mean", False), ("max", True), ("mul", False)])
def test_naive_spmm_3d_fold_matches_jax(reduce, return_arg):
    d, rng = _matrix(10, 14, 11, 0.35, empty_rows=(1,))
    b = rng.uniform(0.5, 1.5, (3, 11, 4)).astype(np.float32)
    j, t = _pair(d)
    got = tops.naive_spmm(t, torch.from_numpy(b), reduce, return_arg=return_arg)
    want = jops.naive_spmm(j, jnp.asarray(b), reduce, return_arg=return_arg)
    _assert_mode(got, want, reduce, return_arg)


# -- spmm: routes, inputs and rules ---------------------------------------------------

METHODS = ["tiled", "resident", "gather", "dense", "naive", "reference"]


def _spmm_case(seed=11):
    d, rng = _matrix(seed, 33, 27, 0.25, empty_rows=(8,))
    return d, rng, *_pair(d)


@pytest.mark.parametrize("method", METHODS)
def test_spmm_routes_match_jax(method):
    d, rng, j, t = _spmm_case()
    b = rng.standard_normal((27, 6)).astype(np.float32)
    got = tops.spmm(t, torch.from_numpy(b), method=method, blocksize=(8, 8))
    want = jops.spmm(j, jnp.asarray(b), method="reference")
    assert got.dtype == torch.float32 and got.shape == (33, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_spmm_1d_b_matches_jax(method):
    d, rng, j, t = _spmm_case(12)
    b = rng.standard_normal(27).astype(np.float32)
    got = tops.spmm(t, torch.from_numpy(b), method=method, blocksize=(8, 8))
    assert got.shape == (33,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jops.spmm(
        j, jnp.asarray(b), method="reference")), **TOL)


@pytest.mark.parametrize("method", ["gather", "dense", "naive", "reference"])
@pytest.mark.parametrize("lead", [(3,), (2, 2)])
def test_spmm_batched_b_matches_jax(method, lead):
    """3-D b on the routes that fold it, and 4-D b (leading dims folded)."""
    d, rng, j, t = _spmm_case(13)
    b = rng.standard_normal((*lead, 27, 5)).astype(np.float32)
    got = tops.spmm(t, torch.from_numpy(b), method=method)
    want = jops.spmm(j, jnp.asarray(b), method="reference")
    assert got.shape == (*lead, 33, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", ["naive", "reference"])
@pytest.mark.parametrize("reduce,return_arg", MODES[1:])
def test_spmm_reducers_match_jax(method, reduce, return_arg):
    d, rng, j, t = _spmm_case(14)
    b = _b(rng, 27, 4)
    got = tops.spmm(t, torch.from_numpy(b), method=method, reduce=reduce,
                    return_arg=return_arg)
    want = jops.spmm(j, jnp.asarray(b), method=method, reduce=reduce, return_arg=return_arg)
    if reduce == "div" and method == "naive":  # running division against 1 / prod
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    else:
        _assert_mode(got, want, reduce, return_arg)


@pytest.mark.parametrize("method", ["naive", "reference"])
def test_spmm_return_arg_1d_and_3d(method):
    d, rng, j, t = _spmm_case(15)
    for shape in ((27,), (2, 27, 3)):
        b = _b(rng, 27, 1).reshape(-1)[:27] if len(shape) == 1 else rng.uniform(
            0.5, 1.5, shape).astype(np.float32)
        got = tops.spmm(t, torch.from_numpy(b), method=method, reduce="min", return_arg=True)
        want = jops.spmm(j, jnp.asarray(b), method=method, reduce="min", return_arg=True)
        assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
        _assert_mode(got, want, "min", True)


def test_spmm_rules_raise():
    _, rng, _, t = _spmm_case()
    b = torch.from_numpy(rng.standard_normal((27, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="reduce='sum' only"):
        tops.spmm(t, b, method="tiled", reduce="max")
    with pytest.raises(ValueError, match="reduce='sum' only"):
        tops.spmm(t, b, method="gather", reduce="mean")
    with pytest.raises(ValueError, match="min'/'max"):
        tops.spmm(t, b, method="naive", return_arg=True)
    with pytest.raises(ValueError, match="unknown reduce"):
        tops.spmm(t, b, method="naive", reduce="prod")
    # a 3-D b on the block routes is ported: the batched executor's values,
    # and the sum-only rule holds there too
    np.testing.assert_allclose(tops.spmm(t, b[None], method="tiled")[0].numpy(),
                               tops.spmm(t, b, method="reference").numpy(), **TOL)
    with pytest.raises(ValueError, match="reduce='sum' only"):
        tops.spmm(t, b[None], method="footprint", reduce="max")


def _default_case():
    """ROADMAP fault 5's input: the port's random_csr(0, (40, 30), 0.08),
    handed to JAX as the same arrays, times a (30, 5) fp32 b."""
    t = tt_random_csr(0, (40, 30), 0.08, device="cpu")
    j = JCSR(data=jnp.asarray(t.data.numpy()), indices=jnp.asarray(t.indices),
             indptr=jnp.asarray(t.indptr), shape=t.shape)
    b = np.random.default_rng(16).standard_normal((30, 5)).astype(np.float32)
    return t, j, b


@pytest.mark.parametrize("reduce,return_arg",
                         [("max", False), ("min", False), ("mean", False), ("max", True)])
def test_spmm_reducers_with_no_method_match_jax_default(reduce, return_arg):
    t, j, b = _default_case()
    got = tops.spmm(t, torch.from_numpy(b), reduce=reduce, return_arg=return_arg)
    want = jops.spmm(j, jnp.asarray(b), reduce=reduce, return_arg=return_arg)
    outs = got if return_arg else (got,)
    wants = want if return_arg else (want,)
    for o, w in zip(outs, wants):
        assert o.shape == w.shape
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))


def test_spmm_sum_with_no_method_routes_as_jax_auto(monkeypatch):
    """A sum with no method takes 'auto', JAX's default: the route equals
    `_route_spmm`'s in JAX and the values JAX's default `spmm`; a reducer
    still routes to the reference."""
    t, j, b = _default_case()
    routes, seen = [], []
    route = tops._route_spmm
    monkeypatch.setattr(tops, "_route_spmm",
                        lambda *a, **k: routes.append(route(*a, **k)) or routes[-1])
    fn = tops.spmm_reference
    monkeypatch.setattr(tops, "spmm_reference",
                        lambda *a, **k: seen.append("spmm_reference") or fn(*a, **k))
    got = tops.spmm(t, torch.from_numpy(b))
    assert routes == [jops._route_spmm(j, jnp.asarray(b), None)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.spmm(j, jnp.asarray(b))), **TOL)
    tops.spmm(t, torch.from_numpy(b), reduce="max")
    assert seen == ["spmm_reference"] and len(routes) == 1  # the 'auto' route of a reducer


def test_spmm_of_an_empty_csr_with_no_method_keeps_its_gradient():
    """An empty (5, 7) CSR routes to 'dia' under 'auto' in both packages;
    the product keeps the graph, and the gradients equal `jax.grad`'s
    exactly: shape (0,) for the values and zeros (7, 3) for b."""
    ind, ptr = np.zeros(0, np.int32), np.zeros(6, np.int32)
    b = np.random.default_rng(17).standard_normal((7, 3)).astype(np.float32)
    w = np.cos(np.arange(15, dtype=np.float32)).reshape(5, 3)
    data = torch.zeros(0, requires_grad=True)
    bt = torch.from_numpy(b).requires_grad_()
    out = tops.spmm(TCSR(data=data, indices=ind, indptr=ptr, shape=(5, 7)), bt)
    assert out.grad_fn is not None and out.shape == (5, 3)
    (out * torch.from_numpy(w)).sum().backward()

    def loss(vals, bb):
        a = JCSR(data=vals, indices=jnp.asarray(ind), indptr=jnp.asarray(ptr), shape=(5, 7))
        return (jops.spmm(a, bb) * w).sum()

    assert jops._route_spmm(JCSR(data=jnp.zeros(0), indices=jnp.asarray(ind),
                                 indptr=jnp.asarray(ptr), shape=(5, 7)),
                            jnp.asarray(b), None) == "dia"
    g_vals, g_b = jax.grad(loss, argnums=(0, 1))(jnp.zeros(0), jnp.asarray(b))
    assert data.grad.shape == g_vals.shape == (0,)
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(g_b))
    np.testing.assert_array_equal(bt.grad.numpy(), np.zeros((7, 3), np.float32))


@pytest.mark.parametrize("fmt", ["coo", "bsr"])
@pytest.mark.parametrize("method", ["tiled", "naive", "gather", "reference"])
def test_spmm_takes_coo_and_bsr(fmt, method):
    d, rng, j, t = _spmm_case(16)
    b = rng.standard_normal((27, 5)).astype(np.float32)
    a = csr_to_coo(t) if fmt == "coo" else csr_to_bsr(t, (8, 8))
    assert isinstance(a, TCOO) or a.blocksize == (8, 8)
    got = tops.spmm(a, torch.from_numpy(b), method=method)
    ja = JBSR.from_dense(jnp.asarray(d), (8, 8)) if fmt == "bsr" else j
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.spmm(
        ja, jnp.asarray(b), method="reference")), **TOL)


def test_binding_matches_the_c_entry_point(monkeypatch):
    """The ctypes argument list of `naive_spmm` has one type per parameter of
    the C entry point in csrc/naive_spmm.cu (ctypes refuses a call whose
    count differs, and only on the card)."""
    import re
    from pathlib import Path

    from tpusparse_torch.kernels import _build

    captured = {}
    monkeypatch.setattr(_build, "bind",
                        lambda name, argtypes: captured.update(argtypes) or argtypes)
    nk._kernel_fn.__wrapped__()
    src = (Path(nk.__file__).resolve().parents[1] / "csrc" / "naive_spmm.cu").read_text()
    params = re.search(r'extern "C" int naive_spmm\(([^)]*)\)', src).group(1).split(",")
    assert len(captured["naive_spmm"]) == len(params) == 18
