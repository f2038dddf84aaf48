"""The port's native C++/OpenMP inspector (tpusparse_torch/runtime/native.py,
built from tpusparse_torch/csrc/inspector.cpp) against its numpy passes and
against the JAX package's (tests/test_native.py): every array equal. Skips,
test by test, where no C++ compiler works, as the JAX tests do."""

import importlib

import numpy as np
import pytest
import scipy.sparse as ssp

from tpusparse import random_csr
from tpusparse.plan import _inspect_numpy as j_inspect_numpy
from tpusparse.runtime import native as jnative
from tpusparse_torch import plan as tplan
from tpusparse_torch.runtime import native
from tpusparse_torch.types import CSR as TCSR

ROOT = tplan.__file__.rsplit("/tpusparse_torch/", 1)[0]


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native inspector not built (no working C++ compiler)")
    return native


def _port(j):
    import torch

    return TCSR(torch.from_numpy(np.array(j.data)), np.asarray(j.indices, np.int32),
                np.asarray(j.indptr, np.int32), tuple(j.shape))


@pytest.mark.parametrize(
    "shape,density,blocksize",
    [
        ((128, 96), 0.1, (8, 16)),
        ((1000, 777), 0.03, (16, 128)),
        ((64, 64), 0.5, (8, 8)),
        ((50, 70), 0.08, (16, 16)),  # ragged dims
        ((256, 256), 0.001, (8, 128)),  # ultra sparse
    ],
)
def test_native_matches_numpy_and_jax(lib, shape, density, blocksize):
    a = random_csr(hash((shape, density)) % 1000, shape, density)
    ip, ix = np.asarray(a.indptr), np.asarray(a.indices)
    out = lib.inspect(ip, ix, shape, blocksize)
    names = ["block_cols", "nslots", "scatter", "L", "nb"]
    for ref in (tplan._inspect_numpy(ip, ix, shape, blocksize),
                j_inspect_numpy(ip, ix, shape, blocksize)):
        for r, o, name in zip(ref, out, names):
            if isinstance(r, np.ndarray):
                np.testing.assert_array_equal(o, r, err_msg=name)
            else:
                assert o == r, name


def test_native_used_by_build_plan(lib, monkeypatch):
    calls = {"n": 0}
    orig = lib.inspect

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(lib, "inspect", counting)
    tplan.clear_plan_cache()
    tplan.build_plan(_port(random_csr(99, (64, 64), 0.1)), blocksize=(8, 16))
    assert calls["n"] == 1


def test_build_plan_without_native_gives_the_same_plan(monkeypatch):
    a = _port(random_csr(98, (96, 80), 0.07))
    tplan.clear_plan_cache()
    p1 = tplan.build_plan(a, blocksize=(16, 16))
    monkeypatch.setenv("TPUSPARSE_NO_NATIVE", "1")
    assert not native.available()
    tplan.clear_plan_cache()
    p2 = tplan.build_plan(a, blocksize=(16, 16))
    tplan.clear_plan_cache()
    for f in ("block_cols", "nslots", "scatter_idx"):
        np.testing.assert_array_equal(getattr(p1, f), getattr(p2, f), err_msg=f)
    assert (p1.ell_width, p1.nblocks) == (p2.ell_width, p2.nblocks)


def test_empty_pattern(lib):
    ip, ix = np.zeros((17,), np.int32), np.zeros((0,), np.int32)
    ref = tplan._inspect_numpy(ip, ix, (16, 32), (8, 16))
    out = lib.inspect(ip, ix, (16, 32), (8, 16))
    assert out[3] == ref[3] == 1
    np.testing.assert_array_equal(out[1], ref[1])


def test_native_aggregate_matches_jax_python(lib, monkeypatch):
    from tpusparse.amg import _aggregate, _strength_graph

    n1 = 30
    T = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n1, n1), format="csr")
    I = ssp.eye(n1, format="csr")
    a = (ssp.kron(I, T) + ssp.kron(T, I)).tocsr()
    a.sort_indices()
    rows, strong = _strength_graph(a.indptr, a.indices, a.data, 0.08)
    agg_nat, k_nat = lib.aggregate(a.indptr, a.indices, strong)
    monkeypatch.setenv("TPUSPARSE_NO_NATIVE", "1")
    agg_py, k_py = _aggregate(a.indptr, a.indices, rows, strong, a.shape[0])
    assert k_nat == k_py
    np.testing.assert_array_equal(agg_nat, agg_py)
    assert agg_nat.min() == 0 and agg_nat.max() == k_nat - 1
    assert set(np.unique(agg_nat)) == set(range(k_nat))


def test_spgemm_symbolic_matches_jax_native_and_numpy(lib):
    ts = importlib.import_module("tpusparse_torch.spgemm")
    a = ssp.random(300, 200, density=0.04, format="csr", random_state=0)
    b = ssp.random(200, 150, density=0.05, format="csr", random_state=1)
    for m in (a, b):
        m.sort_indices()
    args = (a.indptr, a.indices, b.indptr, b.indices, 300, 150)
    got = lib.spgemm_symbolic(*args)
    refs = [ts._symbolic_numpy(*args)]
    if jnative.available():
        refs.append(jnative.spgemm_symbolic(*args))
    for ref in refs:
        for g, r, name in zip(got, ref, ("c_indptr", "c_indices", "a_pos", "b_pos", "c_pos")):
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_coo_to_csr_is_a_stable_counting_sort(lib, rng):
    rows = rng.integers(0, 40, 500).astype(np.int32)
    indptr, order = lib.coo_to_csr(rows, 40)
    np.testing.assert_array_equal(order, np.argsort(rows, kind="stable"))
    np.testing.assert_array_equal(indptr[1:], np.cumsum(np.bincount(rows, minlength=40)))


@pytest.mark.parametrize("kind", ["ilu0", "ic0"])
def test_factorize_inplace_matches_jax_native(lib, kind):
    n1 = 12
    T = ssp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(n1, n1), format="csr")
    a = (ssp.kron(ssp.eye(n1), T) + ssp.kron(T, ssp.eye(n1))).tocsr()
    if kind == "ic0":
        a = ssp.tril(a).tocsr()
    a.sort_indices()
    got = a.data.astype(np.float64).copy()
    assert lib.factorize_inplace(kind, a.indptr, a.indices, got) == 0
    if jnative.available():
        want = a.data.astype(np.float64).copy()
        assert jnative.factorize_inplace(kind, a.indptr, a.indices, want) == 0
        np.testing.assert_array_equal(got, want)
    if kind == "ilu0":  # L·U reproduces A on its pattern
        lu = ssp.csr_matrix((got, a.indices, a.indptr), shape=a.shape)
        lower = ssp.tril(lu, -1) + ssp.eye(a.shape[0])
        prod = (lower @ ssp.triu(lu)).tocsr()
        mask = a.copy()
        mask.data[:] = 1.0
        np.testing.assert_allclose(prod.multiply(mask).toarray(), a.toarray(), atol=1e-12)
    with pytest.raises(ValueError, match="float64"):
        lib.factorize_inplace(kind, a.indptr, a.indices, a.data.astype(np.float32))


def test_num_threads(lib):
    assert lib.num_threads() >= 1


def test_loader_reads_and_writes_only_in_the_port_and_build():
    """The source is the port's own copy, the library goes to build/, and no
    compiler's build command names another path of the repo."""
    src = str(native.SRC)
    so = str(native.library_path())
    assert src.startswith(f"{ROOT}/tpusparse_torch/csrc/")
    assert so.startswith(f"{ROOT}/build/tpusparse_torch/")
    for cxx in native.compilers():
        paths = [p for p in native.build_command(cxx, native.library_path())[1:]
                 if p.startswith("/")]
        assert paths and all(p.startswith((f"{ROOT}/tpusparse_torch/", f"{ROOT}/build/"))
                             for p in paths)
    assert "tpusparse/runtime" not in so and f"{ROOT}/csrc/" not in src


def test_build_takes_the_next_compiler_when_cxx_fails(lib, monkeypatch, tmp_path):
    """A $CXX that cannot build the library (one without OpenMP's runtime,
    say) gives way to g++; where every compiler fails, the reason names
    each."""
    monkeypatch.setenv("CXX", "false")
    assert native.compilers() == ["false", "g++"]
    so = tmp_path / "libtsinspector_test.so"
    assert native._build(so) is None and so.exists()
    monkeypatch.setattr(native, "compilers", lambda: ["false"])
    reason = native._build(tmp_path / "libtsinspector_none.so")
    assert reason.startswith("false exited 1")
    assert not list(tmp_path.glob("*.tmp"))
