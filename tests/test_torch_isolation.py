"""The port stands alone: tpusparse_torch, chip_smoke.py, compare_trees.py,
parallel_smoke.py, the parallel tests' worker and the examples
(examples_torch/) import nothing of JAX or of the JAX package, and
`device=None` never runs on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import tpusparse_torch as tt
from tpusparse_torch import parallel as tpar
from tpusparse_torch.utils.matrices import block_sparse_csr, get_matrix

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpusparse")


def test_import_and_cpu_forward_load_no_jax():
    """The MLP forward, a BERT encoder's forward and SGD step, a 'bigbird'
    encoder's SGD step, and the serving tier (QuantizedMatrix, the dense int8
    ops, int8-KV attention, GPT and QuantizedGPT generation), a batched and
    a footprint SpMM and a dense @ CSR, a GCN Adam step and a GAT forward on
    the naive route, and the sparse algebra (a spgemm with its backward,
    sp_hadamard, from_scipy and to_torch), an AMG-CG solve on a 2-D Laplacian
    and a wide-DIA product, a RigL step and its harvested CSR, a patched
    `nn.Linear` step and `sparsify_dense_params`, a checkpoint round trip,
    and the calibration, timing, profiling, debug and retry modules, and a
    world-size-1 `parallel.sharded_spmm` on gloo, on the CPU (one thread),
    in a fresh interpreter, load no forbidden module."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import tpusparse_torch as tt\n"
        "net = tt.MnistNet('sparse', hidden=256, device='cpu')\n"
        "with torch.no_grad(): out = net(torch.zeros(4, 784))\n"
        "assert out.shape == (4, 10)\n"
        "enc = tt.BertEncoder(2, 48, 4, 96, 100, 64, attention='flash', device='cpu')\n"
        "ids = torch.randint(0, 100, (2, 40))\n"
        "opt = tt.make_train_state(enc)\n"
        "loss = tt.bert_train_step(enc, opt, ids)\n"
        "assert enc(ids).shape == (2, 40, 48) and torch.isfinite(loss)\n"
        "bb = tt.BertEncoder(2, 48, 4, 96, 100, 64, attention='bigbird', window=32,\n"
        "                    device='cpu')\n"
        "ids = torch.randint(0, 100, (2, 64))\n"
        "loss = tt.bert_train_step(bb, tt.make_train_state(bb), ids)\n"
        "assert torch.isfinite(loss)\n"
        "a = tt.CSR.from_dense(torch.eye(16), device='cpu')\n"
        "assert (tt.QuantizedMatrix(a, blocksize=(8, 8)) @ torch.ones(16, 3)).shape == (16, 3)\n"
        "assert tt.spmm(a, torch.ones(2, 16, 3), blocksize=(8, 8)).shape == (2, 16, 3)\n"
        "assert tt.spmm(a, torch.ones(16, 3), method='footprint').shape == (16, 3)\n"
        "assert (torch.ones(2, 16) @ a).shape == (2, 16)\n"
        "assert tt.quantized_matmul(torch.ones(4, 8), torch.ones(8, 2)).shape == (4, 2)\n"
        "kq, ks, vq, vs = tt.quantize_kv(torch.ones(1, 2, 8, 4), torch.ones(1, 2, 8, 4))\n"
        "assert tt.flash_attention_q8(torch.ones(1, 2, 8, 4), kq, ks, vq, vs).shape == (1, 2, 8, 4)\n"
        "gpt = tt.GPTDecoder(2, 16, 2, 32, 20, 16, device='cpu')\n"
        "ids = torch.randint(0, 20, (2, 4))\n"
        "assert tt.generate(gpt, ids, 3).shape == (2, 3)\n"
        "assert tt.quantize_gpt(gpt).generate(ids, 3).shape == (2, 3)\n"
        "from tpusparse_torch.models import gcn as gm\n"
        "adj = tt.random_graph(0, 40, avg_degree=4.0, device='cpu')\n"
        "x, y, m = torch.randn(40, 8), torch.randint(0, 3, (40,)), torch.ones(40)\n"
        "g = tt.GCN(8, hidden=(16,), num_classes=3, spmm_method='naive', device='cpu')\n"
        "loss = gm.train_step(g, gm.make_train_state(g), tt.normalized_adjacency(adj), x, y, m)\n"
        "assert torch.isfinite(loss)\n"
        "gat = tt.GAT(8, hidden=(4,), num_heads=2, num_classes=3, spmm_method='naive',\n"
        "             device='cpu')\n"
        "with torch.no_grad(): assert gat(tt.add_self_loops(adj), x).shape == (40, 3)\n"
        "import scipy.sparse as ssp\n"
        "s = tt.interop.from_scipy(ssp.random(30, 30, density=0.1, format='csr',\n"
        "                                     random_state=0, dtype='float32'), device='cpu')\n"
        "s = tt.CSR(s.data.requires_grad_(True), s.indices, s.indptr, s.shape)\n"
        "c = tt.spgemm(s, s)\n"
        "c.data.sum().backward()\n"
        "assert c.shape == (30, 30) and s.data.grad.shape == (s.nnz,)\n"
        "assert tt.sp_hadamard(s, s).nnz == s.nnz\n"
        "assert tt.interop.to_torch(c).layout == torch.sparse_csr\n"
        "from tpusparse_torch.utils.matrices import get_matrix\n"
        "lap = get_matrix('laplace2d_256', device='cpu')\n"
        "lap = tt.CSR(lap.data, lap.indices, lap.indptr, lap.shape)\n"
        "M = tt.smoothed_aggregation_setup(lap)\n"
        "rhs = torch.rand(lap.shape[0])\n"
        "xs, _ = tt.linalg.cg(tt.csr_to_dia(lap), rhs, tol=1e-6, maxiter=20, M=M)\n"
        "assert torch.isfinite(xs).all()\n"
        "w = tt.DIA(torch.rand(130, 300), list(range(-65, 65)), (300, 300))\n"
        "assert tt.dia_spmm(w, torch.rand(300)).shape == (300,)\n"
        "from tpusparse_torch.nn import rigl\n"
        "p = {'w': torch.nn.Parameter(torch.randn(12, 8)), 'b': torch.zeros(8)}\n"
        "mk = rigl.init_masks(p, 0.25, torch.Generator().manual_seed(0))\n"
        "(torch.randn(4, 12) @ p['w']).sum().backward()\n"
        "mk = rigl.rigl_update_tree(mk, p, {'w': p['w'].grad, 'b': None}, 0.3)\n"
        "assert mk['b'] is None and int(mk['w'].sum()) == 24\n"
        "assert tt.spmm(rigl.harvest_csr(p['w'], mk['w']), torch.ones(8, 2)).shape == (12, 2)\n"
        "with tt.patch_torch_linear():\n"
        "    lin = torch.nn.Linear(8, 4)\n"
        "assert isinstance(lin, tt.PatchedLinear)\n"
        "lin(torch.ones(2, 3, 8)).sum().backward()\n"
        "_, sw = tt.sparsify_dense_params(lin.state_dict(), ['weight'], density=0.5)\n"
        "assert sw['weight'].shape == (4, 8)\n"
        "import tempfile\n"
        "from tpusparse_torch.utils import checkpoint, debug, profiling, retry, timing\n"
        "d = tempfile.mkdtemp()\n"
        "checkpoint.save_checkpoint(d, 1, {'w': lin.weight.detach()})\n"
        "assert torch.equal(checkpoint.restore_checkpoint(d)['w'], lin.weight.detach())\n"
        "from tpusparse_torch import parallel\n"
        "mesh = parallel.make_mesh(device='cpu')\n"
        "rsp = parallel.shard_plan_rows(s, 1, (8, 8))\n"
        "got = parallel.sharded_spmm(rsp, s.data.detach(), torch.ones(30, 2), mesh)\n"
        "assert torch.allclose(got, tt.spmm(s, torch.ones(30, 2)).detach(), atol=1e-6)\n"
        "torch.distributed.destroy_process_group()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    return sorted((ROOT / "tpusparse_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "compare_trees.py", ROOT / "parallel_smoke.py",
        ROOT / "tests" / "torch_parallel_worker.py"] + sorted(
        (ROOT / "examples_torch").glob("*.py"))


def _example_main(stem: str):
    """examples_torch/<stem>.py's main, imported from its file."""
    import importlib.util

    sys.path.insert(0, str(ROOT / "examples_torch"))
    try:
        spec = importlib.util.spec_from_file_location(stem, ROOT / "examples_torch" / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "examples_torch"))
    return mod.main


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


ENTRY_POINTS = {
    "resolve_device": lambda: tt.resolve_device(None),
    "MnistNet": lambda: tt.MnistNet("sparse", hidden=8),
    "DenseLinear": lambda: tt.DenseLinear(4, 3),
    "SparseLinear": lambda: tt.SparseLinear.random(0, 8, 4, 0.5),
    "BlockSparseLinear": lambda: tt.BlockSparseLinear.random(0, 8, 4, 0.5),
    "SelfAttention": lambda: tt.SelfAttention(2, 4, hidden=8),
    "BertAttentionLayer": lambda: tt.BertAttentionLayer(8, 2, 16, "flash"),
    "BertEncoder": lambda: tt.BertEncoder(1, 8, 2, 16, 10, 8),
    "BertAttentionLayer.bigbird": lambda: tt.BertAttentionLayer(8, 2, 16, "bigbird"),
    "BertAttentionLayer.sparse": lambda: tt.BertAttentionLayer(8, 2, 16, "sparse"),
    "BertAttentionLayer.local": lambda: tt.BertAttentionLayer(8, 2, 16, "local"),
    "LocalAttention": lambda: tt.LocalAttention(2, 4, hidden=8),
    "SparseSelfAttention": lambda: tt.SparseSelfAttention(2, 4, hidden=8),
    "BigBirdAttention": lambda: tt.BigBirdAttention(2, 4, hidden=8),
    "LayerNorm": lambda: tt.LayerNorm(8),
    "Embed": lambda: tt.Embed(10, 8),
    "CSR.from_dense": lambda: tt.CSR.from_dense(np.eye(3, dtype=np.float32)),
    "CSR.from_scipy": lambda: tt.CSR.from_scipy(ssp.eye(3, format="csr")),
    "COO.from_dense": lambda: tt.COO.from_dense(np.eye(3, dtype=np.float32)),
    "random_csr": lambda: tt.random_csr(0, (4, 4), 0.5),
    "random_coo": lambda: tt.random_coo(0, (4, 4), 0.5),
    "random_powerlaw_csr": lambda: tt.random_powerlaw_csr(0, (4, 4), 2.0),
    "block_sparse_csr": lambda: block_sparse_csr(0, (16, 16), (8, 8), 0.5),
    "BSR.from_dense": lambda: tt.BSR.from_dense(np.eye(3, dtype=np.float32), (2, 2)),
    "GPTBlock": lambda: tt.GPTBlock(8, 2, 16),
    "GPTDecoder": lambda: tt.GPTDecoder(1, 8, 2, 16, 10, 8),
    "interop.from_scipy": lambda: tt.interop.from_scipy(ssp.eye(3, format="csr")),
    "interop.from_torch": lambda: tt.interop.from_torch(torch.eye(3)),
    "DIA.from_dense": lambda: tt.DIA.from_dense(np.eye(3, dtype=np.float32)),
    "DIA.from_scipy": lambda: tt.DIA.from_scipy(ssp.eye(3, format="dia")),
    "get_matrix": lambda: get_matrix("laplace2d_256"),
    "speye": lambda: tt.speye(3),
    "random_mask": lambda: tt.nn.rigl.random_mask(torch.Generator(), (4, 4), 0.5),
    "parallel.initialize_distributed": lambda: tpar.initialize_distributed(),
    "parallel.make_mesh": lambda: tpar.make_mesh(),
    "autotune_gemm": lambda: tt.kernels.gemm.autotune_gemm(64, 64, 64),
    "autotune_flash": lambda: tt.kernels.flash_attention.autotune_flash(128, 64, 2),
    **{f"examples_torch/{p.stem}": (lambda stem=p.stem: _example_main(stem)())
       for p in sorted((ROOT / "examples_torch").glob("0*.py"))},
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_none_means_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so device=None rightly runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
