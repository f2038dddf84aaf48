"""Serving and real data: int8 serving, real-matrix ingestion, BigBird
block-flash attention, arg-tracking reducers, the router's cost constants,
dense int8 serving, attention routing and quantized GPT serving.

Covers the serving/deployment story the reference's inspect-once /
multiply-many lifecycle points at (custom_mm.cpp:283-357), extended with
quantization, Matrix Market data, and block-sparse fused attention.

    python examples_torch/07_serving_and_real_matrices.py     # on the card
    main(device='cpu')                                         # the plain versions
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import scipy.sparse as ssp
import torch

import tpusparse_torch as tt
from _common import host, launches_since
from tpusparse_torch import kernels
from tpusparse_torch.models import GPTDecoder, quantize_gpt
from tpusparse_torch.nn import (
    BigBirdAttention,
    bigbird_block_mask,
    local_global_pattern,
    route_sparse_attention,
)
from tpusparse_torch.ops import _route_spmm
from tpusparse_torch.utils.matrices import describe, get_matrix, load_mtx, save_mtx

GPT = dict(num_layers=2, hidden=64, num_heads=4, intermediate=128, vocab_size=100,
           max_position=32)
BIGBIRD = dict(num_heads=2, head_dim=16, block=32, window_blocks=3, num_global_blocks=1,
               num_random_blocks=1)


def inputs() -> dict:
    """Every operand, from numpy seeds (the JAX example's draws, in its
    order; the argmax case's CSR from the port's numpy generator)."""
    rng = np.random.default_rng(0)
    w_sp = ssp.random(256, 512, 0.1, format="csr",
                      random_state=np.random.RandomState(1)).astype(np.float32)
    w_sp.sort_indices()
    x = rng.standard_normal((512, 32)).astype(np.float32)
    a_small = tt.random_csr(3, (32, 48), 0.1, device="cpu").to_scipy()
    bmat = rng.standard_normal((48, 8)).astype(np.float32)
    h = rng.standard_normal((2, 128, 32)).astype(np.float32)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    xd = rng.standard_normal((256, 16)).astype(np.float32)
    ids = rng.integers(0, 100, (1, 8)).astype(np.int64)
    return dict(w_sp=w_sp, x=x, a_small=a_small, bmat=bmat, h=h, w=w, xd=xd, ids=ids)


def bigbird(device) -> BigBirdAttention:
    """The BigBird layer, weights from a seeded generator."""
    return BigBirdAttention(**BIGBIRD, hidden=32, device=device,
                            generator=torch.Generator().manual_seed(0))


def gpt(device) -> GPTDecoder:
    """The float GPT decoder, weights from a seeded generator."""
    return GPTDecoder(**GPT, device=device, generator=torch.Generator().manual_seed(1))


def serve_gpt(model: GPTDecoder, ids: torch.Tensor):
    """(int8 prefill logits, float logits, 4 generated ids) of the model
    quantized for serving (int8 weights, int8 KV cache)."""
    qgpt = quantize_gpt(model)
    with torch.no_grad():
        lg_q, _ = qgpt.prefill(ids)
        lg_f = model(ids)
        toks = qgpt.generate(ids, 4)
    return lg_q, lg_f, toks


def _rel(got, ref) -> float:
    ref = host(ref)
    return float(np.abs(host(got) - ref).max() / np.abs(ref).max())


def main(device=None) -> dict:
    dev = tt.resolve_device(device)
    inp = inputs()
    t = lambda name: torch.from_numpy(inp[name]).to(dev)
    fig, out = {}, {}
    before = kernels.launches_by_kernel()

    # --- int8 serving: quantize the sparse weight ONCE, stream activations ----
    # (per-block weight scales, per-column activation scales; the int8
    # block-ELL executor on the s8 tensor cores, exact int32 sums)
    w_csr = tt.CSR.from_scipy(inp["w_sp"], device=dev)
    qa = tt.QuantizedMatrix(w_csr, blocksize=(8, 16))
    y8 = qa @ t("x")
    fig["int8_rel"] = _rel(y8, inp["w_sp"].toarray().astype(np.float64) @ host(inp["x"]))
    print(f"int8 serving rel err: {fig['int8_rel']:.2e}")
    if not fig["int8_rel"] < 2e-2:
        raise AssertionError(f"int8 serving: rel err {fig['int8_rel']}")
    fig["weight_audit"] = qa.quantization_error(w_csr)
    print(f"weight storage audit: {fig['weight_audit']:.2e}")
    out["int8"] = host(y8)

    # --- real matrices: Matrix Market files or the stand-in catalog ----------
    A = get_matrix("laplace2d_256", device=dev)  # or any .mtx / .mtx.gz path
    fig["describe"] = describe("laplace2d_256")
    print(fig["describe"])
    v = torch.ones((A.shape[1],), dtype=torch.float32, device=dev)
    y = tt.spmm(A, v)  # the router sends the banded FEM class to DIA
    fig["fem_route"] = _route_spmm(A, v[:, None], None)
    print("router choice for the FEM stencil:", fig["fem_route"])
    ref_y = A.to_scipy().astype(np.float64) @ np.ones(A.shape[1])
    if not np.abs(host(y) - ref_y).max() < 1e-3:
        raise AssertionError("the FEM stencil's product is off")
    out["fem"] = host(y)

    # round trip through a .mtx.gz file
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "lap.mtx.gz")
        small = get_matrix("blocked_4k", device=dev)
        save_mtx(p, small)
        back = load_mtx(p, device=dev)
        if (back.to_scipy() != small.to_scipy()).nnz != 0:
            raise AssertionError("the Matrix Market round trip changed the matrix")
    print("Matrix Market round-trip ok")

    # --- arg-tracking reducers (the reference kernel's arg_out contract) ------
    a_small = tt.CSR.from_scipy(inp["a_small"], device=dev)
    vals, arg = tt.spmm(a_small, t("bmat"), reduce="max", return_arg=True)
    evals, earg = tt.spmm_reference(a_small, t("bmat"), reduce="max", return_arg=True)
    if not torch.equal(arg, earg):
        raise AssertionError("argmax SpMM disagrees with spmm_reference")
    print("argmax SpMM matches the reference contract (nnz index per extremum)")
    out.update(argmax_vals=host(vals), argmax=arg.cpu().numpy())

    # --- BigBird block-pattern flash attention --------------------------------
    # window + global + random blocks fused into the flash kernel: unlisted
    # kv blocks are never read, compute scales with the pattern's density
    layer = bigbird(dev)
    with torch.no_grad():
        bb = layer(t("h"))
    if not bool(torch.isfinite(bb).all()):
        raise AssertionError("BigBird attention: non-finite output")
    mask = bigbird_block_mask(128, block=32)
    fig["bigbird_density"] = float(mask.mean())
    print(f"BigBird attention: {mask.mean():.0%} of blocks computed, output {tuple(bb.shape)}")
    out["bigbird"] = host(bb)

    # --- the router's cost model -----------------------------------------------
    # tt.calibrate() measures the constants on the card and saves them; here
    # we only show the constants in effect for this device (a saved fit for
    # this card's name applies to its tensors)
    consts = tt.ops.get_cost_constants(dev)
    fig["cost_constants"] = consts
    print(f"router constants in effect: dense {consts['dense_fp32_flops'] / 1e12:.0f} "
          f"TFLOP/s, gather {consts['gather_row_bw'] / 1e9:.0f} GB/s, "
          f"dia {consts['dia_bw'] / 1e9:.0f} GB/s")

    # --- dense int8 serving: the precision ladder's serving rung ---------------
    # per-row weight scales quantized ONCE, per-column activation scales per
    # call, one exact s8 x s8 -> s32 product on the tensor cores
    qd = tt.QuantizedDense(t("w"))
    yd = qd @ t("xd")
    fig["dense_int8_rel"] = _rel(yd, host(inp["w"]) @ host(inp["xd"]))
    if not fig["dense_int8_rel"] < 5e-2:
        raise AssertionError(f"QuantizedDense: rel err {fig['dense_int8_rel']}")
    print(f"QuantizedDense serving: rel err {fig['dense_int8_rel']:.1e} "
          "(int8 information limit)")
    out["dense_int8"] = host(yd)

    # --- irregular-pattern attention routing ------------------------------------
    # ANY token-level pattern rides the best of three engines; the decision
    # and its projected costs are inspectable
    ind, ptr = local_global_pattern(1024, 40, 3)
    method, _, report = route_sparse_attention(ind, ptr, 1024)
    fig["attention_route"] = method
    print(f"attention route @seq1024 -> {method}")
    print(" ", report)

    # --- end-to-end quantized GPT serving -----------------------------------------
    # the whole-model serving artifact: int8 weights and an int8 KV cache,
    # built from a float GPTDecoder in one call
    ids = t("ids")
    lg_q, lg_f, toks = serve_gpt(gpt(dev), ids)
    fig["gpt_rel"] = _rel(lg_q, lg_f)
    if not fig["gpt_rel"] < 5e-2:
        raise AssertionError(f"QuantizedGPT: prefill rel err {fig['gpt_rel']}")
    print(f"QuantizedGPT: prefill rel err {fig['gpt_rel']:.1e} vs float model, "
          f"generated {tuple(toks.shape)} tokens (int8 weights + int8 KV cache)")
    out.update(gpt_q=host(lg_q), gpt_f=host(lg_f), tokens=toks.cpu().numpy())

    launches = launches_since(before)
    print(f"kernel launches: {launches}")
    print("07_serving_and_real_matrices: OK")
    return {**fig, "out": out, "launches": launches}


if __name__ == "__main__":
    main()
