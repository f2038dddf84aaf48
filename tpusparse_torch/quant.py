"""int8 quantized SpMM and GEMM: the serving tier.

Counterpart of `tpusparse/quant.py:47-236`. The scheme is symmetric w8a8:
  - sparse weights (`QuantizedMatrix`): quantized once per (bm, bk) block,
    s_a[slot] = max|block| / 127, packed beside the plan; pad slots get
    scale 0 and contribute nothing;
  - dense activations: quantized per call, per column, t[n] = max|B[:, n]| / 127,
    so that C = (Σ_l s_a[l]·(Qa_l @ Qb)) ∘ t stays separable;
  - dense weights (`QuantizedDense`, `quantized_matmul`): per row, with an
    all-zero row given scale 1.
The quantizers take their scale and their division in the input's type and
round half to even, as `jnp.round` does, so the int8 values and scales equal
the JAX package's exactly.

The products run on the int8 kernels: `QuantizedMatrix` on the int8 block-ELL
executor (`kernels/tiled_spmm.py`, `csrc/block_ell_spmm_int8.cu`), taking the
resident entry point when the pattern re-uses the B panel (nblocks ≥
num_col_blocks) and the ring entry point otherwise, as the float `_block_exec`
does; the dense ones on the s8·s8→s32 GEMM (`kernels/gemm.py`,
`csrc/gemm_s8.cu`). Accuracy is the serving tier's (~1e-2 relative, int8's
information limit), an explicit opt-in, never a router choice.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tpusparse_torch.kernels.gemm import gemm_int8_kernel
from tpusparse_torch.kernels.tiled_spmm import (
    resident_spmm_int8_kernel,
    tiled_spmm_int8_kernel,
)
from tpusparse_torch.plan import Plan, build_plan
from tpusparse_torch.types import BSR, COO, CSR, bsr_to_csr, coo_to_csr


def over_127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as a true division. The divisor is a tensor on purpose: the
    card divides by a Python scalar as a multiply by its reciprocal, which
    rounds differently, and the scales must equal JAX's exactly."""
    return amax / torch.full_like(amax, 127.0)


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to ±127, as int8 (round half to even)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_block_values(block_vals: torch.Tensor):
    """Per-block symmetric int8 quantization of packed ELL values.

    block_vals: (num_slots, bm, bk) float. Returns (qvals int8 of the same
    shape, scales fp32 (num_slots,)). All-zero (pad) blocks get scale 0 and
    quantize to 0."""
    s = over_127(block_vals.abs().amax(dim=(1, 2)))
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return _q8(block_vals, safe[:, None, None]), s.float()


def quantize_columns(b: torch.Tensor):
    """Per-column symmetric int8 quantization of a dense (k, n) operand:
    (q int8 (k, n), t fp32 (n,)). Runs per serving call."""
    t = over_127(b.abs().amax(dim=0))
    safe = torch.where(t > 0, t, torch.ones_like(t))
    return _q8(b, safe), t.float()


def quantize_rows(a: torch.Tensor):
    """Per-row symmetric int8 quantization: (q (m, k) int8, s (m,) fp32) with
    a ≈ s[:, None]·q; an all-zero row gets scale 1."""
    if a.ndim != 2:
        raise ValueError(f"quantize_rows takes a 2-D array, got {tuple(a.shape)}")
    amax = a.abs().amax(dim=1)
    s = torch.where(amax > 0, over_127(amax), torch.ones_like(amax))
    return _q8(a, s[:, None]), s.float()


def _as_csr(a: Union[CSR, BSR, COO]) -> CSR:
    if isinstance(a, BSR):
        return bsr_to_csr(a)
    if isinstance(a, COO):
        return coo_to_csr(a)
    return a


class QuantizedMatrix:
    """Inspect-once, quantize-once sparse weight matrix for serving.

    Built from a float CSR, BSR or COO once; `qa @ b` (or `qa.matmul(b)`)
    quantizes the activations per column and runs the int8 block-ELL
    executor. `dequantize()` returns the float CSR that the int8 form
    encodes, for auditing its error.

        qa = QuantizedMatrix(a_csr)
        y = qa @ x          # x float (k, n) or (k,) -> fp32 (m, n) or (m,)

    The TPU's `vmem_bytes` (the VMEM footprint of the resident executor) is
    not carried: the CUDA kernel has no such budget.
    """

    def __init__(self, a: Union[CSR, BSR, COO], blocksize: Optional[tuple] = None):
        a = _as_csr(a)
        if not isinstance(a, CSR):
            raise TypeError(f"QuantizedMatrix needs CSR/BSR/COO, got {type(a)}")
        self.plan: Plan = build_plan(a, blocksize)
        self.shape = a.shape
        self._pattern = (a.indptr, a.indices)
        block_vals = self.plan.pack_values(a.data.float())
        self.qvals, self.scales = quantize_block_values(block_vals)

    def matmul(self, b: torch.Tensor) -> torch.Tensor:
        """C ≈ A @ B. b: float (k,) or (k, n). Returns fp32 of the same rank."""
        vec = b.ndim == 1
        if vec:
            b = b[:, None]
        if b.ndim != 2 or b.shape[0] != self.shape[1]:
            raise ValueError(f"b shape {tuple(b.shape)} incompatible with A {self.shape}")
        q, t = quantize_columns(b)
        if self.plan.nblocks >= self.plan.num_col_blocks:
            out = resident_spmm_int8_kernel(self.plan, self.qvals, self.scales, q, t)
        else:
            out = tiled_spmm_int8_kernel(self.plan, self.qvals, self.scales, q, t)
        return out[:, 0] if vec else out

    __matmul__ = matmul

    def dequantize(self) -> CSR:
        """The float CSR this int8 representation encodes (audit tool)."""
        block_vals = self.qvals.float() * self.scales[:, None, None]
        indptr, indices = self._pattern
        return CSR(data=self.plan.unpack_values(block_vals), indices=indices,
                   indptr=indptr, shape=self.shape)

    def quantization_error(self, a: Union[CSR, BSR, COO]) -> float:
        """Max relative error of the stored weights against the original."""
        dq = self.dequantize().data.detach().cpu().double().numpy()
        orig = _as_csr(a).data.detach().cpu().double().numpy()
        denom = np.abs(orig).max()
        return float(np.abs(dq - orig).max() / (denom if denom else 1.0))

    def __repr__(self):
        return (f"QuantizedMatrix(shape={self.shape}, nblocks={self.plan.nblocks}, "
                f"blocksize={self.plan.blocksize}, int8 + per-block scales)")


def quantized_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense int8 serving matmul: A quantized per row, B per column, one
    s8·s8→s32 GEMM, then the rank-1 rescale. ~1e-2 relative error, an
    explicit serving-tier opt-in."""
    qa, sa = quantize_rows(a)
    qb, sb = quantize_columns(b)
    return gemm_int8_kernel(qa, qb).float() * sa[:, None] * sb[None, :]


class QuantizedDense:
    """A dense weight held in int8 for inspect-once, serve-many matmuls: the
    weight quantized once per row, each `matmul(x)` quantizing only the
    activation panel per column and running the int8 GEMM."""

    def __init__(self, w: torch.Tensor):
        if w.ndim != 2:
            raise ValueError(f"QuantizedDense takes a 2-D weight, got {tuple(w.shape)}")
        self.qw, self.sw = quantize_rows(w)
        self.shape = tuple(w.shape)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        vec = x.ndim == 1
        if vec:
            x = x[:, None]
        if x.ndim != 2 or x.shape[0] != self.shape[1]:
            raise ValueError(f"x shape {tuple(x.shape)} incompatible with weight {self.shape}")
        qx, sx = quantize_columns(x)
        out = gemm_int8_kernel(self.qw, qx).float() * self.sw[:, None] * sx[None, :]
        return out[:, 0] if vec else out

    __matmul__ = matmul

    def dequantize(self) -> torch.Tensor:
        return self.qw.float() * self.sw[:, None]

    def __repr__(self):
        return f"QuantizedDense(shape={self.shape}, int8 + fp32 row scales)"
