"""Dense matmul: transpose flags, 1-D, 2-D, batched and mixed-rank operands,
and the two-operand fp32 einsum.

Counterpart of `tpusparse/dense.py:78-159`. As in the JAX package
(dense.py:129-133), a 2-D product goes to the hand-written GEMM kernel
(`kernels/gemm.py`, `csrc/gemm.cu`) when `use_kernel` or the config's
`use_gemm_kernel` asks for it, and otherwise to the framework's own
product, here `torch.matmul`. Every other rank (1-D, batched, mixed) goes to
`torch.matmul` whatever the switch says, as the JAX package sends them to
XLA and never to `gemm_pallas` (dense.py:125-138). The fp32 tiers run with
TF32 off (see `fp32_matmul`); the 'default' tier rounds both operands to
bf16 first and multiplies in fp32, the contract of the kernels.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels.gemm import gemm_kernel
from tpusparse_torch.utils.config import fp32_matmul, get_config, resolve_precision


def _stored(x: torch.Tensor, trans: bool):
    """(contiguous operand, flag) for the GEMM kernel: a transposed view is
    passed as its contiguous storage with the flag flipped, so no copy is
    made; any other strided view is copied."""
    if x.is_contiguous():
        return x, trans
    if x.transpose(0, 1).is_contiguous():
        return x.transpose(0, 1), not trans
    return x.contiguous(), trans


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.matmul` at the config's tier: TF32 off, and the 'default'
    tier rounds both operands to bf16 first."""
    if resolve_precision(None) == "default":
        out_dtype = torch.result_type(a, b)
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
        with fp32_matmul():
            return torch.matmul(a, b).to(out_dtype)
    with fp32_matmul():
        return torch.matmul(a, b)


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand einsum at the config's tier with an fp32 result (JAX's
    `preferred_element_type=float32`): TF32 off, and the 'default' tier
    rounds both operands to bf16 first."""
    if resolve_precision(None) == "default":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    with fp32_matmul():
        return torch.einsum(spec, a.float(), b.float())


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    transa: bool = False,
    transb: bool = False,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """op(a) @ op(b), op = transpose of the last two dims where the flag is
    set; ranks and broadcasting as `torch.matmul` (the reference's 1-D
    fallback, 2-D, batched and mixed-rank forms). The tier is the config's
    `precision`.

    use_kernel: True routes a 2-D product to the GEMM kernel, False to
    `torch.matmul`, None (default) follows the config's `use_gemm_kernel`;
    other ranks always go to `torch.matmul`. The kernel route records no
    gradient: for autograd use the `ops.mm` family, which runs its forward
    and backward products through here.
    """
    # flags on a 1-D operand mean nothing and are rejected, so that the 1-D
    # path never drops a requested transpose of the other operand
    if transa and a.ndim < 2:
        raise ValueError("transa requires a ≥2-D left operand")
    if transb and b.ndim < 2:
        raise ValueError("transb requires a ≥2-D right operand")
    if a.ndim == 2 and b.ndim == 2 and (
        use_kernel or (use_kernel is None and get_config().use_gemm_kernel)
    ):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            raise RuntimeError(
                "dense.matmul's GEMM kernel route records no gradient; use "
                "tpusparse_torch.ops.mm / transa_mm / transb_mm / transab_mm"
            )
        a, transa = _stored(a, transa)
        b, transb = _stored(b, transb)
        return gemm_kernel(a, b, transa=transa, transb=transb)
    if transa:
        a = a.transpose(-1, -2)
    if transb:
        b = b.transpose(-1, -2)
    return _mm(a, b)


def bmm(
    a: torch.Tensor,
    b: torch.Tensor,
    transa: bool = False,
    transb: bool = False,
) -> torch.Tensor:
    """Strictly batched matmul: both operands ≥3-D with equal batch dims
    (any number of them)."""
    if a.ndim < 3 or b.ndim < 3:
        raise ValueError(
            f"bmm expects ≥3-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError(
            f"bmm batch dims must match: {tuple(a.shape[:-2])} vs {tuple(b.shape[:-2])}"
        )
    return matmul(a, b, transa=transa, transb=transb)
