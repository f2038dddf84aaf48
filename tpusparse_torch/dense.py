"""Dense matmul for 2-D operands.

Counterpart of the 2-D path of `tpusparse/dense.py:100-159`. As in the JAX
package (dense.py:129-133), a 2-D product goes to the hand-written GEMM
kernel (`kernels/gemm.py`, `csrc/gemm.cu`) when `use_kernel` or the
config's `use_gemm_kernel` asks for it, and otherwise to the framework's
own product, here `torch.matmul`. The fp32 tiers run with TF32 off (see
`fp32_matmul`); the 'default' tier rounds both operands to bf16 first and
multiplies in fp32, the contract of the kernels.
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


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    transa: bool = False,
    transb: bool = False,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """op(a) @ op(b) for 2-D operands, op = transpose where the flag is set.
    The tier is the config's `precision`.

    use_kernel: True routes the product to the GEMM kernel, False to
    `torch.matmul`, None (default) follows the config's `use_gemm_kernel`.
    The kernel route records no gradient: for autograd use the `ops.mm`
    family, which runs its forward and backward products through here.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise NotImplementedError(
            f"dense.matmul takes 2-D operands in this slice, got {tuple(a.shape)} "
            f"x {tuple(b.shape)}; the 1-D and batched forms come with "
            "ROADMAP queue 1, item 4"
        )
    if use_kernel or (use_kernel is None and get_config().use_gemm_kernel):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            raise RuntimeError(
                "dense.matmul's GEMM kernel route records no gradient; use "
                "tpusparse_torch.ops.mm / transa_mm / transb_mm / transab_mm"
            )
        a, transa = _stored(a, transa)
        b, transb = _stored(b, transb)
        return gemm_kernel(a, b, transa=transa, transb=transb)
    if transa:
        a = a.transpose(0, 1)
    if transb:
        b = b.transpose(0, 1)
    if resolve_precision(None) == "default":
        out_dtype = torch.result_type(a, b)
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
        with fp32_matmul():
            return torch.matmul(a, b).to(out_dtype)
    with fp32_matmul():
        return torch.matmul(a, b)
