"""Dense matmul for 2-D operands.

Counterpart of the 2-D path of `tpusparse/dense.py:100-159`. The JAX
package sends its default dense product to XLA's `dot_general` (its Pallas
GEMM is opt-in, `use_pallas_gemm=False`), so the port's counterpart is
`torch.matmul`. The fp32 tiers run with TF32 off (see `fp32_matmul`); the
'default' tier rounds both operands to bf16 first and multiplies in fp32,
the contract of the SpMM kernel.
"""

from __future__ import annotations

import torch

from tpusparse_torch.utils.config import fp32_matmul, resolve_precision


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    transa: bool = False,
    transb: bool = False,
) -> torch.Tensor:
    """op(a) @ op(b) for 2-D operands, op = transpose where the flag is set.
    Transposes are views; no operand is copied. The tier is the config's
    `precision`."""
    if a.ndim != 2 or b.ndim != 2:
        raise NotImplementedError(
            f"dense.matmul takes 2-D operands in this slice, got {tuple(a.shape)} "
            f"x {tuple(b.shape)}; the 1-D and batched forms come with "
            "ROADMAP queue 1, item 4"
        )
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
