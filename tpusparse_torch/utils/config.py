"""Framework configuration for the PyTorch/CUDA port.

Counterpart of `tpusparse/utils/config.py:19-110`. It keeps the SpMM block
defaults, the precision tiers and the switch of the dense GEMM kernel. The
TPU-only knobs (`interpret`, `vmem_limit_bytes`) and the dense Pallas GEMM
tiles (`gemm_block_*`) are not carried: the first is the Pallas
interpreter, the second a VMEM budget, the third the TPU kernel's tiling.

Device policy: every entry point that creates tensors takes `device`.
`device=None` means the CUDA card; `resolve_device` raises when there is
none, so nothing runs on the CPU unless the caller asks for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

PRECISIONS = ("high", "highest", "default")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@functools.cache
def dtype_name(dtype: torch.dtype) -> str:
    """The name JAX gives a dtype ('float32', 'bfloat16'), as the saved
    tiles' keys spell it (cached: every GEMM call asks)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class Config:
    # Block-ELL SpMM block sizes (plan block = (spmm_block_m, spmm_block_k)).
    # spmm_block_n is the reference's n-tile; the CUDA kernel tiles n itself
    # and keeps the field for parity with the JAX config.
    spmm_block_m: int = 128
    spmm_block_k: int = 128
    spmm_block_n: int = 512
    # Precision tier of the SpMM kernel and the dense ops, fp32-class and
    # never plain TF32:
    #   'high' / 'highest' -- fp32 FFMA (the GEMM kernel: 3xTF32);
    #   'default'          -- operands rounded to bf16 (RTN), fp32 accumulate.
    precision: str = "high"
    # Whether the dense ops route 2-D products through the hand-written GEMM
    # kernel (csrc/gemm.cu) instead of torch.matmul: the counterpart of the
    # JAX config's `use_pallas_gemm`.
    use_gemm_kernel: bool = False
    # Whether `ops.spmm` validates its CSR operand on every call
    # (`utils.debug.validate_csr`, a host pass), as the JAX config's field.
    debug_checks: bool = False


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config field {k!r}")
        if k == "precision" and v not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {v!r}")
        setattr(_config, k, v)
    return _config


def resolve_precision(precision: str | None) -> str:
    name = precision or _config.precision
    if name not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
    return name


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Raises RuntimeError when None is given and no card is present: the port
    never falls back to the CPU on its own. Pass device='cpu' to run the
    plain PyTorch versions.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpusparse_torch: device=None means the CUDA card, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


@contextlib.contextmanager
def fp32_matmul():
    """Run torch matmuls in true fp32 on the card: TF32 off (the default,
    stated here because the fp32 tiers depend on it), restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
