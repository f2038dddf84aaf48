"""Sparse linear algebra: the part the graph models use.

Counterpart of `tpusparse/linalg.py:42-50` (`speye`). The solvers and the
eigensolvers come with ROADMAP queue 1, item 6.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.types import CSR
from tpusparse_torch.utils.config import resolve_device


def speye(n: int, dtype=torch.float32, device=None) -> CSR:
    """Sparse identity I_n as CSR, values on `device` (None: the card)."""
    idx = np.arange(n, dtype=np.int32)
    return CSR(
        data=torch.ones((n,), dtype=dtype, device=resolve_device(device)),
        indices=idx,
        indptr=np.arange(n + 1, dtype=np.int32),
        shape=(n, n),
    )
