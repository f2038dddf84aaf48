"""Interop: convert between the port's sparse arrays and the formats a
PyTorch user already holds: torch tensors (dense, sparse COO, CSR, BSR) and
scipy.sparse matrices.

Counterpart of `tpusparse/interop.py:55-189` (`from_torch`, `to_torch`,
`from_scipy`, `to_scipy`). Conversion is a one-time step at the boundary:
patterns land on the host (numpy int32, ready for the inspectors) and
values land on `device` (None = the CUDA card), as with every constructor
of the port. `to_torch` leaves the values on their device.

Not carried: `from_bcoo`, `to_bcoo`, `from_bcsr` and `to_bcsr` convert
`jax.experimental.sparse` types, and the port imports nothing of JAX. A
`dia_matrix` comes back as a DIA, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.types import BSR, COO, CSR, DIA, host_numpy
from tpusparse_torch.utils.config import resolve_device

_INT = np.int32


def _index(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(_INT)


def _values(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(resolve_device(device))


def _check_block_multiple(a: BSR, opname: str):
    bm, bn = a.blocksize
    if a.shape[0] % bm or a.shape[1] % bn:
        raise ValueError(
            f"{opname}: torch/scipy BSR need shape to be a block multiple; "
            f"got {a.shape} with blocks {a.blocksize} (a BSR here pads "
            "logically; convert via bsr_to_csr first)"
        )


def from_torch(t: torch.Tensor, device=None):
    """torch tensor -> the port's sparse array, values on `device`.

    Layouts: `strided` (dense) -> CSR via `CSR.from_dense`; `sparse_coo` ->
    COO (coalesced); `sparse_csr` -> CSR; `sparse_bsr` -> BSR. 2-D only:
    convert a batch per matrix and combine with `block_diag` or `vstack`.
    """
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"from_torch expects a torch.Tensor, got {type(t)}")
    if t.dim() != 2:
        raise ValueError(f"from_torch supports 2-D tensors, got shape {tuple(t.shape)}")
    shape = tuple(int(s) for s in t.shape)
    layout = t.layout
    if layout == torch.strided:
        return CSR.from_dense(t.detach().cpu(), device=device)
    if layout == torch.sparse_coo:
        tc = t.coalesce()
        idx = _index(tc.indices())
        return COO(data=_values(tc.values(), device), row=idx[0], col=idx[1], shape=shape)
    if layout == torch.sparse_csr:
        return CSR(data=_values(t.values(), device), indices=_index(t.col_indices()),
                   indptr=_index(t.crow_indices()), shape=shape)
    if layout == torch.sparse_bsr:
        vals = t.values()  # (nblocks, bm, bn)
        return BSR(data=_values(vals, device), indices=_index(t.col_indices()),
                   indptr=_index(t.crow_indices()), shape=shape,
                   blocksize=(int(vals.shape[1]), int(vals.shape[2])))
    raise ValueError(f"unsupported torch layout {layout}")


def to_torch(a):
    """The port's sparse array -> the torch sparse tensor of the matching
    layout (CSR -> sparse_csr, COO -> sparse_coo, BSR -> sparse_bsr), on
    the values' device."""
    if isinstance(a, (CSR, BSR)):
        if isinstance(a, BSR):
            _check_block_multiple(a, "to_torch")
        dev = a.data.device
        make = torch.sparse_csr_tensor if isinstance(a, CSR) else torch.sparse_bsr_tensor
        return make(
            torch.from_numpy(np.asarray(a.indptr, np.int64)).to(dev),
            torch.from_numpy(np.asarray(a.indices, np.int64)).to(dev),
            a.data,
            size=a.shape,
        )
    if isinstance(a, COO):
        idx = torch.from_numpy(np.stack([a.row, a.col]).astype(np.int64))
        return torch.sparse_coo_tensor(idx.to(a.data.device), a.data, size=a.shape).coalesce()
    raise TypeError(f"to_torch expects CSR/COO/BSR, got {type(a)}")


def from_scipy(sp, device=None):
    """scipy.sparse matrix -> the port's sparse array, values on `device`:
    bsr -> BSR (its blocks kept, indices sorted), dia -> DIA, coo -> COO,
    csr, csc and the other formats -> CSR."""
    import scipy.sparse as ssp

    shape = tuple(int(s) for s in sp.shape)
    if isinstance(sp, ssp.bsr_matrix):
        sp = sp.sorted_indices()
        return BSR(data=_values(sp.data, device), indices=sp.indices.astype(_INT),
                   indptr=sp.indptr.astype(_INT), shape=shape,
                   blocksize=(int(sp.blocksize[0]), int(sp.blocksize[1])))
    if isinstance(sp, ssp.dia_matrix):
        return DIA.from_scipy(sp, device=device)
    if isinstance(sp, ssp.coo_matrix):
        return COO(data=_values(sp.data, device), row=sp.row.astype(_INT),
                   col=sp.col.astype(_INT), shape=shape)
    return CSR.from_scipy(sp.tocsr(), device=device)


def to_scipy(a):
    """The port's sparse array -> the matching scipy.sparse matrix (values
    copied to the host)."""
    import scipy.sparse as ssp

    if isinstance(a, (CSR, DIA)):
        return a.to_scipy()
    if isinstance(a, COO):
        return ssp.coo_matrix((host_numpy(a.data), (a.row, a.col)), shape=a.shape)
    if isinstance(a, BSR):
        _check_block_multiple(a, "to_scipy")
        return ssp.bsr_matrix((host_numpy(a.data), a.indices, a.indptr),
                              shape=a.shape, blocksize=a.blocksize)
    raise TypeError(f"to_scipy expects CSR/COO/BSR/DIA, got {type(a)}")
