"""On-device sparse matvec (ELL format) for iterative refinement.

The reference solves entirely in float64 and needs no refinement.  This
package factors in float32 by default and restores double-precision
backward error with iterative refinement; the permuted matrix is kept on
the device in padded ELL rows and the residual ``r = b - A x`` is a gather
plus a float64 elementwise reduction, so the whole refined solve stays on
the device.

ELL layout: for row i of the FULL (symmetrized) permuted pattern,
``idx[i, :] `` holds column ids (padded with n → the x dump row, which is
kept zero) and ``vals[i, :]`` the float64 values (padded with 0).

On the device the layout is split (:class:`DeviceEll`): the pattern's
``idx`` and ``src`` are uploaded once per pattern and device, each factor's
nnz(A) lower-CSC values are on the device once (kept by ``api.factor``
from its assembly, or uploaded by :meth:`DeviceEll.values` for a factor
made from host arrays), and each product forms ``vals`` from them by one
gather through ``src``, equal to :func:`ell_vals` bit for bit.  Resident
for one factor: 8·n·kmax + 8·(nnz + 1) bytes, never more than an
[n, kmax] float64 and int64 pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["EllMatrix", "DeviceEll", "build_ell", "ell_vals", "spmv",
           "index_dtype", "device_values"]

# an index tensor on the device (DeviceEll.src, the assembly map's pos and
# dst) is int32 while what it indexes has fewer elements than this, else
# int64
SRC_INT32_LIMIT = 2 ** 31


def index_dtype(count: int) -> type:
    """The NumPy dtype of indices into ``count`` elements."""
    return np.int32 if count < SRC_INT32_LIMIT else np.int64


def device_values(values: np.ndarray, device) -> torch.Tensor:
    """float64 [nnz + 1] on ``device``: ``values`` (the lower-CSC values of
    a factor, in the analysed order) and a zero for the ELL's pads."""
    nnz = len(values)
    out = torch.empty(nnz + 1, dtype=torch.float64, device=device)
    out[:nnz].copy_(torch.as_tensor(np.asarray(values, dtype=np.float64)))
    out[nnz:].zero_()
    return out


@dataclasses.dataclass
class EllMatrix:
    n: int
    kmax: int
    idx: np.ndarray        # int32 [n, kmax], pad = n
    # per-slot source position in the lower-CSC values array (for cheap
    # per-factorization value refresh); -1 = pad
    src: np.ndarray        # int64 [n, kmax]


def _full_pattern(a):
    """(rows, cols, src) triplets of the symmetrized pattern; src indexes
    the lower-CSC values array."""
    n = a.n
    colptr = np.asarray(a.colptr, dtype=np.int64)
    r = np.asarray(a.rowind, dtype=np.int64)
    c = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    src = np.arange(len(r), dtype=np.int64)
    off = r != c
    rows = np.concatenate([r, c[off]])
    cols = np.concatenate([c, r[off]])
    srcs = np.concatenate([src, src[off]])
    return rows, cols, srcs


def build_ell(a) -> EllMatrix:
    """Build the ELL index structure from a lower-CSC matrix (pattern
    only; values are refreshed per factorization via :func:`ell_vals`)."""
    n = a.n
    rows, cols, srcs = _full_pattern(a)
    order = np.argsort(rows, kind="stable")
    rows, cols, srcs = rows[order], cols[order], srcs[order]
    counts = np.bincount(rows, minlength=n)
    kmax = int(counts.max(initial=1))
    start = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(rows)) - start[rows]
    idx = np.full((n, kmax), n, dtype=np.int32)
    src = np.full((n, kmax), -1, dtype=np.int64)
    idx[rows, slot] = cols.astype(np.int32)
    src[rows, slot] = srcs
    return EllMatrix(n=n, kmax=kmax, idx=idx, src=src)


def ell_vals(ell: EllMatrix, values: np.ndarray) -> np.ndarray:
    """float64 [n, kmax] ELL values from the lower-CSC values array."""
    v = np.zeros(ell.src.shape, dtype=np.float64)
    sel = ell.src >= 0
    v[sel] = np.asarray(values, dtype=np.float64)[ell.src[sel]]
    return v


@dataclasses.dataclass
class DeviceEll:
    """The ELL pattern of one matrix pattern on one device, shared by every
    factor of it: ``idx`` as :class:`EllMatrix` has it, and ``src``, the
    slots' positions in a factor's device values (pads at nnz(A), the zero
    :func:`device_values` appends).  ``uploads`` counts the value arrays
    :meth:`values` sent to the device, ``gathers`` the residual operators
    made from them."""

    idx: torch.Tensor            # int32 [n, kmax], pad n
    src: torch.Tensor            # int32 (int64 from 2**31) [n, kmax], pad nnz
    nnz: int
    uploads: int = 0
    gathers: int = 0

    @classmethod
    def upload(cls, ell: EllMatrix, nnz: int, device) -> "DeviceEll":
        src = np.where(ell.src >= 0, ell.src, nnz).astype(
            index_dtype(nnz + 1))
        return cls(idx=torch.as_tensor(ell.idx, device=device),
                   src=torch.as_tensor(src, device=device), nnz=nnz)

    @property
    def kmax(self) -> int:
        return self.idx.shape[1]

    @property
    def nbytes(self) -> int:
        return self.idx.nbytes + self.src.nbytes

    def values(self, values: np.ndarray) -> torch.Tensor:
        """:func:`device_values` of a factor's host ``values`` on this
        pattern's device."""
        self.uploads += 1
        return device_values(values, self.idx.device)

    def matvec(self, values: torch.Tensor):
        """x ↦ A x for the factor whose device values are ``values`` (as
        :func:`device_values` lays them out): :func:`spmv` of the ELL
        values (``values`` gathered through ``src``, :func:`ell_vals`'s bit
        for bit) and the int64 ``idx``, equal to it bit for bit.  Both are
        formed inside each product and freed with it, ``x[idx]`` first and
        multiplied in place, so a product holds 8·n·kmax bytes beside
        ``x[idx]``."""
        self.gathers += 1
        shape = self.src.shape

        def apply(x):
            y = x[self.idx.long()]
            y *= values.index_select(0, self.src.view(-1)).view(shape)[
                ..., None]
            return y.sum(1)

        return apply


def spmv(vals, idx, x):
    """y = A x on the device of the tensors.  ``vals`` [n, kmax], ``idx``
    [n, kmax] int64, ``x`` [n+1, nrhs] (dump row zero); returns [n, nrhs]
    in x.dtype (use float64 inputs for refinement residuals)."""
    return (vals[..., None] * x[idx]).sum(1)
