"""Pool assembly: scatter user values into the block pool.

Analogue of ``spllt_init_node`` (zero + scatter ``val`` via the lmap,
SpLLT:src/spllt_kernels_mod.F90:2301-2364) — here a single scatter-add over
the flat pool, executed once per factorization.  ``api.factor`` assembles
through the pattern's :class:`AssemblyMap` on the pool's device;
:func:`assemble_torch` is the same pool from the plan alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spmv import device_values, index_dtype

__all__ = ["assemble_np", "assemble_torch", "assemble_upload_bytes",
           "AssemblyMap"]


def assemble_np(plan, values: np.ndarray, dtype=np.float64) -> np.ndarray:
    """NumPy pool assembly → pool[nblocks+1, nb, nb].

    The pool carries one extra trailing block (id = nblocks) that stays
    zero; it keeps pools interchangeable with ``spllt_tpu``'s, whose
    bucketed executors park padded no-op tasks there."""
    nb = plan.nb
    poolf = np.zeros(((plan.nblocks + 1) * nb, nb), dtype=dtype)
    np.add.at(poolf, (plan.asm_rowflat, plan.asm_col),
              values.astype(dtype))
    return poolf.reshape(plan.nblocks + 1, nb, nb)


def assemble_torch(plan, values, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """Device pool assembly → pool[nblocks+1, nb, nb] on ``device``.

    One ``index_put_(accumulate=True)`` on the flat pool
    [(nblocks+1)·nb, nb]; duplicate (row, col) targets add up, as
    ``np.add.at`` does in :func:`assemble_np`."""
    nb = plan.nb
    poolf = torch.zeros(((plan.nblocks + 1) * nb, nb), dtype=dtype,
                        device=device)
    rows = torch.as_tensor(np.asarray(plan.asm_rowflat, dtype=np.int64),
                           device=device)
    cols = torch.as_tensor(np.asarray(plan.asm_col, dtype=np.int64),
                           device=device)
    vals = torch.as_tensor(np.asarray(values, dtype=np.float64),
                           device=device).to(dtype)
    poolf.index_put_((rows, cols), vals, accumulate=True)
    return poolf.view(plan.nblocks + 1, nb, nb)


def assemble_upload_bytes(plan) -> int:
    """Bytes a factor sends to its device to assemble through an
    :class:`AssemblyMap`: its float64 values, in the user's order or in
    the analysed one."""
    return 8 * len(plan.asm_rowflat)


@dataclasses.dataclass(eq=False)
class AssemblyMap:
    """Where a factor's values go on one device, for one pattern and nb.

    ``dst`` holds each entry's flat index into ``pool.view(-1)``
    (``asm_rowflat·nb + asm_col``); ``pos``, the value map's positions
    (``api.ValueMap.pos``), orders a matrix's values on the device.  Each is
    int32 while what it indexes has fewer than ``spmv.SRC_INT32_LIMIT``
    elements, else int64.  With ``unique`` targets (checked once, at the
    build) the scatter is one ``index_add_`` into the zeroed pool, one add
    into zero a target: the bits of :func:`assemble_torch`'s accumulate,
    without its sort.  Duplicate targets keep ``index_put_(accumulate=True)``
    on ``dst``, which sums them in :func:`assemble_torch`'s order.

    ``gathers`` counts the factors whose values were ordered on the device,
    ``host_orders`` those ordered on the host, ``builds`` the index tensors
    made on the device (``dst``, then ``pos``)."""

    shape: tuple                 # the pool's (nblocks + 1, nb, nb)
    dst: torch.Tensor
    unique: bool
    pos: torch.Tensor | None = None
    gathers: int = 0
    host_orders: int = 0
    builds: int = 1

    @classmethod
    def build(cls, plan, device) -> "AssemblyMap":
        nb = plan.nb
        shape = (plan.nblocks + 1, nb, nb)
        dst = (np.asarray(plan.asm_rowflat, dtype=np.int64) * nb
               + np.asarray(plan.asm_col, dtype=np.int64))
        dst = torch.as_tensor(dst.astype(index_dtype(int(np.prod(shape)))),
                              device=device)
        return cls(shape=shape, dst=dst,
                   unique=len(torch.unique(dst)) == len(dst))

    @property
    def nnz(self) -> int:
        return len(self.dst)

    def add_positions(self, pos: np.ndarray) -> None:
        """Keep the value map's positions ``pos`` on the device."""
        self.pos = torch.as_tensor(
            np.asarray(pos).astype(index_dtype(self.nnz)),
            device=self.dst.device)
        self.builds += 1

    def values(self, values: np.ndarray) -> torch.Tensor:
        """The device values of a factor whose ``values`` were put in the
        analysed order on the host (:func:`.spmv.device_values`)."""
        self.host_orders += 1
        return device_values(values, self.dst.device)

    def gather(self, values: np.ndarray) -> torch.Tensor:
        """The device values of a matrix whose pattern arrays are the value
        map's: its ``values``, uploaded once as float64 in the user's order,
        put in the analysed order on the device through ``pos``; the same
        [nnz + 1] layout as :meth:`values`, bit for bit."""
        if np.shape(values) != (self.nnz,):
            raise ValueError(f"the matrix has {np.shape(values)} values, its "
                             f"pattern {self.nnz} entries")
        dev = self.dst.device
        raw = torch.as_tensor(np.asarray(values, dtype=np.float64),
                              device=dev)
        out = torch.empty(self.nnz + 1, dtype=torch.float64, device=dev)
        torch.index_select(raw, 0, self.pos, out=out[:-1])
        out[-1:].zero_()
        self.gathers += 1
        return out

    def scatter(self, values: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        """The assembled pool [nblocks+1, nb, nb] in ``dtype`` from a
        factor's device values (:meth:`values`, :meth:`gather`)."""
        poolf = torch.zeros(int(np.prod(self.shape)), dtype=dtype,
                            device=self.dst.device)
        vals = values[:-1].to(dtype)
        if self.unique:
            poolf.index_add_(0, self.dst, vals)
        else:
            poolf.index_put_((self.dst,), vals, accumulate=True)
        return poolf.view(self.shape)
