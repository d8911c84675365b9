"""Pool assembly: scatter user values into the block pool.

Analogue of ``spllt_init_node`` (zero + scatter ``val`` via the lmap,
SpLLT:src/spllt_kernels_mod.F90:2301-2364) — here a single scatter-add over
the flat pool, executed once per factorization.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["assemble_np", "assemble_torch", "assemble_upload_bytes"]


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
    """Bytes :func:`assemble_torch` sends to its device each call: the int64
    row and column of every entry and its float64 value."""
    return 24 * len(plan.asm_rowflat)
