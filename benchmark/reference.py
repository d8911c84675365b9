"""The plain reference that decides ``correct``.

It imports torch and numpy only: nothing of the program, of ``jax`` or of
``spllt_tpu``.  From the matrix and the value sets that the benchmark made
and handed to the program, it forms A·x − b in float64 for each solution the
window returned that the seed drew for the check, and reads the backward
error of each right-hand side, ‖A x − b‖₂ / ‖b‖₂.  That one number judges
the factor the window produced and the refined solve that read it together:
each refinement step divides the error by the factor's own error ratio, so a
stale, partial or lower-precision factor, or an answer altered on its way
back, leaves a residual far above what the refined float64 solution reaches.
"""

from __future__ import annotations

import numpy as np
import torch


class Reference:
    """A·x in float64 on ``device`` for every value set of one pattern."""

    def __init__(self, n: int, colptr: np.ndarray, rowind: np.ndarray,
                 value_sets: list, device):
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
        off = rowind != cols
        self.n = n
        self.device = torch.device(device)
        self.rows = torch.as_tensor(
            np.concatenate([rowind, cols[off]]), device=self.device)
        self.cols = torch.as_tensor(
            np.concatenate([cols, rowind[off]]), device=self.device)
        self.vals = [torch.as_tensor(np.concatenate([v, v[off]]),
                                     dtype=torch.float64, device=self.device)
                     for v in value_sets]

    def matvec(self, k: int, x: torch.Tensor) -> torch.Tensor:
        """A_k x for x [n, nrhs] float64 on the device."""
        y = torch.zeros_like(x)
        return y.index_add_(0, self.rows, self.vals[k][:, None] * x[self.cols])

    def backward_errors(self, k: int, x: np.ndarray, b: np.ndarray):
        """‖A_k x − b‖₂ / ‖b‖₂ of each column (inf where x is not finite or
        not of b's shape)."""
        x = np.asarray(x)
        if x.shape != b.shape:
            return [float("inf")]
        xt = torch.as_tensor(x.reshape(self.n, -1), dtype=torch.float64,
                             device=self.device)
        bt = torch.as_tensor(b.reshape(self.n, -1), dtype=torch.float64,
                             device=self.device)
        r = torch.linalg.vector_norm(self.matvec(k, xt) - bt, dim=0)
        errs = (r / torch.linalg.vector_norm(bt, dim=0)).cpu().tolist()
        return [e if np.isfinite(e) else float("inf") for e in errs]
