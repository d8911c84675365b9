"""Level-scheduled factorization executor.

Counterpart of ``spllt_tpu.numeric.factor_scan.ScanFactorExecutor``: the
same FactorPlan, the same per-level order of task kinds (updates, then
potrf, then trsm), the same result.  PyTorch runs eagerly, so the executor
is a Python loop over the plan's levels with exact task ranges — there is
no bucketing, no padding to a bucket width and no scratch-block tasks.  All
launches of one call go to the current CUDA stream, which keeps their
order; nothing synchronises until the caller reads the flag.

Per level ``1..nlevels``:

  updbt : between-node update micro-tasks → fused update kernel
          (:mod:`.hopper_update`)
  syrk  : within-node updates → ``torch.bmm`` + ``index_add_`` (the JAX
          package computes these outside any hand-written kernel as well)
  potrf : diagonal tiles → potrf kernel (:mod:`.hopper_potrf`)
  trsm  : off-diagonal tiles → trsm kernel (:mod:`.hopper_trsm`)

On CPU tensors each kernel wrapper takes its plain version.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .hopper_potrf import potrf
from .hopper_trsm import trsm
from .hopper_update import apply_updates, build_micro_tasks, tasks_to_device

__all__ = ["ScanFactorExecutor", "canonical_device", "pinned_precision"]


def canonical_device(device) -> torch.device:
    """``device`` with its CUDA index filled in ("cuda" → "cuda:0"), so it
    compares equal to the ``.device`` of tensors that live there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def pinned_precision(precision: str):
    """Run the block's float32 ``torch.bmm`` products with the precision
    ``Options.precision`` asks for, whatever the process-wide cuBLAS
    setting (``torch.backends.cuda.matmul.allow_tf32``, which
    ``torch.set_float32_matmul_precision`` also sets, or its newer form
    ``torch.backends.cuda.matmul.fp32_precision``), and restore that setting
    afterwards through the same interface.  ``'highest'`` is IEEE float32.
    ``'high'`` and ``'default'`` are IEEE float32 as well until tensor-core
    bodies port them (they are then more accurate than the reference's,
    not less)."""
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    mm = torch.backends.cuda.matmul
    try:
        prev, name, ieee = mm.allow_tf32, "allow_tf32", False
    except RuntimeError:      # the process set the newer interface
        prev, name, ieee = mm.fp32_precision, "fp32_precision", "ieee"
    setattr(mm, name, ieee)
    try:
        yield
    finally:
        setattr(mm, name, prev)


class ScanFactorExecutor:
    """Holds the per-level index tables of one FactorPlan on ``device``.

    The tables do not depend on the matrix values, so one executor serves
    every refactorization of the same pattern.  ``matmul_precision`` is
    ``Options.precision``: the products run under
    :func:`pinned_precision` (IEEE in ``dtype`` for all three values for
    now).
    """

    def __init__(self, fp, dtype: torch.dtype = torch.float32,
                 matmul_precision: str = "highest", device="cuda"):
        self.fp = fp
        self.nb = fp.nb
        self.dtype = dtype
        self.precision = matmul_precision
        self.device = canonical_device(device)
        self.pool_rows = (fp.nblocks + 1) * fp.nb
        dev = self.device

        def i64(a, s, e):
            return torch.as_tensor(np.asarray(a[s:e], dtype=np.int64),
                                   device=dev)

        def i32(a, s, e):
            return torch.as_tensor(np.asarray(a[s:e], dtype=np.int32),
                                   device=dev)

        self.levels = []
        self.num_micro_tasks = 0
        for lvl in range(1, fp.nlevels + 1):
            lv = {}
            mt = build_micro_tasks(fp, lvl, lvl, self.nb, self.pool_rows)
            if len(mt["dst"]):
                lv["upd"] = tasks_to_device(mt, self.nb, self.pool_rows, dev)
                self.num_micro_tasks += len(mt["dst"])
            s, e = int(fp.syrk_ptr[lvl]), int(fp.syrk_ptr[lvl + 1])
            if e > s:
                lv["syrk"] = (i64(fp.syrk_src_i, s, e),
                              i64(fp.syrk_src_j, s, e),
                              i64(fp.syrk_dst, s, e))
            s, e = int(fp.potrf_ptr[lvl]), int(fp.potrf_ptr[lvl + 1])
            if e > s:
                lv["potrf"] = (i64(fp.potrf_blk, s, e),
                               i32(fp.potrf_k, s, e))
            s, e = int(fp.trsm_ptr[lvl]), int(fp.trsm_ptr[lvl + 1])
            if e > s:
                lv["trsm"] = (i64(fp.trsm_diag, s, e),
                              i64(fp.trsm_dst, s, e), i32(fp.trsm_k, s, e))
            self.levels.append(lv)

    def __call__(self, pool: torch.Tensor):
        """pool: [nblocks+1, nb, nb] on the executor's device, with the
        trailing zero block (see assemble_*).  Factored IN PLACE — the pool
        is the largest object of a factorization and is never copied.
        Returns (pool, not_posdef_flag); the flag is a 0-d bool tensor
        (NaNs appear on a failed Cholesky), read it with ``bool()``."""
        fp = self.fp
        if pool.shape != (fp.nblocks + 1, self.nb, self.nb):
            raise ValueError("pool must be [nblocks+1, nb, nb] (with the "
                             "trailing zero block)")
        if pool.dtype != self.dtype or pool.device != self.device \
                or not pool.is_contiguous():
            raise ValueError(
                f"pool must be contiguous {self.dtype} on {self.device}, "
                f"got {pool.dtype} on {pool.device}")
        poolf = pool.view(-1, self.nb)
        with pinned_precision(self.precision):
            self._levels(pool, poolf)
        notpos = torch.isnan(pool[:, 0, 0].sum())
        return pool, notpos

    def _levels(self, pool, poolf):
        for lv in self.levels:
            if "upd" in lv:
                apply_updates(poolf, lv["upd"])
            if "syrk" in lv:
                si, sj, dst = lv["syrk"]
                u = torch.bmm(pool[si], pool[sj].transpose(1, 2))
                pool.index_add_(0, dst, u, alpha=-1)
            if "potrf" in lv:
                blk, kv = lv["potrf"]
                pool[blk] = potrf(pool[blk], kv)
            if "trsm" in lv:
                diag, dst, kv = lv["trsm"]
                pool[dst] = trsm(pool[diag], pool[dst], kv)
