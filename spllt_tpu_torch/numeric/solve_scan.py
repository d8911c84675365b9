"""Level-scheduled solve executor (forward / backward substitution).

Counterpart of ``spllt_tpu.numeric.solve_scan.ScanSolveExecutor``: the same
SolvePlan and the same math, as a Python loop over the plan's levels with
exact task ranges.  The right-hand side is a padded panel x[n+1, nrhs] whose
row n is a dump row that stays zero: padded row ids equal n, so a gather of
an invalid slot reads zero, and scatters are built from the valid slots
only, so the dump row is never written.

  sol : diagonal tiles → left-solve kernel (:mod:`.hopper_solve`)
  upd : off-diagonal tiles → ``torch.bmm`` + ``index_add_`` (outside any
        hand-written kernel in the JAX package as well)

The work array of a sweep is the padded rhs itself, in the pool dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .factor_scan import canonical_device, pinned_precision
from .hopper_solve import left_solve
from .solve_executor import SolveExecutor

__all__ = ["ScanSolveExecutor"]


class ScanSolveExecutor(SolveExecutor):
    """Holds the per-level index tables of one SolvePlan on ``device``."""

    def __init__(self, sp, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        self.sp = sp
        self.nb = sp.nb
        self.n = sp.n
        self.dtype = dtype
        self.device = canonical_device(device)
        self._fwd_levels = self._prep(True)
        self._bwd_levels = self._prep(False)

    @classmethod
    def of_plans(cls, symb, plan, splan, smp, dtype, device):
        return cls(splan, dtype=dtype, device=device)

    @classmethod
    def of_forest(cls, md, smp, devices, dtype):
        return ([cls(md.solve_view(d), dtype=dtype, device=dev)
                 for d, dev in enumerate(devices)],
                cls(md.solve_view(-1), dtype=dtype, device=devices[0]))

    # ------------------------------------------------------------------ #
    def _prep(self, forward: bool):
        sp, nb, n, dev = self.sp, self.nb, self.n, self.device
        p = "f" if forward else "b"
        sol_ptr, upd_ptr = getattr(sp, p + "sol_ptr"), getattr(sp, p + "upd_ptr")
        nlev = sp.nlevels_fwd if forward else sp.nlevels_bwd
        iota = np.arange(nb, dtype=np.int64)

        def dev64(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                                   device=dev)

        levels = []
        for lvl in range(1, nlev + 1):
            lv = {}
            s, e = int(sol_ptr[lvl]), int(sol_ptr[lvl + 1])
            if e > s:
                rows = np.asarray(getattr(sp, p + "sol_rows")[s:e], np.int64)
                kv = np.asarray(getattr(sp, p + "sol_k")[s:e], np.int64)
                colmask = iota[None, :] < kv[:, None]          # [K, nb]
                set_sel = np.flatnonzero(colmask & (rows < n))
                sol = {
                    "blk": dev64(getattr(sp, p + "sol_blk")[s:e]),
                    "rows": dev64(rows),
                    "kv": torch.as_tensor(kv.astype(np.int32), device=dev),
                    # exclusive writes of the solved slots
                    "set_sel": dev64(set_sel),
                    "set_rows": dev64(rows.reshape(-1)[set_sel]),
                }
                if forward:
                    # commutative below-row delta y_b − z_b
                    add_sel = np.flatnonzero(~colmask & (rows < n))
                    sol["add_sel"] = dev64(add_sel)
                    sol["add_rows"] = dev64(rows.reshape(-1)[add_sel])
                lv["sol"] = sol
            s, e = int(upd_ptr[lvl]), int(upd_ptr[lvl + 1])
            if e > s:
                rows = np.asarray(getattr(sp, p + "upd_rows")[s:e], np.int64)
                kv = np.asarray(getattr(sp, p + "upd_k")[s:e], np.int64)
                c0 = np.asarray(getattr(sp, p + "upd_c0")[s:e], np.int64)
                cmask = iota[None, :] < kv[:, None]
                cidx = np.where(cmask, c0[:, None] + iota[None, :], n)
                upd = {"blk": dev64(getattr(sp, p + "upd_blk")[s:e])}
                if forward:      # x[rows] −= tile · x[cols]
                    sel = np.flatnonzero(rows < n)
                    upd["src"] = dev64(cidx)
                    upd["out_rows"] = dev64(rows.reshape(-1)[sel])
                else:            # x[cols] −= tileᵀ · x[rows]
                    sel = np.flatnonzero(cmask)
                    upd["src"] = dev64(np.minimum(rows, n))
                    upd["out_rows"] = dev64(cidx.reshape(-1)[sel])
                upd["out_sel"] = dev64(sel)
                lv["upd"] = upd
            levels.append(lv)
        return levels

    # ------------------------------------------------------------------ #
    def _sol_op(self, pool, x, t, forward: bool):
        z = x[t["rows"]]                         # [K, nb, nrhs]
        y = left_solve(pool[t["blk"]], z, t["kv"], transpose=not forward)
        yf = y.reshape(-1, y.shape[-1])
        x[t["set_rows"]] = yf[t["set_sel"]]
        if forward:
            delta = (y - z).reshape(-1, y.shape[-1])
            x.index_add_(0, t["add_rows"], delta[t["add_sel"]])

    def _upd_op(self, pool, x, t, forward: bool):
        tiles = pool[t["blk"]]
        src = x[t["src"]]                        # [K, nb, nrhs]
        u = torch.bmm(tiles if forward else tiles.transpose(1, 2), src)
        x.index_add_(0, t["out_rows"],
                     u.reshape(-1, u.shape[-1])[t["out_sel"]], alpha=-1)

    def load(self, x):
        """A private working copy of the padded rhs in the pool dtype."""
        x = torch.as_tensor(x, device=self.device).to(self.dtype, copy=True)
        if x.shape[0] != self.n + 1:
            raise ValueError("rhs must be padded to [n+1, nrhs]")
        return x.contiguous()

    def sweep(self, pool, work, forward: bool):
        """One sweep, in place on ``work``; the products run in IEEE
        arithmetic at every precision, as the solve kernels do
        (:func:`pinned_precision`)."""
        if pool.dtype != self.dtype or pool.device != self.device:
            raise ValueError(
                f"pool must be {self.dtype} on {self.device}, got "
                f"{pool.dtype} on {pool.device}")
        with pinned_precision("highest"):
            for lv in (self._fwd_levels if forward else self._bwd_levels):
                if forward:
                    if "sol" in lv:
                        self._sol_op(pool, work, lv["sol"], True)
                    if "upd" in lv:
                        self._upd_op(pool, work, lv["upd"], True)
                else:
                    if "upd" in lv:
                        self._upd_op(pool, work, lv["upd"], False)
                    if "sol" in lv:
                        self._sol_op(pool, work, lv["sol"], False)
        return work
