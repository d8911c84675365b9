"""The forest path's streams for ``schedule='mega'``.

Counterpart of ``spllt_tpu.parallel.forest_mega``.  The factorization needs
nothing of its own here: each device's phase-A view and the top's phase-C
view (:meth:`.forest.MultiDeviceFactor.factor_view`) go through
:func:`..numeric.megakernel.build_mega_stream` inside
:class:`..numeric.megakernel.MegaFactorExecutor` (K4), like a single
device's plan.  The solve splits the global panel-space stream
(:mod:`..plan.solve_mega`) by the device that owns each task's node (its
``own`` field): every device, and the top, gets the subsequence of each run
it owns, in stream order.  The tasks keep the global addressing of the work
array (each device sweeps a whole copy of it, and the forest merges the
copies), and their factor-tile windows ``wA`` move to the local pool.

The reference pads each device's chunks to one shape with NOOP steps and
groups of scratch tasks and limits the path to float32 and nb % 128 == 0 on
its hardware; the solve stream kernel (K6) has runs of any length, both
dtypes and any nb, so none of that is needed.
"""

from __future__ import annotations

import types

import numpy as np

__all__ = ["split_solve_runs", "device_solve_executors"]


def split_solve_runs(md, smp) -> dict:
    """{'fwd'/'bwd': ([ndev] run lists, top run list)}: the runs of the
    solve stream plan ``smp`` split by owner, empty pieces dropped, with
    ``wA`` in each device's local pool (the top's on the first device's);
    ``wA`` of the zero block maps to the local zero block."""
    part = md.part
    nb = md.nb
    nblocks = smp.P // nb - 1
    nlocal = part.nlocal
    owner = part.part_of_node

    def piece(run, sel, dev):
        blk = run["wA"][sel] // nb
        out = {k: v[sel] for k, v in run.items() if k not in ("kind", "own")}
        out["kind"] = run["kind"]
        out["wA"] = np.where(blk >= nblocks, nlocal[max(dev, 0)] - 1,
                             part.blk_local[np.minimum(blk, nblocks - 1)]
                             ) * nb
        return out

    out = {}
    for dirn, runs in (("fwd", smp.fwd_runs), ("bwd", smp.bwd_runs)):
        per = [[] for _ in range(part.ndev)]
        top = []
        for run in runs:
            own = owner[run["own"]]
            for d, dst in list(enumerate(per)) + [(-1, top)]:
                sel = own == d
                if sel.any():
                    dst.append(piece(run, sel, d))
        out[dirn] = (per, top)
    return out


def device_solve_executors(md, smp, devices, dtype):
    """([per-device MegaSolveExecutor], top MegaSolveExecutor) on the split
    runs of :func:`split_solve_runs`; each holds its device's streams of
    both directions over the local pool and the global work layout."""
    from ..numeric.solve_mega import MegaSolveExecutor

    runs = split_solve_runs(md, smp)
    symb = types.SimpleNamespace(n=md.n)

    def executor(d, dev):
        k = 0 if d < 0 else d
        plan = types.SimpleNamespace(nb=md.nb,
                                     nblocks=int(md.part.nlocal[k]) - 1)
        fwd, bwd = (runs[dirn][0][d] if d >= 0 else runs[dirn][1]
                    for dirn in ("fwd", "bwd"))
        view = types.SimpleNamespace(P=smp.P, X=smp.X, xp_src=smp.xp_src,
                                     col_to_xp=smp.col_to_xp, fwd_runs=fwd,
                                     bwd_runs=bwd)
        return MegaSolveExecutor(symb, plan, view, dtype=dtype, device=dev)

    return ([executor(d, dev) for d, dev in enumerate(devices)],
            executor(-1, devices[0]))
