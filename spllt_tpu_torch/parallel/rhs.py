"""Multi-rhs solve sharded over the right-hand-side columns.

Counterpart of ``spllt_tpu.parallel.rhs``: with the factor pool copied to
every device, the padded rhs panel is split column-wise and each device
runs the level solve executor (:class:`..numeric.solve_scan.ScanSolveExecutor`:
K5 and its gathers) on its columns.  The solve is embarrassingly parallel
along nrhs: there is no exchange between the devices.  Every device's
sweeps are issued before any result is read, so distinct cards overlap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device_list

__all__ = ["solve_rhs_sharded"]


def solve_rhs_sharded(num, b: np.ndarray, devices=None,
                      ndev: int | None = None,
                      refine: int | None = None) -> np.ndarray:
    """A x = b (job 0) of a single-device batched factor with the rhs
    columns sharded over ``devices`` (default: ``ndev`` devices by the rule
    of :func:`..parallel.device_list` from the pool's device, ``ndev``
    defaulting to every visible card, or 1 on the CPU).

    ``b`` is [n, nrhs] in user ordering; nrhs is padded up to a multiple of
    the device count.  The pool is copied once to each other device and the
    copies are cached on ``num``; refinement runs in float64 on the host,
    as in :func:`..api.solve` with ``refine_device=False``."""
    from ..numeric.solve_executor import refined
    from ..numeric.solve_scan import ScanSolveExecutor

    if num.mdf is not None or not isinstance(num.pool, torch.Tensor):
        raise ValueError("solve_rhs_sharded needs a single-device factor of "
                         "mode 'batched'")
    if devices is None:
        k = ndev or (torch.cuda.device_count() if num.pool.is_cuda else 1)
        devices = device_list(num.pool.device, k)
    n = num.symb.n
    bb = np.asarray(b, dtype=np.float64).reshape(n, -1)
    nrhs = bb.shape[1]
    k = len(devices)
    width = -(-nrhs // k)

    execs = [num.symb.cache.solve_executor(num, ScanSolveExecutor, dev)
             for dev in devices]
    for ex in execs:
        if str(ex.device) not in num.rhs_pools:
            num.rhs_pools[str(ex.device)] = num.pool.to(ex.device)

    def run_once(rhs):
        xp = num.padded(rhs)
        xp = np.pad(xp, ((0, 0), (0, width * k - nrhs)))
        outs = [ex.full(num.rhs_pools[str(ex.device)],
                        np.ascontiguousarray(xp[:, i * width:(i + 1) * width]))
                for i, ex in enumerate(execs)]
        out = torch.cat([o.cpu() for o in outs], dim=1)[:, :nrhs]
        return num.unpadded(out.numpy().astype(np.float64))

    refine = num.options.refine if refine is None else refine
    return refined(run_once, lambda x: num.residual(bb, x), bb, refine)
