"""Carry a numeric factor between this package and ``spllt_tpu``.

There are no weights; the state is the factor: a pool [nblocks+1, nb, nb]
of tiles plus the permuted values that were factored.  Both packages lay
the pool out identically (same plans, same trailing zero block), so a
factor computed by one can be solved with by the other.  Everything that
crosses is a NumPy array — this package imports nothing of ``spllt_tpu``.

    # spllt_tpu → spllt_tpu_torch
    num_t = numeric_from_numpy(symb_t, np.asarray(num_j.pool),
                               num_j.values_perm, options_t)
    # spllt_tpu_torch → spllt_tpu: hand numeric_to_numpy(num_t) to
    # dataclasses.replace(num_j, pool=..., values_perm=...)

A factor of the forest path (``Options(ndevices=k)``) crosses the same way
as its global pool (gathered from, or scattered into, the local pools).
The reference's own sharded pools ``[ndev, nlocal*nb, nb]`` — every local
pool padded to the longest — cross with :func:`shards_from_numpy` and
:func:`shards_to_numpy`, given the port's forest plan of the same
partition (:func:`.parallel.forest.build_multidevice_factor`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import (NumericFactor, _exec_key, _forest_executor, _forest_run,
                  _plans, _resolve_device, _resolve_devices, _torch_dtype)
from .parallel.forest import reconstruct_global_pool

__all__ = ["numeric_from_numpy", "numeric_to_numpy", "shards_from_numpy",
           "shards_to_numpy"]


def numeric_from_numpy(symb, pool_np: np.ndarray, values_perm: np.ndarray,
                       options=None) -> NumericFactor:
    """Wrap an already factored pool for this package's ``symb`` (the
    analysis of the same matrix with the same ordering and blocking).
    ``options`` defaults to ``symb.options``; its ``mode`` decides whether
    the pool is kept as a float64 NumPy array ('stf') or moved to
    ``options.device`` in ``options.dtype`` ('batched')."""
    options = options or symb.options
    plan, fplan, splan = _plans(symb, options)
    pool_np = np.asarray(pool_np)
    want = (plan.nblocks + 1, plan.nb, plan.nb)
    if pool_np.shape != want:
        raise ValueError(f"pool has shape {pool_np.shape}, the plan of this "
                         f"symbolic factor needs {want}")
    values_perm = np.asarray(values_perm)
    if values_perm.shape != symb.a_perm.values.shape:
        raise ValueError("values_perm does not match the analysed pattern")
    inform = dataclasses.replace(symb.inform)
    inform.num_blocks = plan.nblocks
    inform.num_levels = fplan.nlevels
    inform.num_tasks = fplan.num_tasks
    mdf = None
    if options.mode == "stf":
        pool = np.array(pool_np, dtype=np.float64)
        solve_execs = {}
    elif _forest_run(options):
        mdf = _forest_executor(symb, options, plan, fplan, splan,
                               _resolve_devices(options))
        part = mdf.md.part
        top = np.flatnonzero(part.blk_dev == -1)
        pool = shards_from_numpy(mdf.md, [
            pool_np[np.concatenate([top, np.flatnonzero(part.blk_dev == d)])]
            for d in range(part.ndev)], mdf.dtype, mdf.devices)
        solve_execs = {}
    else:
        dev = _resolve_device(options)
        pool = torch.tensor(pool_np, dtype=_torch_dtype(options),
                            device=dev)          # always a private copy
        solve_execs = symb._cache.setdefault(_exec_key("sex", options, dev),
                                             {})
    return NumericFactor(symb=symb, plan=plan, fplan=fplan, splan=splan,
                         pool=pool, values_perm=values_perm,
                         options=options, inform=inform,
                         _solve_execs=solve_execs, mdf=mdf)


def numeric_to_numpy(num: NumericFactor):
    """(pool [nblocks+1, nb, nb] as a NumPy array in the pool's dtype,
    values_perm) of a numeric factor (of the forest path: its global
    pool)."""
    pool = num.pool
    if num.mdf is not None:
        g = reconstruct_global_pool(num.mdf.md, pool)
        pool = np.concatenate([g, np.zeros_like(g[:1])])
    elif isinstance(pool, torch.Tensor):
        pool = pool.detach().cpu().numpy()
    return np.array(pool), np.array(num.values_perm)


def shards_from_numpy(md, pools_np, dtype: torch.dtype, devices) -> list:
    """Local pools as this package lays them out, on ``devices``, from
    per-device arrays whose first ``ntop + nown[d]`` blocks are device d's
    top and own blocks (the reference's sharded pools [ndev, nlocal*nb, nb]
    qualify: the padding after them is dropped and a zero block appended).
    """
    nb = md.nb
    part = md.part
    out = []
    for d, dev in enumerate(devices):
        keep = part.ntop + int(part.nown[d])
        blocks = np.asarray(pools_np[d]).reshape(-1, nb, nb)[:keep]
        pool = torch.zeros((keep + 1, nb, nb), dtype=dtype, device=dev)
        pool[:keep] = torch.as_tensor(blocks).to(dtype)
        out.append(pool)
    return out


def shards_to_numpy(md, pools) -> np.ndarray:
    """The local pools (tensors) in the reference's sharded layout
    [ndev, nlocal*nb, nb], nlocal = ntop + max(nown) + 1: each device's
    blocks first, zero after them."""
    nb = md.nb
    part = md.part
    nlocal = part.ntop + int(part.nown.max()) + 1
    host = [p.detach().cpu().numpy().reshape(-1, nb, nb) for p in pools]
    out = np.zeros((part.ndev, nlocal * nb, nb), dtype=host[0].dtype)
    for d, p in enumerate(host):
        keep = part.ntop + int(part.nown[d])
        out[d, :keep * nb] = p[:keep].reshape(-1, nb)
    return out
