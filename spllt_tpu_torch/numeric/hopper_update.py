"""Fused gather-GEMM-accumulate update of the factor pool.

Applies a batch of between-node update micro-tasks to the flat pool
[rows, nb], in place.  Micro-task t (sorted by destination tile):
``R = W_r[relr[t]]``, ``C = W_c[relc[t]]`` where W_r / W_c are the nb-row
windows of the pool starting at rows ``lor[t]`` / ``loc[t]``; a map entry of
-1 masks its row, C rows >= ``blkn[t]`` are masked; ``dst[t] −= R·Cᵀ``,
contracted over the first ``srcn[t]`` columns (the valid width of the source
block column — the pool keeps the columns beyond it at zero, so on a real
pool this is the full product).  Tasks with the same destination are summed
before one read-modify-write.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/pallas_update.py``
(``pallas_apply_updates`` / ``_kernel`` with ``onehot_gather``); the source
is ``csrc/update.cu``.  Most micro-tasks are sparse (few unmasked rows and
columns, narrow source block columns), so by the count of what the unmasked
work needs the kernel is bound by bytes, and in practice by the latency of
the dependent loads of each micro-task (its row tables, then its slabs).
The TPU kernel is a sequential grid carrying an accumulator across steps; on
the GPU blocks run in no order, so one thread block owns one destination
*segment* (the run of micro-tasks with equal ``dst``; the host computes
segment offsets) — the whole 128×128 tile at nb = 128, an 8×8 patch per
thread — loops over the segment's tasks, keeps the sum in registers and
subtracts it from the destination once: deterministic, no atomics.  The
gathers are exact indexed row loads, not one-hot products; operands are
staged through double-buffered shared-memory slabs of 8 contraction steps.
The kernel stops the contraction at ``srcn``, skips fully masked 64-wide
halves of a task, and a warp skips its 8 destination rows when they are
all masked (``EXEC_ROWS``, ``EXEC_COLS``, ``EXEC_SLAB`` state that
granularity).

This module also holds the port's own copy of ``build_micro_tasks`` (pure
NumPy), ``tasks_to_device``, which checks the tables and computes the
segment offsets, and ``edge_case_tasks``, the hand-made tables of the
kernels' checks on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, load, require_cuda_tensors

__all__ = ["build_micro_tasks", "tasks_to_device", "edge_case_tasks",
           "apply_updates", "apply_updates_plain", "EXEC_ROWS", "EXEC_COLS",
           "EXEC_SLAB"]

# The kernel's arithmetic, per micro-task, covers the aligned blocks of
# EXEC_ROWS rows and EXEC_COLS columns that hold a live entry, over srcn
# rounded up to EXEC_SLAB contraction steps (csrc/update_body.cuh: a warp's
# rows, half a 128-wide piece, one slab) — at every nb.
EXEC_ROWS, EXEC_COLS, EXEC_SLAB = 8, 64, 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_update_{s}": [_P] * 9 + [_I, _I, _P] for s in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_TASK_KEYS = ("dst", "lor", "loc", "blkn", "srcn", "relr", "relc")


def build_micro_tasks(fp, lvl_lo: int, lvl_hi: int, nb: int,
                      pool_rows: int):
    """Expand the (width-fused) updbt tasks of levels [lvl_lo, lvl_hi]
    back into per-block-column micro-tasks sorted by destination.  Each
    task carries two window bases into the flat pool [pool_rows, nb]
    (``lor`` for the row-role gather, ``loc`` for the col-role gather,
    clamped so an nb-row window stays in bounds) and two window-relative
    position-map rows ``relr``/``relc`` [nb] int32 (-1 = invalid slot).

    Returns dict: dst, lor, loc, blkn, srcn (int32 [K]) and relr, relc
    (int32 [K, nb]).  Every task fits the nb-row windows (per-tile
    position ranges are contiguous).  ``srcn`` is the one field the JAX
    package's table does not have: the number of valid columns of the
    task's source block column, beyond which the pool holds zeros.
    """
    lo_cap = pool_rows - nb
    t0, t1 = int(fp.updbt_ptr[lvl_lo]), int(fp.updbt_ptr[lvl_hi + 1])
    empty = {
        "dst": np.empty(0, np.int32), "lor": np.empty(0, np.int32),
        "loc": np.empty(0, np.int32), "blkn": np.empty(0, np.int32),
        "srcn": np.empty(0, np.int32),
        "relr": np.empty((0, nb), np.int32),
        "relc": np.empty((0, nb), np.int32),
    }
    if t1 <= t0:
        return empty
    tt = np.arange(t0, t1, dtype=np.int64)
    posr = fp.maps[fp.updbt_mr[tt]].astype(np.int64)     # [T, nb]
    posc = fp.maps[fp.updbt_mc[tt]].astype(np.int64)
    vr, vc = posr >= 0, posc >= 0
    keep = vr.any(axis=1) & vc.any(axis=1)
    tt = tt[keep]
    if len(tt) == 0:
        return empty
    posr, posc, vr, vc = posr[keep], posc[keep], vr[keep], vc[keep]
    big = np.int64(1) << 60
    pminr = np.where(vr, posr, big).min(axis=1)
    pminc = np.where(vc, posc, big).min(axis=1)
    if __debug__:
        assert int((np.where(vr, posr, -1).max(axis=1) - pminr).max()) \
            < nb, "row posns not tile-local"
        assert int((np.where(vc, posc, -1).max(axis=1) - pminc).max()) \
            < nb, "col posns not tile-local"
    cc = fp.updbt_c[tt].astype(np.int64)
    # expand each task over its kb source-column tiles
    idx = np.repeat(np.arange(len(tt), dtype=np.int64), cc)
    csum = np.concatenate([[0], np.cumsum(cc)])
    kb = np.arange(len(idx), dtype=np.int64) - csum[idx]
    srcblk = fp.srcvec[fp.updbt_svp[tt][idx] + kb]
    base = srcblk * nb
    l0r = np.minimum(base + pminr[idx], lo_cap)
    l0c = np.minimum(base + pminc[idx], lo_cap)
    dst = fp.updbt_dst[tt][idx]
    # window-relative positions (absorb the clamp shift)
    relr = np.where(vr[idx], posr[idx] + (base - l0r)[:, None],
                    -1).astype(np.int32)
    relc = np.where(vc[idx], posc[idx] + (base - l0c)[:, None],
                    -1).astype(np.int32)
    bn = fp.blk_n[dst]
    srcn = fp.blk_n[srcblk]
    order = np.argsort(dst, kind="stable")
    return {
        "dst": dst[order].astype(np.int32),
        "lor": l0r[order].astype(np.int32),
        "loc": l0c[order].astype(np.int32),
        "blkn": bn[order].astype(np.int32),
        "srcn": srcn[order].astype(np.int32),
        "relr": relr[order],
        "relc": relc[order],
    }


def tasks_to_device(tasks: dict, nb: int, pool_rows: int, device) -> dict:
    """Validate a micro-task table (NumPy, as ``build_micro_tasks`` returns
    it) and move it to ``device`` as int32 tensors, adding ``seg_ptr``
    [nseg+1]: the offsets of the runs of equal ``dst``.  A table without
    ``srcn`` gets ``srcn = nb`` (full contraction).

    Checks what the kernel relies on: ``dst`` sorted and inside the pool,
    every rel entry in [-1, nb), every window in [0, pool_rows − nb],
    ``srcn`` in [0, nb]."""
    dst = np.asarray(tasks["dst"])
    k = len(dst)
    if "srcn" not in tasks:
        tasks = dict(tasks, srcn=np.full(k, nb, np.int32))
    relr, relc = np.asarray(tasks["relr"]), np.asarray(tasks["relc"])
    if relr.shape != (k, nb) or relc.shape != (k, nb):
        raise ValueError("update tasks: relr/relc must be [K, nb]")
    if k:
        if (np.diff(dst) < 0).any():
            raise ValueError("update tasks: dst must be sorted")
        if dst.min() < 0 or (int(dst.max()) + 1) * nb > pool_rows:
            raise ValueError("update tasks: dst outside the pool")
        for nm in ("relr", "relc"):
            a = np.asarray(tasks[nm])
            if a.min() < -1 or a.max() >= nb:
                raise ValueError(f"update tasks: {nm} outside [-1, nb)")
        a = np.asarray(tasks["srcn"])
        if a.min() < 0 or a.max() > nb:
            raise ValueError("update tasks: srcn outside [0, nb]")
        for nm in ("lor", "loc"):
            a = np.asarray(tasks[nm])
            if a.min() < 0 or a.max() > pool_rows - nb:
                raise ValueError(f"update tasks: window {nm} outside "
                                 f"[0, pool_rows - nb]")
    starts = np.flatnonzero(np.diff(dst, prepend=-1)) if k else \
        np.empty(0, np.int64)
    seg_ptr = np.concatenate([starts, [k]]).astype(np.int32)
    out = {nm: torch.as_tensor(np.ascontiguousarray(tasks[nm], np.int32),
                               device=device) for nm in _TASK_KEYS}
    out["seg_ptr"] = torch.as_tensor(seg_ptr, device=device)
    return out


def edge_case_tasks(nb: int, pool_rows: int, seed: int) -> dict:
    """A hand-made micro-task table (NumPy, as :func:`build_micro_tasks`
    returns it) that stresses the kernel's masks and skip rules, for the
    checks on the card.  Destinations are tiles 0–3, every window lies
    at or above row 4·nb (so no destination is also a source):

    * tile 0, an 11-task segment: live rows scattered over the whole tile
      (every warp's rows); exactly one live row and one live column;
      every live row on one source row; an all-masked task in the middle;
      ``srcn`` through 0, 1, 15, 16, 17 and nb; ``blkn`` < nb;
    * tile 1: one dense task (identity maps, full width);
    * tile 2: three tasks with random masks and ``blkn`` of 1 and nb // 3;
    * tile 3: one task whose live rows all lie in the tile's last row and
      live columns in its first (at nb = 256 only one of the four 128 x 128
      pieces has work)."""
    rng = np.random.default_rng(seed)
    seg_len = [11, 1, 3, 1]
    k = sum(seg_len)
    ar = np.arange(nb)
    rand = lambda p: np.where(rng.random(nb) < p, rng.integers(0, nb, nb),
                              -1)
    relr = np.stack([rand(0.6) for _ in range(k)])
    relc = np.stack([rand(0.6) for _ in range(k)])
    relr[0] = np.where(ar % 3 == 1, rng.permutation(nb), -1)   # scattered
    relr[1], relc[1] = -1, -1                                  # one and one
    relr[1, nb - 1], relc[1, nb // 2] = rng.integers(0, nb, 2)
    relr[2] = np.where(ar % 3 != 1, 5, -1)                     # one source
    relr[5] = -1                                               # all masked
    relr[11] = relc[11] = ar                                   # dense
    relr[15], relc[15] = -1, -1
    relr[15, nb - 1], relc[15, 0] = 0, nb - 1
    srcn = np.full(k, nb)
    srcn[:11] = [nb, 1, 16, 15, 17, nb, 0, 16, 1, 17, nb]
    srcn[12:15] = rng.integers(1, nb + 1, 3)
    blkn = np.full(k, nb)
    blkn[[3, 7, 9]] = [nb - 1, nb // 2, 1]
    blkn[12:15] = [1, max(1, nb // 3), nb]
    lo = rng.integers(4 * nb, pool_rows - nb + 1, size=(2, k))
    lo[:, 4] = pool_rows - nb                                  # at the end
    return {"dst": np.repeat(np.arange(4), seg_len).astype(np.int32),
            "lor": lo[0].astype(np.int32), "loc": lo[1].astype(np.int32),
            "blkn": blkn.astype(np.int32), "srcn": srcn.astype(np.int32),
            "relr": relr.astype(np.int32), "relc": relc.astype(np.int32)}


def apply_updates_plain(poolf: torch.Tensor, tasks: dict) -> torch.Tensor:
    """Plain PyTorch version (any device), in place on ``poolf`` [rows, nb]:
    indexed gathers, one batched product, one ``index_add_``."""
    nb = poolf.shape[1]
    dst = tasks["dst"].to(torch.int64)
    if dst.numel() == 0:
        return poolf
    relr, relc = tasks["relr"].to(torch.int64), tasks["relc"].to(torch.int64)
    zero = torch.zeros((), dtype=poolf.dtype, device=poolf.device)
    ar = torch.arange(nb, device=poolf.device)
    vr = relr >= 0
    vc = (relc >= 0) & (ar[None, :] < tasks["blkn"].to(torch.int64)[:, None])
    kmask = ar[None, None, :] < tasks["srcn"].to(torch.int64)[:, None, None]
    rows_r = tasks["lor"].to(torch.int64)[:, None] + relr.clamp(min=0)
    rows_c = tasks["loc"].to(torch.int64)[:, None] + relc.clamp(min=0)
    r = torch.where(vr[..., None] & kmask, poolf[rows_r], zero)  # [K, nb, nb]
    c = torch.where(vc[..., None] & kmask, poolf[rows_c], zero)
    u = torch.bmm(r, c.transpose(1, 2))
    poolf.view(-1, nb, nb).index_add_(0, dst, u, alpha=-1)
    return poolf


def apply_updates(poolf: torch.Tensor, tasks: dict) -> torch.Tensor:
    """``poolf`` [rows, nb] float32/float64, updated in place and returned;
    ``tasks`` as :func:`tasks_to_device` returns it, on the same device.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if poolf.device.type == "cpu":
        return apply_updates_plain(poolf, tasks)
    tens = [tasks[nm] for nm in ("seg_ptr",) + _TASK_KEYS]
    require_cuda_tensors("apply_updates", poolf, *tens)
    nb = poolf.shape[1]
    k = tasks["dst"].shape[0]
    if poolf.ndim != 2 or poolf.shape[0] % nb or \
            tasks["relr"].shape != (k, nb) or tasks["relc"].shape != (k, nb):
        raise ValueError("apply_updates: bad shapes")
    if poolf.dtype not in _SUFFIX or any(t.dtype != torch.int32
                                         for t in tens):
        raise ValueError("apply_updates: pool must be float32/float64 and "
                         "the task tables int32")
    nseg = tasks["seg_ptr"].shape[0] - 1
    if k == 0 or nseg <= 0:
        return poolf
    fn = getattr(load("update", _SIG), "spllt_update_" + _SUFFIX[poolf.dtype])
    with torch.cuda.device(poolf.device):
        status = fn(poolf.data_ptr(), *(t.data_ptr() for t in tens), nseg,
                    nb, torch.cuda.current_stream().cuda_stream)
    check_launch(status, "apply_updates")
    apply_updates.launches += 1
    return poolf


apply_updates.launches = 0
