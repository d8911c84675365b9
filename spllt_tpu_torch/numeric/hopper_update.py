"""Fused gather-GEMM-accumulate update of the factor pool.

Applies a batch of between-node update micro-tasks to the flat pool
[rows, nb], in place.  Micro-task t (sorted by destination tile):
``R = W_r[relr[t]]``, ``C = W_c[relc[t]]`` where W_r / W_c are the nb-row
windows of the pool starting at rows ``lor[t]`` / ``loc[t]``; a map entry of
-1 masks its row, C rows >= ``blkn[t]`` are masked; ``dst[t] −= R·Cᵀ``,
contracted over the first ``srcn[t]`` columns (the valid width of the source
block column — the pool keeps the columns beyond it at zero, so on a real
pool this is the full product).  Tasks with the same destination form one
segment.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/pallas_update.py``
(``pallas_apply_updates`` / ``_kernel`` with ``onehot_gather``); the source
is ``csrc/update.cu``, whose body ``csrc/update_compact.cuh`` the factor
stream's UPD runs launch too.  By the count of what the live rows and columns need
it is bound by bytes; in practice by the arithmetic over the live rows and
columns and, on levels of tiny tasks, by each task's latency.  Most
micro-tasks are sparse (a few dozen live rows and columns of a 128-row
tile), so :func:`tasks_to_device` packs, once per pattern, each task's live
rows and then its live columns as int32 entries ``i << 16 | rel`` (``i``
the destination row or column, ``rel`` the window-relative source row;
``eptr``/``enr``/``ent``, with ``CHAIN`` on a task whose next task has the
same destination and live rows and columns), and the kernel multiplies
only those: one thread block per destination segment loops over its tasks,
copies each task's live source rows into shared memory (16-byte
``cp.async`` in a ring of stages that runs on from task to task,
zero-filled past ``srcn``), multiplies them as a register-tiled product
over the compact rows and columns, and subtracts the sums from the
destination's live cells in place (once for a chain of flagged tasks).
Its arithmetic covers a task's live rows and columns rounded up to
``EXEC_ROWS`` and ``EXEC_COLS`` and ``srcn`` rounded up to ``EXEC_SLAB``
(``EXEC_COMPACT``: counted over the compact rows, not over aligned blocks
of the tile).  Deterministic, no atomics: a segment's tasks are applied in
their order by one block.  The JAX-format maps ``relr``/``relc`` stay in
the tables, as int16, for the plain version and the checks.

Precision.  ``Options.precision`` picks the body's product for float32
pools (:func:`body_variant`): ``'default'`` one TF32 pass on the tensor
cores (``mma.sync`` m16n8k8; the TPU kernel's DEFAULT product), its
operands rounded to TF32 as :func:`round_tf32` rounds them; ``'highest'``
and ``'high'`` the IEEE float32 product (the TPU's three-pass HIGH is no
more accurate than float32, and on the H100 a TF32×3 body was no faster
than the IEEE one).  The tensor-core body's arithmetic covers ``srcn`` rounded
up to ``EXEC_SLAB_TC``.  float64 pools multiply in IEEE float64 at every
precision.

This module also holds the port's own copy of ``build_micro_tasks`` (pure
NumPy), ``tasks_to_device``, which checks the tables and computes the
segment offsets and the packed entries, and ``edge_case_tasks``,
``compact_edge_tasks`` and ``dense_edge_tasks``, the hand-made tables of
the kernels' checks on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, load, require_cuda_tensors

__all__ = ["build_micro_tasks", "tasks_to_device", "pack_live_entries",
           "edge_case_tasks", "compact_edge_tasks", "apply_updates",
           "apply_updates_plain", "EXEC_ROWS", "EXEC_COLS", "EXEC_SLAB",
           "EXEC_COMPACT", "CHAIN", "dense_level", "dense_edge_tasks",
           "round_tf32", "body_variant", "VARIANT_TAGS", "EXEC_SLAB_TC",
           "rounding_tasks"]

# The kernel's arithmetic, per micro-task, covers its live rows and its live
# columns each rounded up to 16 (a thread's rows and columns are 16 apart)
# and srcn rounded up to 4 (one 16-byte step of the float product), at
# every nb: counted over the compact rows and columns (EXEC_COMPACT).
EXEC_ROWS, EXEC_COLS, EXEC_SLAB, EXEC_COMPACT = 16, 16, 4, True
# the tensor-core body steps through srcn 8 columns at a time (one k8 mma)
EXEC_SLAB_TC = 8
# the flag of a packed table's ``enr`` entry: the next task has the same
# destination and the same live rows and columns
CHAIN = 1 << 16
# A level whose tasks have on average at least DENSE_LIVE of nb live rows
# and live columns, in segments of at least DENSE_SEGMENT tasks on
# average, runs one block an SM (``dense``): such long chains of
# near-dense products are bound by the SM's arithmetic, and the float
# product then holds its 8 x 8 patch in registers without spills.
DENSE_LIVE, DENSE_SEGMENT = 7 / 8, 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_update_{s}": [_P] * 9 + [_I, _I, _I, _P]
        for s in ("f32", "f64", "f32_tf32")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# Options.precision -> the update body's product for float32 pools
_VARIANT = {"highest": "ieee", "high": "ieee", "default": "tf32"}
# the body's product -> (suffix of its C entry points, the launch counter
# of its wrappers: apply_updates and megakernel.mega_factorize)
VARIANT_TAGS = {"ieee": ("", "launches"), "tf32": ("_tf32", "launches_tf32")}
_TASK_KEYS = ("dst", "lor", "loc", "blkn", "srcn", "relr", "relc")
# what the kernel reads, in the order of its C arguments
_KERNEL_KEYS = ("seg_ptr", "dst", "lor", "loc", "srcn", "eptr", "enr", "ent")


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


def pack_live_entries(relr: np.ndarray, relc: np.ndarray,
                      blkn: np.ndarray, dst: np.ndarray, nb: int):
    """The kernel's packed tables of a micro-task table: per task its live
    rows (``relr >= 0``) in ascending order, then its live columns
    (``relc >= 0`` and below ``blkn``), each as the int32 entry
    ``i << 16 | rel`` (``i`` the destination row or column, ``rel`` the
    window-relative source row).  Returns ``eptr`` [K+1] (offsets),
    ``enr`` [K] (live rows, plus ``CHAIN`` where the next task has the same
    ``dst`` and the same live rows and columns: the kernel then keeps the
    sums of both in registers) and ``ent`` (the entries)."""
    relr, relc = np.asarray(relr, np.int32), np.asarray(relc, np.int32)
    dst = np.asarray(dst)
    ar = np.arange(nb, dtype=np.int32)
    live = np.concatenate(
        [relr >= 0, (relc >= 0) & (ar[None, :]
                                   < np.asarray(blkn)[:, None])], axis=1)
    code = np.concatenate([(ar << 16) | relr, (ar << 16) | relc], axis=1)
    eptr = np.zeros(len(relr) + 1, np.int64)
    np.cumsum(live.sum(1), out=eptr[1:])
    if eptr[-1] >= 2 ** 31:
        raise ValueError("update tasks: too many live entries for int32")
    chain = np.zeros(len(relr), bool)
    chain[:-1] = (dst[1:] == dst[:-1]) & (live[1:] == live[:-1]).all(1)
    enr = live[:, :nb].sum(1) + np.where(chain, CHAIN, 0)
    return (eptr.astype(np.int32), enr.astype(np.int32),
            code[live].astype(np.int32))


def dense_level(enr: np.ndarray, eptr: np.ndarray, nseg: int,
                nb: int) -> bool:
    """Whether a level's packed tables call for one block an SM (see
    ``DENSE_LIVE``)."""
    k = len(enr)
    if k == 0:
        return False
    nr = np.asarray(enr) % CHAIN
    nc = np.diff(eptr) - nr
    return bool(nr.mean() >= DENSE_LIVE * nb and nc.mean() >= DENSE_LIVE * nb
                and k >= DENSE_SEGMENT * nseg)


def tasks_to_device(tasks: dict, nb: int, pool_rows: int, device) -> dict:
    """Validate a micro-task table (NumPy, as ``build_micro_tasks`` returns
    it) and move it to ``device`` as tensors, adding ``seg_ptr`` [nseg+1]
    (the offsets of the runs of equal ``dst``) and the packed live entries
    of :func:`pack_live_entries` (``eptr``, ``enr``, ``ent``) and the
    launch choice ``dense`` (:func:`dense_level`).  ``relr`` and
    ``relc`` stay as int16 (the plain version and the checks read them).
    A table without ``srcn`` gets ``srcn = nb`` (full contraction).

    Checks what the kernel relies on: ``dst`` sorted and inside the pool,
    every rel entry in [-1, nb), every window in [0, pool_rows − nb],
    ``srcn`` in [0, nb], nb below 2**15 (the packed entries)."""
    dst = np.asarray(tasks["dst"])
    k = len(dst)
    if "srcn" not in tasks:
        tasks = dict(tasks, srcn=np.full(k, nb, np.int32))
    relr, relc = np.asarray(tasks["relr"]), np.asarray(tasks["relc"])
    if relr.shape != (k, nb) or relc.shape != (k, nb):
        raise ValueError("update tasks: relr/relc must be [K, nb]")
    if nb >= 2 ** 15:
        raise ValueError("update tasks: nb must be below 2**15")
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
    out = {nm: torch.as_tensor(np.ascontiguousarray(
        tasks[nm], np.int16 if nm in ("relr", "relc") else np.int32),
        device=device) for nm in _TASK_KEYS}
    out["seg_ptr"] = torch.as_tensor(seg_ptr, device=device)
    eptr, enr, ent = pack_live_entries(relr, relc, tasks["blkn"], dst, nb)
    for nm, a in zip(("eptr", "enr", "ent"), (eptr, enr, ent)):
        out[nm] = torch.as_tensor(a, device=device)
    out["dense"] = dense_level(enr, eptr, len(seg_ptr) - 1, nb)
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


def compact_edge_tasks(nb: int, seed: int):
    """A hand-made micro-task table (NumPy, as :func:`build_micro_tasks`
    returns it) at the edges of the kernel's packed entries, stages and
    sub-tiles, and the pool rows it needs.  Tile 0, one segment: a task with
    no live row, one with no live column, one live row and column at srcn
    1, all nb rows and columns live at srcn nb, srcn 0, then live rows and
    columns at 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255 and
    256 (those <= nb) with srcn through 3, 4, 5, 15, 16, 17, 31, 32, 33, 47,
    48, 49 and nb; tile 1, a segment of 40 random tasks; tiles 2–301, a
    level of tiny tasks (1–3 a segment, 1–5 live rows and columns, srcn
    1–8).  Three tasks of tile 0 and the last five of tile 1 have the same
    live rows and columns (chains).  Every window lies past the
    destinations."""
    rng = np.random.default_rng(seed)

    def live(count):
        rel = np.full(nb, -1)
        pos = rng.permutation(nb)[:count]
        rel[pos] = rng.integers(0, nb, count)
        return rel

    counts = [c for c in (15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                          255, 256) if c <= nb]
    srcns = [3, 4, 5, 15, 16, 17, 31, 32, 33, 47, 48, 49, nb]
    rr = [live(0), live(nb // 2), live(1), live(nb), live(nb // 3)]
    rc = [live(nb // 2), live(0), live(1), live(nb), live(nb // 3)]
    sn = [nb, nb, 1, nb, 0]
    for i, c in enumerate(counts):
        rr.append(live(c))
        rc.append(live(counts[-1 - i]))
        sn.append(min(srcns[i % len(srcns)], nb))
    # a chain: three tasks with the same live rows and columns (other
    # sources), the middle one at srcn 0
    chained = []
    for kn in (nb, 0, 17 if nb > 17 else nb):
        chained.append(len(rr))
        rr.append(np.where(rr[3] >= 0, rng.integers(0, nb, nb), -1))
        rc.append(np.where(rc[3] >= 0, rng.integers(0, nb, nb), -1))
        sn.append(kn)
    dst = [0] * len(rr)
    for i in range(40):       # the last five a chain
        if i >= 35:
            chained.append(len(rr))
            rr.append(np.where(rr[-1] >= 0, rng.integers(0, nb, nb), -1))
            rc.append(np.where(rc[-1] >= 0, rng.integers(0, nb, nb), -1))
            sn.append(int(rng.integers(0, nb + 1)))
            dst.append(1)
            continue
        rr.append(live(int(rng.integers(0, nb + 1))))
        rc.append(live(int(rng.integers(0, nb + 1))))
        sn.append(int(rng.integers(0, nb + 1)))
        dst.append(1)
    for tile in range(2, 302):
        for _ in range(int(rng.integers(1, 4))):
            rr.append(live(int(rng.integers(1, min(5, nb) + 1))))
            rc.append(live(int(rng.integers(1, min(5, nb) + 1))))
            sn.append(int(rng.integers(1, min(8, nb) + 1)))
            dst.append(tile)
    k = len(dst)
    pool_rows = 400 * nb
    lo = rng.integers(302 * nb, pool_rows - nb + 1, size=(2, k))
    blkn = np.full(k, nb)
    blkn[1::7] = rng.integers(1, nb + 1, len(blkn[1::7]))
    blkn[chained] = nb
    return {"dst": np.asarray(dst, np.int32),
            "lor": lo[0].astype(np.int32), "loc": lo[1].astype(np.int32),
            "blkn": blkn.astype(np.int32),
            "srcn": np.asarray(sn, np.int32),
            "relr": np.stack(rr).astype(np.int32),
            "relc": np.stack(rc).astype(np.int32)}, pool_rows


def dense_edge_tasks(nb: int, seed: int):
    """A hand-made level that :func:`dense_level` sends to one block an SM,
    and the pool rows it needs: 24 destination tiles, 8 tasks each, as two
    chains of 4 (all nb rows and columns live; then all but nb // 16 of
    them), srcn through 1 to nb.  Every window lies past the
    destinations."""
    rng = np.random.default_rng(seed)
    ndst, per = 24, 8
    k = ndst * per
    relr = np.tile(np.arange(nb), (k, 1))
    relc = relr.copy()
    for t in range(k):
        relr[t], relc[t] = rng.permutation(nb), rng.permutation(nb)
    drop = rng.permutation(nb)[:nb // 16]
    half = (np.arange(k) % per) >= per // 2
    relr[np.ix_(half, drop)] = -1
    relc[np.ix_(half, drop)] = -1
    pool_rows = (ndst + 64) * nb
    lo = rng.integers(ndst * nb, pool_rows - nb + 1, size=(2, k))
    return {"dst": np.repeat(np.arange(ndst), per).astype(np.int32),
            "lor": lo[0].astype(np.int32), "loc": lo[1].astype(np.int32),
            "blkn": np.full(k, nb, np.int32),
            "srcn": rng.integers(1, nb + 1, k).astype(np.int32),
            "relr": relr.astype(np.int32),
            "relc": relc.astype(np.int32)}, pool_rows


def rounding_tasks(nb: int, ntiles: int, seed: int):
    """Update tasks whose result is ``-x`` as the body rounds its operands,
    for a bit-for-bit check of the rounding on the card.  ``x``: ntiles·nb
    normal float32 values: ties of both signs (a remainder of exactly
    0x1000 below the TF32 mantissa), remainders one below and above, a
    carry into the exponent, then random bit patterns of magnitude
    2^-60–2^61.  Task t subtracts from the zero tile t the product of
    source tile ntiles + t, whose column 0 holds ``x[t·nb : (t+1)·nb]``,
    and source tile 2·ntiles, whose column 0 is 1.0, at srcn 1 (the rest
    of both is zero): one exact product and sums with zeros, so row i of
    tile t becomes ``-x[t·nb + i]`` rounded (``-round_tf32`` at 'default')
    in every column.  Returns (tasks as :func:`build_micro_tasks` returns
    them, the pool [rows, nb] float32 as NumPy, x)."""
    rng = np.random.default_rng(seed)
    bits = [(b | rem) | sign for b in (0x3F800000, 0x40490000, 0x3A124000,
                                       0x4B7FE000)
            for rem in (0x0000, 0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x3000)
            for sign in (0, 0x80000000)]
    more = ntiles * nb - len(bits)
    if more < 0:
        raise ValueError(f"rounding_tasks: ntiles * nb below {len(bits)}")
    rnd = (rng.integers(0, 2, more, dtype=np.uint64) << np.uint64(31)) \
        | (rng.integers(127 - 60, 127 + 61, more, dtype=np.uint64)
           << np.uint64(23)) \
        | rng.integers(0, 1 << 23, more, dtype=np.uint64)
    x = np.concatenate([np.array(bits, np.uint32),
                        rnd.astype(np.uint32)]).view(np.float32)
    k = ntiles
    pool = np.zeros(((2 * k + 1) * nb, nb), np.float32)
    pool[k * nb:2 * k * nb, 0] = x
    pool[2 * k * nb:, 0] = 1.0
    ar = np.tile(np.arange(nb, dtype=np.int32), (k, 1))
    tasks = {"dst": np.arange(k, dtype=np.int32),
             "lor": ((k + np.arange(k)) * nb).astype(np.int32),
             "loc": np.full(k, 2 * k * nb, np.int32),
             "blkn": np.full(k, nb, np.int32), "srcn": np.ones(k, np.int32),
             "relr": ar, "relc": ar.copy()}
    return tasks, pool, x


def body_variant(dtype: torch.dtype, precision: str) -> str:
    """The update body's product for a pool of ``dtype`` at
    ``Options.precision``: 'tf32' for float32 at 'default', else 'ieee'
    (TF32 is a float32 format, so float64 pools are 'ieee' at every
    precision)."""
    if precision not in _VARIANT:
        raise ValueError(f"unknown precision {precision!r}")
    return _VARIANT[precision] if dtype == torch.float32 else "ieee"


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: on the int32 view add
    0x1000 to the magnitude and clear the low 13 bits.  inf and nan are
    left as they are; a magnitude that rounds past the largest float
    becomes inf."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(finite, rounded, bits).view(torch.float32)


def apply_updates_plain(poolf: torch.Tensor, tasks: dict,
                        precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version (any device), in place on ``poolf`` [rows, nb]:
    indexed gathers, one batched product (of TF32-rounded operands where
    :func:`body_variant` says 'tf32'), one ``index_add_``."""
    from .factor_scan import pinned_precision

    variant = body_variant(poolf.dtype, precision)
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
    if variant == "tf32":
        r, c = round_tf32(r), round_tf32(c)
    with pinned_precision("highest"):     # IEEE products on the card too
        u = torch.bmm(r, c.transpose(1, 2))
    poolf.view(-1, nb, nb).index_add_(0, dst, u, alpha=-1)
    return poolf


def apply_updates(poolf: torch.Tensor, tasks: dict,
                  precision: str = "highest") -> torch.Tensor:
    """``poolf`` [rows, nb] float32/float64, updated in place and returned;
    ``tasks`` as :func:`tasks_to_device` returns it, on the same device;
    ``precision`` is ``Options.precision`` (:func:`body_variant`).
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    the variant (no other: a TF32 body that fails raises).  Launches count
    per variant (:data:`VARIANT_TAGS`): ``launches`` (IEEE),
    ``launches_tf32``."""
    variant = body_variant(poolf.dtype, precision)
    if poolf.device.type == "cpu":
        return apply_updates_plain(poolf, tasks, precision)
    tens = [tasks[nm] for nm in _KERNEL_KEYS]
    require_cuda_tensors("apply_updates", poolf, *tens)
    nb = poolf.shape[1]
    k = tasks["dst"].shape[0]
    if poolf.ndim != 2 or poolf.shape[0] % nb or \
            tasks["eptr"].shape != (k + 1,) or tasks["enr"].shape != (k,):
        raise ValueError("apply_updates: bad shapes")
    if poolf.dtype not in _SUFFIX or any(t.dtype != torch.int32
                                         for t in tens):
        raise ValueError("apply_updates: pool must be float32/float64 and "
                         "the task tables int32")
    nseg = tasks["seg_ptr"].shape[0] - 1
    if k == 0 or nseg <= 0:
        return poolf
    suffix, count = VARIANT_TAGS[variant]
    fn = getattr(load("update", _SIG),
                 "spllt_update_" + _SUFFIX[poolf.dtype] + suffix)
    with torch.cuda.device(poolf.device):
        status = fn(poolf.data_ptr(), *(t.data_ptr() for t in tens), nseg,
                    nb, int(tasks["dense"]),
                    torch.cuda.current_stream().cuda_stream)
    check_launch(status, "apply_updates")
    setattr(apply_updates, count, getattr(apply_updates, count) + 1)
    return poolf


apply_updates.launches = 0
apply_updates.launches_tf32 = 0
