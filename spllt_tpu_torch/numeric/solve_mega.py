"""One direction of the triangular solve as one stream kernel.

Executes the panel-space micro-task stream of :mod:`..plan.solve_mega` on a
work array ``work[P + X, nrhs]`` (row major: P rows of per-node partial-sum
panels, then the right-hand side in node-padded order ``xp``); the factor
pool is only read.  ``solve_stream`` flattens one direction's runs into flat
int32 tables, ``mega_solve`` executes them, ``MegaSolveExecutor`` wraps both
directions behind the interface of :class:`.solve_scan.ScanSolveExecutor`.

Tables of one direction:

  run_ptr [R+1], run_kind [R]   task range and kind of each run
  wA, wS, dst, aux [K]          per task: pool window, source window and
                                destination window (row bases) and aux
                                (SOL/SOLT: the tile's factor columns)
  rel [K_addg, nb]              row maps of the ADDG tasks
  run_rel [R]                   ADDG run r: task t has rel row t − run_rel[r]
  seg_ptr, run_seg [R+1]        ADDG/MM/MMT run r:
                                seg_ptr[run_seg[r]:run_seg[r+1]] are the
                                task offsets of its runs of equal dst
  run_split [R]                 1, 2 or 4: how much finer the kernel cuts
                                the work items of a run with few of them
                                (MM/MMT: destination bands of 128 / split
                                rows; SOL/SOLT: rhs chunks of
                                max(16, 64 / split) columns)

What crosses over from ``spllt_tpu.numeric.solve_mega`` is the plan's run
list.  Its ``chunk_solve_runs`` (runs padded to a group size, NOOP steps,
first/last bits per destination group, chunks of one shape), the transposed
work layout, the window indices in place of row bases and the padding of
nrhs to a multiple of 8 serve the TPU's sequential grid and its alignment
rules and have no counterpart here.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/solve_mega.py``
(``mega_solve_chunks`` / ``_kernel`` / ``onehot_gather_right``); the source
is ``csrc/mega_solve.cu``.  Its bytes bound (every factor tile the stream
names read once for 2·nb²·nrhs operations) is far below what a sweep takes:
a sweep is a chain of a few hundred dependent runs, most with fewer work
items than the card has blocks, so each run costs a grid barrier plus the
latency of its slowest item.  One persistent cooperative launch per
direction loops over the runs; whichever block is free takes a run's next
work item from a counter (ADDG: one destination segment; MM/MMT: one
segment and band of up to 128 destination rows, the tile streamed through a
ring of ``cp.async`` panel slots into register-tiled sums; SOL/SOLT: one
tile, its first kv columns staged at once and solved in panels of 32
columns, the result written to the panel window and its xp slot), and a
grid barrier at each run boundary orders the runs.  The SOL body is the
kernel's own; the batched left solve keeps ``csrc/solve_body.cuh``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..plan.solve_mega import (KIND_ADDG, KIND_MM, KIND_MMT, KIND_SOL,
                               KIND_SOLT, build_solve_mega_plan)
from ._build import check_launch, load, require_cuda_tensors
from .factor_scan import canonical_device
from .hopper_solve import left_solve_plain
from .megakernel import segment_offsets, tables_to_device
from .spmv import spmv

__all__ = ["solve_stream", "stream_to_device", "work_items", "mega_solve",
           "mega_solve_plain", "edge_case_runs", "MegaSolveExecutor"]

_TASK_KEYS = ("wA", "wS", "dst", "aux")
_DEV_KEYS = ("run_ptr", "run_kind", "run_seg", "run_rel", "run_split",
             "seg_ptr",
             "wA", "wS", "dst", "aux", "rel")
_ADD_KINDS = (KIND_ADDG, KIND_MM, KIND_MMT)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_mega_solve_{s}":
        [_P] * 14 + [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int), _P]
        for s in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# The kernel's work items, mirrored here (csrc/mega_solve.cu): rhs chunks
# of up to CHUNK columns, MM/MMT destination bands of up to BAND rows, and
# the blocks a launch typically has (two an SM of an H100), below which a
# run's items are cut finer (run_split).
CHUNK, BAND, BLOCKS = 64, 128, 264


def solve_stream(runs, nb: int, pool_rows: int, work_rows: int) -> dict:
    """Flatten the runs of one direction (``SolveMegaPlan.fwd_runs`` or
    ``bwd_runs``: dicts with kind, wA, wS, dst, aux, rel) into the flat
    tables of the module docstring (NumPy int32).  Raises ``ValueError``
    when a table breaks what the kernel relies on: windows inside the pool
    and the work array, work windows nb-aligned, ``dst`` sorted inside an
    ADDG/MM/MMT run, map entries in [-1, nb), ``aux`` in [0, nb]."""
    run_ptr, run_kind, run_seg, run_rel, run_split = [0], [], [0], [], []
    seg_ptr, rel_all = [], []
    cols = {k: [] for k in _TASK_KEYS}
    ntask = nrel = nsegent = 0
    hi = {"wA": pool_rows - nb, "wS": work_rows - nb, "dst": work_rows - nb,
          "aux": nb}
    for run in runs:
        kind = int(run["kind"])
        if kind not in _ADD_KINDS + (KIND_SOL, KIND_SOLT):
            raise ValueError(f"solve stream: unknown kind {kind}")
        k = len(run["dst"])
        for nm in _TASK_KEYS:
            a = np.asarray(run[nm], np.int64)
            if a.shape != (k,):
                raise ValueError(f"solve stream: {nm} must be [{k}]")
            if k and (a.min() < 0 or a.max() > hi[nm]):
                raise ValueError(
                    f"solve stream: {nm} outside [0, {hi[nm]}]")
            if nm in ("wS", "dst") and (a % nb).any():
                raise ValueError(f"solve stream: {nm} is not nb-aligned")
            cols[nm].append(a)
        run_rel.append(ntask - nrel)
        if kind in _ADD_KINDS:
            dst = np.asarray(run["dst"], np.int64)
            if (np.diff(dst) < 0).any():
                raise ValueError("solve stream: dst must be sorted inside "
                                 "an ADDG/MM/MMT run")
            seg = segment_offsets(dst, ntask)
            seg_ptr.append(seg)
            nsegent += len(seg)
        if kind == KIND_ADDG:
            rel = np.asarray(run["rel"])
            if rel.shape != (k, nb):
                raise ValueError("solve stream: rel must be [K, nb]")
            if k and (rel.min() < -1 or rel.max() >= nb):
                raise ValueError("solve stream: rel outside [-1, nb)")
            rel_all.append(rel.astype(np.int32))
            nrel += k
        ntask += k
        run_ptr.append(ntask)
        run_kind.append(kind)
        run_seg.append(nsegent)
        # MM/MMT: one item a destination segment; SOL/SOLT: one a tile
        items = (len(seg) - 1 if kind in (KIND_MM, KIND_MMT)
                 else k if kind in (KIND_SOL, KIND_SOLT) else BLOCKS)
        run_split.append(4 if 4 * items <= BLOCKS
                         else 2 if 2 * items <= BLOCKS else 1)

    def cat(parts, shape=(0,)):
        return (np.concatenate(parts) if parts
                else np.empty(shape, np.int64)).astype(np.int32)

    out = {nm: cat(cols[nm]) for nm in _TASK_KEYS}
    out.update(run_ptr=np.asarray(run_ptr, np.int32),
               run_kind=np.asarray(run_kind, np.int32),
               run_seg=np.asarray(run_seg, np.int32),
               run_rel=np.asarray(run_rel, np.int32),
               run_split=np.asarray(run_split, np.int32),
               seg_ptr=cat(seg_ptr), rel=cat(rel_all, (0, nb)), nb=nb,
               pool_rows=pool_rows, work_rows=work_rows)
    return out


def work_items(stream: dict, nrhs: int, itemsize: int = 4) -> list:
    """The work items of each run as the kernel forms them at ``nrhs``
    columns of ``itemsize``-byte values: per run a list of (first, count,
    c0, rc, row0, nrow) - ``count`` consecutive destination segments of
    the run from the ``first`` (ADDG: as many as fill at most half a block
    of 256 threads in 16-byte vectors, or in elements where the rows do not
    line up; MM/MMT: one) or one tile (SOL/SOLT: ``first`` is its task
    offset in the run), rhs columns [c0, c0 + rc) and destination rows
    [row0, row0 + nrow) of the nb-row windows."""
    h = stream["host"]
    nb = stream["nb"]
    split = stream["run_split"]
    split = (split.cpu().numpy() if isinstance(split, torch.Tensor)
             else np.asarray(split))
    vec = 16 // itemsize
    zcap = min(CHUNK, nrhs)
    per = nb * (zcap // vec if nrhs * itemsize % 16 == 0 else zcap)
    group = max(1, 256 // per)
    out = []
    for r, kind in enumerate(h["run_kind"]):
        items = []
        nseg = max(int(h["run_seg"][r + 1]) - int(h["run_seg"][r]) - 1, 0)
        if kind in (KIND_SOL, KIND_SOLT):
            cw = max(16, CHUNK // int(split[r]))
            for t in range(int(h["run_ptr"][r + 1]) - int(h["run_ptr"][r])):
                for c0 in range(0, nrhs, cw):
                    items.append((t, 1, c0, min(cw, nrhs - c0), 0, nb))
        elif kind == KIND_ADDG:
            for g0 in range(0, nseg, group):
                for c0 in range(0, nrhs, CHUNK):
                    items.append((g0, min(group, nseg - g0), c0,
                                  min(CHUNK, nrhs - c0), 0, nb))
        else:
            band = BAND // int(split[r])
            for seg in range(nseg):
                for c0 in range(0, nrhs, CHUNK):
                    for b0 in range(0, nb, band):
                        items.append((seg, 1, c0, min(CHUNK, nrhs - c0), b0,
                                      min(band, nb - b0)))
        out.append(items)
    return out


def edge_case_runs(nb: int, seed: int):
    """A hand-made solve stream at tile size ``nb`` for the kernel's edge
    checks: SOL and SOLT tiles with kv 0, 1, 31, 32, 33, 127, 128 and nb
    (those <= nb: the edges of the 32-column panels of the blocked
    substitution), ADDG and MM/MMT segments of 1 to 3 tasks and an
    all-masked ADDG task, chained so that each run reads windows the run
    before wrote.  Returns (runs, kvs, pool tiles, work rows); pool tiles
    0..len(kvs)-1 are to hold factored diagonal tiles with those kv (lower
    triangle of the first kv columns, zero beyond), the others any
    values."""
    rng = np.random.default_rng(seed)
    kvs = sorted({kv for kv in (0, 1, 31, 32, 33, 127, 128, nb) if kv <= nb})
    k = len(kvs)
    extra = 3 * k                 # windows extra .. extra + 7: scratch

    def win(*ids):
        return np.asarray(ids, np.int64) * nb

    def zero(n, width=None):
        return np.zeros(n if width is None else (n, width),
                        np.int64 if width is None else np.int32)

    rel = rng.integers(-1, nb, size=(4, nb)).astype(np.int32)
    rel[1, :] = -1                                   # an all-masked task
    runs = [
        # ADDG: segments of 1 and 3 tasks into SOL's first two sources
        dict(kind=KIND_ADDG, wA=zero(4),
             wS=win(extra, extra + 1, extra + 2, extra + 3),
             dst=win(0, 1, 1, 1), aux=zero(4), rel=rel),
        # MM: segments of 1, 2 and 3 tasks into SOL's sources
        dict(kind=KIND_MM, wA=win(*range(k, k + 6)),
             wS=win(*[extra + 4 + i % 4 for i in range(6)]),
             dst=win(0, 2, 2, k - 1, k - 1, k - 1), aux=zero(6),
             rel=zero(6, nb)),
        # SOL: tile i solves window i, its result also goes to window k + i
        dict(kind=KIND_SOL, wA=win(*range(k)), wS=win(*range(k)),
             dst=win(*range(k, 2 * k)), aux=np.asarray(kvs, np.int64),
             rel=zero(k, nb)),
        # SOLT: on SOL's results, into windows 2k + i
        dict(kind=KIND_SOLT, wA=win(*range(k)), wS=win(*range(k, 2 * k)),
             dst=win(*range(2 * k, 3 * k)), aux=np.asarray(kvs, np.int64),
             rel=zero(k, nb)),
        # MMT: from SOLT's results into the scratch windows
        dict(kind=KIND_MMT, wA=win(*range(k + 5, k - 1, -1)),
             wS=win(*[2 * k + i % k for i in range(6)]),
             dst=win(extra, extra, extra + 5, extra + 5, extra + 5,
                     extra + 7), aux=zero(6), rel=zero(6, nb)),
    ]
    return runs, kvs, k + 6, (extra + 8) * nb


def stream_to_device(stream: dict, device) -> dict:
    """The solve stream's tables on ``device`` (see
    :func:`.megakernel.tables_to_device`)."""
    return tables_to_device(stream, _DEV_KEYS,
                            ("nb", "pool_rows", "work_rows"), device)


def mega_solve_plain(poolf: torch.Tensor, work: torch.Tensor,
                     stream: dict) -> torch.Tensor:
    """Plain PyTorch version (any device), in place on ``work``
    [P + X, nrhs]: a loop over the runs with indexed gathers, batched
    products, ``index_add_`` and the plain left solve."""
    nb = stream["nb"]
    nrhs = work.shape[1]
    pool = poolf.view(-1, nb, nb)
    win = work.view(-1, nb, nrhs)                  # nb-aligned windows
    h = stream["host"]
    zero = torch.zeros((), dtype=work.dtype, device=work.device)
    for r, kind in enumerate(h["run_kind"]):
        t0, t1 = int(h["run_ptr"][r]), int(h["run_ptr"][r + 1])
        sl = slice(t0, t1)
        src = (stream["wS"][sl] // nb).to(torch.int64)
        dst = (stream["dst"][sl] // nb).to(torch.int64)
        if kind == KIND_ADDG:
            off = int(h["run_rel"][r])
            rel = stream["rel"][t0 - off:t1 - off].to(torch.int64)
            rows = stream["wS"][sl].to(torch.int64)[:, None] \
                + rel.clamp(min=0)
            u = torch.where((rel >= 0)[..., None], work[rows], zero)
            win.index_add_(0, dst, u)
        elif kind in (KIND_MM, KIND_MMT):
            blk = pool[(stream["wA"][sl] // nb).to(torch.int64)]
            if kind == KIND_MMT:
                blk = blk.transpose(1, 2)
            win.index_add_(0, dst, torch.bmm(blk, win[src]), alpha=-1)
        else:
            y = left_solve_plain(
                pool[(stream["wA"][sl] // nb).to(torch.int64)], win[src],
                stream["aux"][sl], kind == KIND_SOLT)
            win[src] = y
            win[dst] = y
    return work


def mega_solve(poolf: torch.Tensor, work: torch.Tensor, stream: dict,
               max_blocks: int = 0) -> torch.Tensor:
    """One direction: ``poolf`` [rows, nb] (read), ``work`` [P + X, nrhs]
    (updated in place and returned), both float32 or both float64;
    ``stream`` as :func:`stream_to_device` returns it, on the same device.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``max_blocks`` > 0 caps the kernel's grid (tests of the item loops);
    the number of blocks launched is left in ``mega_solve.last_grid``."""
    if work.device.type == "cpu":
        return mega_solve_plain(poolf, work, stream)
    tens = [stream[k] for k in _DEV_KEYS]
    require_cuda_tensors("mega_solve", work, poolf, *tens)
    nb = stream["nb"]
    if poolf.ndim != 2 or poolf.shape != (stream["pool_rows"], nb) \
            or work.ndim != 2 or work.shape[0] != stream["work_rows"]:
        raise ValueError(
            f"mega_solve: pool must be [{stream['pool_rows']}, {nb}] and "
            f"work [{stream['work_rows']}, nrhs], got "
            f"{tuple(poolf.shape)}, {tuple(work.shape)}")
    if work.dtype not in _SUFFIX or poolf.dtype != work.dtype \
            or any(t.dtype != torch.int32 for t in tens):
        raise ValueError("mega_solve: pool and work must both be float32 or "
                         "float64 and the stream tables int32")
    nruns = stream["run_kind"].shape[0]
    if nruns == 0 or work.shape[1] == 0:
        return work
    fn = getattr(load("mega_solve", _SIG),
                 "spllt_mega_solve_" + _SUFFIX[work.dtype])
    grid = ctypes.c_int(0)
    # one work-item counter per run, zero at launch
    counters = torch.zeros(nruns, dtype=torch.int32, device=work.device)
    with torch.cuda.device(work.device):
        status = fn(poolf.data_ptr(), work.data_ptr(),
                    *(t.data_ptr() for t in tens), counters.data_ptr(),
                    nruns, nb, work.shape[1],
                    int(max_blocks), ctypes.byref(grid),
                    torch.cuda.current_stream().cuda_stream)
    check_launch(status, "mega_solve")
    mega_solve.launches += 1
    mega_solve.last_grid = grid.value
    return work


mega_solve.launches = 0
mega_solve.last_grid = 0


class MegaSolveExecutor:
    """Holds the solve streams of both directions on ``device``;
    call-compatible with :class:`.solve_scan.ScanSolveExecutor`.

    ``nrhs`` is recorded for the caller's cache key; the tables serve any
    number of right-hand sides.  ``smp`` is a ``SolveMegaPlan`` built
    earlier for the same (symb, plan), else it is built here.  float32 and
    float64 are both taken (one kernel template), at any nb."""

    def __init__(self, symb, plan, nrhs: int,
                 dtype: torch.dtype = torch.float32,
                 matmul_precision: str = "highest", device="cuda",
                 smp=None):
        if dtype not in _SUFFIX:
            raise ValueError(f"the solve stream kernel takes float32 or "
                             f"float64, not {dtype}")
        self.smp = smp if smp is not None else build_solve_mega_plan(symb,
                                                                     plan)
        self.nb = plan.nb
        self.n = symb.n
        self.nrhs = nrhs
        self.dtype = dtype
        self.precision = matmul_precision
        self.device = canonical_device(device)
        smp = self.smp
        self.pool_rows = (plan.nblocks + 1) * plan.nb
        self.work_rows = smp.P + smp.X
        self._streams = tuple(
            stream_to_device(solve_stream(runs, self.nb, self.pool_rows,
                                          self.work_rows), self.device)
            for runs in (smp.fwd_runs, smp.bwd_runs))
        self._xp_src = torch.as_tensor(smp.xp_src, device=self.device)
        self._col_to_xp = torch.as_tensor(smp.col_to_xp, device=self.device)

    # ------------------------------------------------------------------ #
    def _pool(self, pool):
        if pool.dtype != self.dtype or pool.device != self.device \
                or not pool.is_contiguous():
            raise ValueError(
                f"pool must be contiguous {self.dtype} on {self.device}, "
                f"got {pool.dtype} on {pool.device}")
        poolf = pool.view(-1, self.nb)
        if poolf.shape[0] != self.pool_rows:
            raise ValueError("pool must be [nblocks+1, nb, nb] (with the "
                             "trailing zero block)")
        return poolf

    def _work(self, x):
        """A new work array: zero panels, then x [n+1, nrhs] (row n is the
        zero dump row) gathered into node-padded order."""
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        if x.ndim != 2 or x.shape[0] != self.n + 1:
            raise ValueError("rhs must be padded to [n+1, nrhs]")
        work = torch.empty((self.work_rows, x.shape[1]), dtype=self.dtype,
                           device=self.device)
        work[:self.smp.P] = 0
        work[self.smp.P:] = x[self._xp_src]
        return work

    def _out(self, work):
        out = torch.zeros((self.n + 1, work.shape[1]), dtype=self.dtype,
                          device=self.device)
        out[:self.n] = work[self.smp.P:][self._col_to_xp]
        return out

    def _sweep(self, poolf, work, forward: bool):
        return mega_solve(poolf, work, self._streams[0 if forward else 1])

    # pool: [nblocks+1, nb, nb] factor; x: [n+1, nrhs] padded rhs (tensor
    # or array; not modified).  Each returns a new [n+1, nrhs] tensor.

    def fwd(self, pool, x):
        return self._out(self._sweep(self._pool(pool), self._work(x), True))

    def bwd(self, pool, x):
        return self._out(self._sweep(self._pool(pool), self._work(x), False))

    def full(self, pool, x):
        """L y = x; Lᵀ z = y (job=0)."""
        poolf = self._pool(pool)
        work = self._sweep(poolf, self._work(x), True)
        work[:self.smp.P] = 0          # the panels start every sweep at zero
        return self._out(self._sweep(poolf, work, False))

    def full_refined(self, pool, b64, vals64, idx, refine: int):
        """Refined A x = b, all on the device.  ``b64`` is the permuted
        rhs [n+1, nrhs] float64 (dump row zero), ``vals64``/``idx`` the ELL
        matrix (float64 / int64 tensors).  Starts from x = 0 and applies
        ``refine + 1`` times ``x += solve(b − A x)``; returns float64
        [n+1, nrhs]."""
        n = self.n
        b64 = torch.as_tensor(b64, device=self.device).to(torch.float64)
        x64 = torch.zeros_like(b64)
        rp = torch.zeros_like(b64)               # dump row stays zero
        for _ in range(refine + 1):
            rp[:n] = b64[:n] - spmv(vals64, idx, x64)
            x64 += self.full(pool, rp).to(torch.float64)
        return x64
