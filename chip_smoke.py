#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spllt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything, as described below
    python3 chip_smoke.py --no-large      # skip the poisson3d(64) runs
    python3 chip_smoke.py --profile FILE  # also a torch.profiler table
    python3 chip_smoke.py --solve-only    # only steps 3 and 5 for the solve
                                          # stream kernel (add --no-run-times
                                          # to time another tree's kernel)
    python3 chip_smoke.py --factor-only   # only steps 3 and 5 for the factor
                                          # stream kernel, with its item
                                          # latencies
    python3 chip_smoke.py --scan-only     # only steps 2 and 5 for the level
                                          # path: its four kernels per
                                          # launch, their device share and
                                          # single-tile latencies (add
                                          # --levels-out FILE for every
                                          # per-level row)
    python3 chip_smoke.py --entry-only    # only step 6: the entry points
    python3 chip_smoke.py --forest-only   # only step 7: Options(ndevices=k),
                                          # the rhs-sharded solve, the C API

Needs one CUDA device, ``nvcc`` and no network.  It

  1. builds the six CUDA kernels from ``spllt_tpu_torch/csrc``;
  2. drives the level path (``schedule='scan'``) through the public API only
     — analyse → factor → refined solve of poisson3d(32) at nb=128, float32,
     nrhs=4 — with every kernel's launch count set to 0 just before and read
     just after, then checks the backward error, a refactorization that must
     reuse the cached plans and executors, a factorization with TF32
     switched on for the process (precision='highest' must ignore it), the
     not-positive-definite guard and jobs 1+2 = 0;
  3. drives the stream path (``schedule='mega'``: the whole factorization as
     one kernel, each solve sweep as one kernel) the same way, with the same
     checks, and requires the stream executors to be the ones that ran;
  4. holds each kernel against its plain PyTorch version on the card: the
     four batched kernels on edge-case batches (the potrf, trsm and
     left-solve kernels also at the edges of their panels, row bands and
     chunks: kv 0, 1, 15-17, 31-33, 127 and nb, nb 8, 48, 128 and 256, one
     pair and 300, nrhs 1, 4, 63-65 and 130, float32 and float64, failed
     pivots at columns 0 and 17; the update kernel on hand-made tables at
     the edges of its packed entries, stages and sub-tiles, nb 48, 128 and
     256, two launches bit for bit equal) and at every shape the level path
     gave them (one comparison per level of the plan), the two stream
     kernels on the poisson3d(32) pool (also against the level executor's
     factor), per solve direction at nrhs 1, 4 and 64, and on edge streams
     run with 1, 3 and all blocks (the solve stream's at nrhs 1 to 128 with
     tiles whose kv sits at the edges of its 32-column panels, nb 48, 128
     and 256, float32 and float64; the factor stream's POTRF and TRSM runs
     at kv 0, 1, 31, 32, 33, 127 and nb, nb 8, 48, 128 and 256, narrow and
     wide, and a failed pivot); and times them there (CUDA events, after a
     warm-up, as the host issues the launches; the level kernels also on
     the device alone, their launches queued back to back: ``device_ms``),
     the stream kernels also run by run (``stream_run_times``,
     ``solve_run_times``: by kind, and over the runs with fewer work items
     than blocks and the others, each kind beside its bound) and the factor
     stream's single items and grid barrier (``factor_item_times``);
  5. repeats both main paths at poisson3d(64) (unless ``--no-large``),
     holding the four level kernels against their plain versions at every
     level (timed as at poisson3d(32), with the library call beside K2 and
     K5: the ``large`` part of their rows in the ``kernels`` line), the
     factor stream kernel against its plain version and the level
     executor's factor, and the solve stream kernel against its plain
     version per direction at nrhs 1, 4 and 64, with the per-run times of
     both stream kernels;
  6. drives the entry points: ``Options(coarse_subtrees=True)`` at
     poisson3d(32) and (64) (default span and waste) under both schedules —
     the dense phase's buckets, the factor against the non-coarse one, the
     refined backward error, ``factor_ms`` with and without the coarse
     layer, a front that is not positive definite, and K1 held against its
     plain version on each bucket's real fronts and timed there (rows of
     the ``kernels`` line); ``python3 -m spllt_tpu_torch`` as four
     subprocesses (64³ 'mega' and 64³ coarse 'scan' with --stats, --timers,
     --trace and --dot-tree, and a 32³ matrix through --mm and --mat at the
     amd ordering); a checkpoint saved, reloaded onto the card and solved
     bit for bit, and refactorized from its symbolic file bit for bit; and
     one 'mega' factor + solve under ``utils.tracing.device_trace``, whose
     trace must name both stream kernels.  Files go to
     ``chiprun_out/entry/``; the checkpoint and the matrix files are removed;
  7. drives the multi-device paths (``forest_phase``): ``Options(ndevices=k)``
     through ``factor``/``solve`` — on k cards when they are visible, else on
     ``factor(..., devices=[cuda:0] * k)`` after checking that
     ``Options(ndevices=k)`` raises ``ValueError`` rather than run elsewhere
     — at poisson3d(64) 'mega' k = 2 and 4 and poisson3d(32) 'scan' k = 2
     and 4, 'mega' k = 2 (twice, bit for bit) and 'mega' k = 2 in float64,
     each held against the single-device factor of its schedule (1e-5 of
     max|L|, 1e-11 in float64) with its executors per shard, its launches
     per kernel (exactly as many as the executors call for), the refined
     backward error and the times of its phases (32³ k = 2 also against the
     plain versions on the card and with a negative pivot in a shard and in
     the top); the rhs-sharded solve at poisson3d(64),
     nrhs 64, over 2 and 4 shards; and ``examples/c/simple.c`` built
     against the C interface's library (``native/capi.cpp``) and run on the
     card.

One JSON object per line; any failed check raises and the exit code is not
0.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12            # float32 outside the tensor cores
SEED = 20240607
BWD_ERR_MAX = 1e-13               # refined backward error ‖Ax−b‖/‖b‖


def emit(tag: str, **fields) -> None:
    print(json.dumps({tag: fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` by CUDA events after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_device_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the device alone: after one warm-up
    the ``reps`` calls are queued behind a sleep kernel that outlasts their
    enqueue, so the wrapper's host time (Python, ctypes, allocation) is
    hidden and the launches run back to back (each still pays the device's
    gap between two launches).  The smaller of two such passes, so that a
    stall of the host longer than the sleep does not count.
    :func:`time_ms` times the same calls as the host issues them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        # 2e9 cycles a second or fewer: the sleep lasts at least this long
        torch.cuda._sleep(int(2e9 * (3 * host_s + 2e-3)))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


def bwd_err(a, x, b) -> float:
    return float(np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b))


# --------------------------------------------------------------------- #
# main path
# --------------------------------------------------------------------- #
def kernel_wrappers():
    from spllt_tpu_torch.numeric.hopper_potrf import potrf
    from spllt_tpu_torch.numeric.hopper_solve import left_solve
    from spllt_tpu_torch.numeric.hopper_trsm import trsm
    from spllt_tpu_torch.numeric.hopper_update import apply_updates
    from spllt_tpu_torch.numeric.megakernel import mega_factorize
    from spllt_tpu_torch.numeric.solve_mega import mega_solve

    return {"potrf": potrf, "trsm": trsm, "update": apply_updates,
            "left_solve": left_solve, "mega_factor": mega_factorize,
            "mega_solve": mega_solve}


# the kernels each schedule's main path must go through, and its executors
PATH_KERNELS = {"scan": ("potrf", "trsm", "update", "left_solve"),
                "mega": ("mega_factor", "mega_solve")}
PATH_EXECUTORS = {"scan": ("ScanFactorExecutor", "ScanSolveExecutor"),
                  "mega": ("MegaFactorExecutor", "MegaSolveExecutor")}


def live_blocks(mask: torch.Tensor, g: int) -> torch.Tensor:
    """Per row of ``mask`` [K, n]: g times the number of aligned blocks of
    g entries that hold a True one."""
    k, n = mask.shape
    m = torch.zeros((k, -(-n // g) * g), dtype=torch.int8, device=mask.device)
    m[:, :n] = mask.to(torch.int8)
    return m.view(k, -1, g).amax(2).sum(1).to(torch.int64) * g


def exec_granularity(stream: bool):
    """How the update body of K3 (``stream=False``) or of K4's UPD runs
    rounds its arithmetic: (compact, rows, columns, contraction).  K3's
    body counts the live rows and columns themselves (compact), K4's body
    the aligned blocks of the tile that hold a live one.  An older tree,
    whose two kernels shared one body, states one granularity for both in
    ``hopper_update``."""
    from spllt_tpu_torch.numeric import hopper_update as hu
    from spllt_tpu_torch.numeric import megakernel as mk

    if stream and hasattr(mk, "UPD_EXEC_ROWS"):
        return False, mk.UPD_EXEC_ROWS, mk.UPD_EXEC_COLS, mk.UPD_EXEC_SLAB
    return (getattr(hu, "EXEC_COMPACT", False) and not stream,
            hu.EXEC_ROWS, hu.EXEC_COLS, hu.EXEC_SLAB)


def update_level_work(tasks: dict, nb: int, stream: bool = False) -> dict:
    """What one level's update micro-tasks need, from the executor's own
    tables: elements gathered (unmasked rows and columns, trimmed to the
    source's width), operations of the unmasked rows and columns with the
    full and with the trimmed contraction, of what the update body executes
    (:func:`exec_granularity`: the live rows and columns rounded up, or the
    aligned blocks that hold a live one, and the contraction rounded up),
    and of a dense nb x nb x nb product per task with and without the
    trim."""
    compact, er, ec, es = exec_granularity(stream)
    ar = torch.arange(nb, device=tasks["relr"].device)
    mr = tasks["relr"] >= 0
    mc = (tasks["relc"] >= 0) & (ar[None, :] < tasks["blkn"][:, None])
    vr, vc = mr.sum(1).to(torch.int64), mc.sum(1).to(torch.int64)
    kn = tasks["srcn"].to(torch.int64).clamp(max=nb)
    up = lambda x, g: (x + g - 1) // g * g
    if compact:
        executed = 2 * up(vr, er) * up(vc, ec) * up(kn, es)
    else:
        executed = 2 * live_blocks(mr, er) * live_blocks(mc, ec) * up(kn, es)
    return {"tasks": int(kn.numel()),
            "segments": int(tasks["seg_ptr"].numel()) - 1,
            "gathered": int(((vr + vc) * kn).sum()),
            "unmasked_full_k": int((2 * vr * vc * nb).sum()),
            "unmasked_trimmed_k": int((2 * vr * vc * kn).sum()),
            "executed": int(executed.sum()),
            "dense_full_k": int(kn.numel()) * 2 * nb ** 3,
            "dense_trimmed_k_slabs": int((2 * nb * nb * up(kn, es)).sum())}


def upd_run_tasks(stream: dict, r: int) -> dict:
    """The tables of UPD run ``r`` of a factor stream, under the names
    :func:`update_level_work` reads."""
    h = stream["host"]
    t0, t1 = int(h["run_ptr"][r]), int(h["run_ptr"][r + 1])
    off = int(h["run_rel"][r])
    return {"relr": stream["relr"][t0 - off:t1 - off],
            "relc": stream["relc"][t0 - off:t1 - off],
            "blkn": stream["aux"][t0:t1], "srcn": stream["srcn"][t0:t1],
            "seg_ptr": stream["seg_ptr"][int(h["run_seg"][r]):
                                         int(h["run_seg"][r + 1])]}


def update_work(fex, nb: int) -> dict:
    """Operation counts (GFLOP) of one factorization's update tasks: the
    sums of :func:`update_level_work` over the levels of a level executor or
    over the UPD runs of a stream executor (which include the within-node
    syrk products)."""
    keys = ("unmasked_full_k", "unmasked_trimmed_k", "executed",
            "dense_full_k", "dense_trimmed_k_slabs")
    stream = not hasattr(fex, "levels")
    if not stream:
        tabs = [lv["upd"] for lv in fex.levels if "upd" in lv]
    else:
        kinds = fex.stream["host"]["run_kind"]
        tabs = [upd_run_tasks(fex.stream, r) for r in range(len(kinds))
                if kinds[r] == 0]
    levels = [update_level_work(t, nb, stream) for t in tabs]
    return {k: sum(w[k] for w in levels) / 1e9 for k in keys}


def update_rates(gflop: dict, ms: float, device_ms=None) -> dict:
    """Useful, executed and dense-equivalent GFLOP of one factorization's
    update tasks (as :func:`update_work` counts them) and the rates that
    ``ms`` of update time gives; ``device_ms``, the same launches' time on
    the device alone, beside it where measured."""
    out = dict(ms=ms, useful_gflop=gflop["unmasked_trimmed_k"],
               executed_gflop=gflop["executed"],
               dense_equivalent_gflop=gflop["dense_trimmed_k_slabs"],
               useful_tflops=gflop["unmasked_trimmed_k"] / ms,
               executed_tflops=gflop["executed"] / ms)
    if device_ms is not None:
        out["device_ms"] = device_ms
    return out


def main_options(m: int, schedule: str, **kw):
    """bench.py's configuration of poisson3d(m), the main path's."""
    import spllt_tpu_torch as st

    return st.Options(ordering="nd-grid", grid_shape=(m, m, m), nb=128,
                      nemin=192, schedule=schedule, dtype="float32",
                      refine=2, **kw)


def main_path(m: int, card: str, full_checks: bool, schedule: str):
    """analyse → factor → refined solve of poisson3d(m) through the public
    API with ``schedule`` ('scan': level executors, 'mega': stream
    executors).  Returns (record, num, factor executor, solve executor) for
    the kernel phase."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.analyse.native import native_available

    wrappers = kernel_wrappers()
    opts = main_options(m, schedule)
    nrhs = 4
    a = st.poisson3d(m)
    rng = np.random.default_rng(SEED)
    b = rng.standard_normal((a.n, nrhs))

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    symb = st.analyse(a, opts)
    t_analyse = time.perf_counter() - t0
    t0 = time.perf_counter()
    num = st.factor(symb)              # builds plans + executor tables too
    torch.cuda.synchronize()
    t_first_factor = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = st.solve(num, b)
    t_first_solve = time.perf_counter() - t0
    launches = {k: int(w.launches) for k, w in wrappers.items()}

    require(isinstance(num.pool, torch.Tensor) and num.pool.is_cuda,
            "the factor pool is not a CUDA tensor")
    require(x.shape == b.shape and np.isfinite(x).all(),
            "solution has the wrong shape or is not finite")
    err = bwd_err(a, x, b)
    require(err <= BWD_ERR_MAX, f"refined backward error {err} > "
                                f"{BWD_ERR_MAX}")
    for k in PATH_KERNELS[schedule]:
        require(launches[k] > 0, f"kernel {k} was never launched on the "
                                 f"schedule='{schedule}' main path")

    # steady state: cached plans and executors, CUDA-event timing
    fex = next(v for k, v in symb._cache.items() if k[0] == "fex")
    sex = num._solve_execs[(nrhs,)]
    require((type(fex).__name__, type(sex).__name__)
            == PATH_EXECUTORS[schedule],
            f"schedule='{schedule}' ran {type(fex).__name__} / "
            f"{type(sex).__name__}")
    from spllt_tpu_torch.numeric.assemble import assemble_torch

    def factor_only():
        pool = assemble_torch(num.plan, num.values_perm, torch.float32,
                              num.pool.device)
        fex(pool)

    factor_ms = time_ms(factor_only, 3)
    assemble_ms = time_ms(lambda: assemble_torch(
        num.plan, num.values_perm, torch.float32, num.pool.device), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.solve(num, b)
    solve_wall_ms = (time.perf_counter() - t0) * 1e3
    xp = torch.zeros((a.n + 1, nrhs), dtype=torch.float32, device="cuda")
    xp[:a.n] = torch.as_tensor(b, device="cuda").float()
    solve_ms = time_ms(lambda: sex.full(num.pool, xp), 3)

    rec = dict(
        matrix=f"poisson3d({m})", n=a.n, nb=128, nemin=192, dtype="float32",
        refine=2, nrhs=nrhs, ordering="nd-grid", schedule=schedule,
        executors=list(PATH_EXECUTORS[schedule]),
        nnz_l=int(symb.inform.num_factor),
        factor_flops=int(symb.inform.num_flops),
        nblocks=int(num.plan.nblocks), nlevels=int(num.fplan.nlevels),
        update_micro_tasks=int(fex.num_micro_tasks if schedule == "scan" else
                         fex.stream["relr"].shape[0]),
        update_gflop=update_work(fex, 128),
        pool_bytes=int(num.pool.numel() * 4), bwd_err=err,
        launches=launches, native_available=bool(native_available()),
        host_analyse_s=t_analyse, first_factor_s=t_first_factor,
        first_solve_s=t_first_solve, factor_ms=factor_ms,
        assemble_ms=assemble_ms,
        factor_gflops=symb.inform.num_flops / factor_ms / 1e6,
        solve_fwd_bwd_ms=solve_ms, refined_solve_wall_ms=solve_wall_ms,
        card=card)

    if full_checks:
        # refactorize new values on the same pattern: nothing is rebuilt
        cache_before = {k: id(v) for k, v in symb._cache.items()}
        vals2 = a.values * (1.0 + 0.25 * rng.random(a.values.shape))
        diag = a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr))
        vals2[diag] = a.values[diag] * 1.5        # keep it SPD
        a2 = st.CscMatrix(a.n, a.colptr, a.rowind, vals2)
        num2 = st.factor(symb, a2)
        require({k: id(v) for k, v in symb._cache.items()} == cache_before,
                "refactorization rebuilt a plan or an executor")
        require(num2.plan is num.plan and num2.fplan is num.fplan
                and num2._solve_execs is num._solve_execs,
                "refactorization did not reuse the cached plans")
        err2 = bwd_err(a2, st.solve(num2, b), b)
        require(err2 <= BWD_ERR_MAX, f"refactorized backward error {err2}")
        # indefinite matrix: same pattern, one negative diagonal entry
        vals3 = a.values.copy()
        vals3[np.flatnonzero(diag)[a.n // 2]] = -1.0
        try:
            st.factor(symb, st.CscMatrix(a.n, a.colptr, a.rowind, vals3))
        except st.NotPositiveDefiniteError:
            pass
        else:
            raise AssertionError("indefinite matrix did not raise "
                                 "NotPositiveDefiniteError")
        # precision='highest' holds with TF32 switched on for the process
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            pool_tf32 = st.factor(symb).pool
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32_rel = rel_err(pool_tf32, num.pool)[1]
        require(tf32_rel <= 1e-5, f"global TF32 changed the factor under "
                                  f"precision='highest': rel {tf32_rel}")
        del pool_tf32
        # jobs 1 then 2 equal job 0 unrefined
        x0 = st.solve(num, b, job=0, refine=0)
        x12 = st.solve(num, st.solve(num, b, job=1), job=2)
        djobs = float(np.abs(x12 - x0).max() / np.abs(x0).max())
        require(djobs <= 1e-5, f"jobs 1+2 differ from job 0 by {djobs}")
        rec.update(refactor_bwd_err=err2, jobs12_vs_job0_rel=djobs,
                   indefinite_raises=True, global_tf32_factor_rel=tf32_rel)
    return rec, num, fex, sex


# --------------------------------------------------------------------- #
# kernels against their plain versions
# --------------------------------------------------------------------- #
def rel_err(got: torch.Tensor, ref: torch.Tensor, base=None):
    """(max abs error, max abs error / max |ref|) over finite entries; NaN
    patterns must agree exactly.  With ``base`` (the input of an in-place
    update) the scale is max |ref - base|: the size of the change itself,
    not of what it was applied to."""
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    require(bool((nan_g == nan_r).all()), "NaN patterns differ")
    d = torch.where(nan_r, torch.zeros_like(ref), got - ref).abs().max()
    mag = ref if base is None else ref - base
    scale = torch.where(nan_r, torch.zeros_like(ref), mag).abs().max()
    return float(d), float(d / scale.clamp_min(1e-300))


def spd_tiles(rng, kvec, nb, dtype):
    """Bordered potrf inputs: SPD leading kv×kv block, random rows below."""
    k = len(kvec)
    g = rng.standard_normal((k, nb, nb))
    t = g @ g.transpose(0, 2, 1) / nb + 2.0 * np.eye(nb)
    for i, kv in enumerate(kvec):
        t[i, kv:, :] = rng.standard_normal((nb - kv, nb))
    return torch.as_tensor(t, dtype=dtype, device="cuda")


def trapezoid(kv, nb):
    """Entries of the lower trapezoid of the first kv columns of nb x nb
    tiles (the part of a tile that potrf and the left solve read)."""
    return kv * nb - kv * (kv - 1) // 2


def potrf_ops(kv, nb):
    """Operations of the bordered elimination of one tile: per column its
    divisions plus 2 per entry of the trapezoid right of it."""
    col_len = nb - np.arange(kv)                 # entries of column c
    right = np.cumsum(col_len[::-1])[::-1] - col_len
    return int((col_len + 2 * right).sum())


def potrf_work(kvs, nb, esz):
    """(bytes, operations) of a potrf batch: every tile is written whole and
    read only in the lower trapezoid of its columns < kv."""
    kvs = np.asarray(kvs, np.int64)
    return (len(kvs) * (nb * nb * esz + 4)
            + int(trapezoid(kvs, nb).sum()) * esz,
            sum(potrf_ops(int(k), nb) for k in kvs))


def trsm_work(kvs, nb, esz):
    """(bytes, operations) of a trsm batch: read the kv x kv lower triangle
    of L and the columns < kv of dst, write one whole tile."""
    kvs = np.asarray(kvs, np.int64)
    return (int((kvs * (kvs + 1) // 2 + nb * kvs + nb * nb).sum()) * esz
            + len(kvs) * 4, int((nb * kvs * kvs).sum()))


def update_work_bound(w, nb, esz):
    """(bytes, operations) of update tasks counted by
    :func:`update_level_work`: read the gathered source entries, each
    destination tile once and the task tables; write each destination tile
    once."""
    return (w["gathered"] * esz + 2 * w["segments"] * nb * nb * esz
            + w["tasks"] * (2 * nb + 5) * 4, w["unmasked_trimmed_k"])


def compare(name, kernel, plain, args, tol, reps, library=None):
    """Run kernel and plain version on the same inputs; returns
    (max_abs, rel, kernel_ms, plain_ms, library_ms).  ``library`` is one
    PyTorch call computing the same function on operands prepared outside
    the timed region, or None."""
    got = kernel(*args())
    torch.cuda.synchronize()
    ref = plain(*args())
    torch.cuda.synchronize()
    mabs, rel = rel_err(got, ref)
    require(rel <= tol, f"{name}: kernel differs from the plain version: "
                        f"rel {rel} > {tol}")
    return mabs, rel, time_ms(lambda: kernel(*args()), reps), \
        time_ms(lambda: plain(*args()), reps), \
        None if library is None else time_ms(library, reps)


class Acc:
    """Sums of one kernel row: times (as the host issues the launches, and
    where measured on the device alone), errors, and the bound as the sum
    of its launches' (or runs') bounds, each the larger of bytes over the
    memory rate and operations over the float32 rate."""

    def __init__(self):
        self.n = 0
        self.ms = self.pms = self.tb = self.to = 0.0
        self.lms = self.dms = self.pdms = self.ldms = None
        self.bytes = self.flops = 0
        self.mabs = self.rel = 0.0
        self.kmax = 0

    def add(self, batch, mabs, rel, ms, pms, lms, nbytes, flops,
            device=(None, None, None)):
        """One launch: its times as the host issues it (kernel, plain,
        library or None) and ``device``, the same three on the device alone
        (each None where not measured)."""
        self.n += 1
        if lms is not None:
            self.lms = (self.lms or 0.0) + lms
        for k, v in zip(("dms", "pdms", "ldms"), device):
            if v is not None:
                setattr(self, k, (getattr(self, k) or 0.0) + v)
        self.kmax = max(self.kmax, batch)
        self.ms += ms
        self.pms += pms
        self.bound(nbytes, flops)
        self.mabs, self.rel = max(self.mabs, mabs), max(self.rel, rel)

    def bound(self, nbytes, flops):
        """Add the bound of one launch or one run."""
        self.bytes += int(nbytes)
        self.flops += int(flops)
        tb, to = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
        if tb >= to:
            self.tb += tb
        else:
            self.to += to


# the fields of a level kernel's row that its 64³ run adds under "large"
LARGE_KEYS = ("launches", "max_abs_err", "rel_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms", "device_ms",
              "plain_device_ms", "library_device_ms", "launches_timed",
              "shape", "bytes", "flops")


def kernel_row(name, src_key, replaces, acc, per, shape, launches, tol):
    from spllt_tpu_torch.numeric._build import KERNEL_SOURCES

    return dict(
        name=name, route="cuda",
        source=f"spllt_tpu_torch/csrc/{KERNEL_SOURCES[src_key]}",
        replaces=replaces, launches=launches[name],
        max_abs_err=acc.mabs, rel_err=acc.rel, tol_rel=tol,
        ms=acc.ms, plain_ms=acc.pms, bound_ms=(acc.tb + acc.to) * 1e3,
        bound_by="bytes" if acc.tb >= acc.to else "operations",
        library_ms=acc.lms, device_ms=acc.dms, plain_device_ms=acc.pdms,
        library_device_ms=acc.ldms, launches_timed=acc.n, per=per,
        shape=shape, bytes=acc.bytes, flops=acc.flops)


def kernel_phase(num, fex, sex, nrhs, launches):
    from spllt_tpu_torch.numeric import (hopper_potrf, hopper_solve,
                                         hopper_trsm, hopper_update)
    rng = np.random.default_rng(SEED + 1)
    nb = 128
    f32, f64 = torch.float32, torch.float64
    TOL32, TOL64 = 1e-5, 1e-11   # relative to max|ref| (update: to the size
    #   of the update itself): different summation order, sqrt/division
    #   rounding; the runs read about 1e-6 and 1e-15
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    edge_kv = [0, 1, 37, 127, 128, 64, 128, 5]
    edge = {}
    out = []

    # ---------------- edge batches (correctness) ---------------- #
    # nb=256 is the default tile size; a float32 tile of it does not fit a
    # block's shared memory, so there each kernel works on global memory
    for tag, dtype, nbe, kvs, tol in (
            ("f32", f32, nb, edge_kv, TOL32),
            ("f32_nb256", f32, 256, [0, 1, 200, 256], TOL32),
            ("f64", f64, 48, [0, 1, 17, 47, 48, 30], TOL64)):
        kv = i32(kvs)
        tiles = spd_tiles(rng, kvs, nbe, dtype)
        lfac = hopper_potrf.potrf_plain(tiles, kv)
        edge[f"potrf_{tag}"] = rel_err(hopper_potrf.potrf(tiles, kv), lfac)
        dst = torch.as_tensor(rng.standard_normal((len(kvs), nbe, nbe)),
                              dtype=dtype, device="cuda")
        edge[f"trsm_{tag}"] = rel_err(
            hopper_trsm.trsm(lfac, dst, kv),
            hopper_trsm.trsm_plain(lfac, dst, kv))
        for tr in (False, True):
            for r in (1, 16):
                z = torch.as_tensor(
                    rng.standard_normal((len(kvs), nbe, r)), dtype=dtype,
                    device="cuda")
                edge[f"solve_{tag}_{'T' if tr else 'N'}_{r}"] = rel_err(
                    hopper_solve.left_solve(lfac, z, kv, tr),
                    hopper_solve.left_solve_plain(lfac, z, kv, tr))
        # a tile that is not positive definite: NaN from both routes
        bad = tiles[2:3].clone()
        bad[0, 3, 3] = -1.0
        g = hopper_potrf.potrf(bad, kv[2:3])
        p = hopper_potrf.potrf_plain(bad, kv[2:3])
        require(bool(torch.isnan(g[0, 0, 0])) and bool(
            torch.isnan(p[0, 0, 0])), "non-SPD tile did not give NaN")
        # update: segment of length 1, one of length 11, -1 entries,
        # blkn < nb, srcn of 0, 1 and nb, windows clamped at the end of the
        # pool
        nblk = 12
        rows = nblk * nbe
        pool = torch.as_tensor(rng.standard_normal((rows, nbe)),
                               dtype=dtype, device="cuda")
        seg_len = [1, 11, 3]
        dsts = np.repeat([0, 1, 2], seg_len)
        kk = len(dsts)
        lo = rng.integers(3 * nbe, rows - nbe + 1, size=(2, kk))
        lo[0, 1] = lo[1, 2] = rows - nbe          # clamped windows
        relr = rng.integers(-1, nbe, size=(kk, nbe))
        relc = rng.integers(-1, nbe, size=(kk, nbe))
        relr[1, :] = -1
        relr[1, 5] = 7                            # nearly empty task
        blkn = rng.integers(1, nbe + 1, size=kk)
        blkn[0] = nbe
        srcn = rng.integers(0, nbe + 1, size=kk)
        srcn[0], srcn[3], srcn[4] = nbe, 0, 1
        tasks = hopper_update.tasks_to_device(
            {"dst": dsts, "lor": lo[0], "loc": lo[1], "blkn": blkn,
             "srcn": srcn, "relr": relr, "relc": relc}, nbe, rows, "cuda")
        edge[f"update_{tag}"] = rel_err(
            hopper_update.apply_updates(pool.clone(), tasks),
            hopper_update.apply_updates_plain(pool.clone(), tasks), pool)
    for k, (mabs, rel) in edge.items():
        tol = TOL64 if "f64" in k else TOL32
        require(rel <= tol, f"edge case {k}: rel err {rel} > {tol}")
    # trsm at the default tile size (L read from global memory): 64 full pairs
    kv = i32([256] * 64)
    lfac = hopper_potrf.potrf_plain(spd_tiles(rng, [256] * 64, 256, f32), kv)
    dst = torch.as_tensor(rng.standard_normal((64, 256, 256)), dtype=f32,
                          device="cuda")
    nb256 = dict(zip(("max_abs", "rel", "ms", "plain_ms"), compare(
        "trsm nb=256", hopper_trsm.trsm, hopper_trsm.trsm_plain,
        lambda: (lfac, dst, kv), TOL32, 3)))
    del lfac, dst

    # ------- every shape the main path gave each kernel (f32, nb=128) ------- #
    _, levels = scan_level_times(num, fex, sex, (nrhs,), plain_times=True)
    out = level_kernel_rows(levels, fex, nrhs, launches, TOL32)
    edge_out = {k: {"max_abs": v[0], "rel": v[1]} for k, v in edge.items()}
    edge_out["trsm_f32_nb256_64_full_pairs"] = nb256
    return out, edge_out


def level_kernel_rows(levels, fex, nrhs, launches, tol):
    """The ``kernels`` rows of K1, K2, K3 and K5 from the per-level rows of
    :func:`scan_level_times`: one comparison and one timing per level of
    the plan; a row sums the launches of ONE factorization (potrf, trsm,
    update) or ONE forward + backward sweep (left_solve), its bound the sum
    of its launches' bounds."""
    nb = fex.nb
    out = []
    for name, src_key, replaces, per, keys in (
            ("potrf", "potrf", "pallas_potrf.py:167", "factorization",
             ("potrf",)),
            ("trsm", "trsm", "pallas_trsm.py:122", "factorization",
             ("trsm",)),
            ("update", "update", "pallas_update.py:312", "factorization",
             ("update",)),
            ("left_solve", "solve", "pallas_solve.py:135",
             "forward+backward sweep",
             (f"left_solve_fwd_nrhs{nrhs}", f"left_solve_bwd_nrhs{nrhs}"))):
        acc = Acc()
        ms = lambda r, k: r[k] / 1e3 if k in r else None
        for k in keys:
            for r in levels[k]:
                acc.add(r["items"], r["mabs"], r["rel"], ms(r, "us"),
                        ms(r, "plain_us"), ms(r, "library_us"), r["bytes"],
                        r["flops"], (ms(r, "device_us"),
                                     ms(r, "plain_device_us"),
                                     ms(r, "library_device_us")))
        if name == "update":
            shape = (f"{fex.num_micro_tasks} micro-tasks in "
                     f"{sum(r['items'] for r in levels['update'])} segments,"
                     f" up to {acc.kmax} a launch, pool "
                     f"[{fex.pool_rows},{nb}]")
        else:
            shape = (f"{'pairs' if name == 'trsm' else 'tiles'} "
                     f"[K,{nb},{nb}]"
                     + (f", z [K,{nb},{nrhs}]" if name == "left_solve" else "")
                     + f", K up to {acc.kmax}")
        out.append(kernel_row(name, src_key, "spllt_tpu/numeric/" + replaces,
                              acc, per, shape, launches, tol))
    return out


LEVEL_EDGE_KV = (0, 1, 15, 16, 17, 31, 32, 33, 127)   # and nb
LEVEL_EDGE_NRHS = (1, 4, 63, 64, 65, 130)


def level_edge_batches() -> dict:
    """K1, K2 and K5 at the edges of their panels, bands and chunks: nb 8,
    48, 128 and 256, float32 and float64, one batch of tiles at kv 0, 1, 15,
    16, 17, 31, 32, 33, 127 and nb (those <= nb); K1 against its plain
    version; K2 on K1's plain factor as that batch, as one pair (its
    narrowest bands) and as 300 pairs (more than 264 blocks: its widest
    bands), the one pair bit for bit equal to the same pair in the 300; K5
    on K1's plain factor at nrhs 1, 4, 63, 64, 65 and 130, each direction;
    tiles whose pivot fails at column 0 and at column 17 must come back NaN
    everywhere from both routes; K3 on ``compact_edge_tasks`` and
    ``dense_edge_tasks`` (its one-block-an-SM launch) at nb 48, 128 and
    256, two launches bit for bit equal.  Within 1e-5 (float32) and
    1e-11 (float64) of max|ref| (K3: of the size of the update).  Returns
    the worst error by kernel and dtype."""
    from spllt_tpu_torch.numeric import (hopper_potrf, hopper_solve,
                                         hopper_update)
    from spllt_tpu_torch.numeric.hopper_trsm import trsm, trsm_plain

    rng = np.random.default_rng(SEED + 10)
    tols = {torch.float32: 1e-5, torch.float64: 1e-11}
    worst, batches = {}, 0

    def held(tag, got, ref, dtype):
        nonlocal batches
        rel = rel_err(got, ref)[1]
        require(rel <= tols[dtype], f"edge batch {tag}: rel err {rel}")
        key = f"{tag.split('_')[0]}_{str(dtype)[6:]}"
        worst[key] = max(worst.get(key, 0.0), rel)
        batches += 1

    for dtype in (torch.float32, torch.float64):
        for nb in (8, 48, 128, 256):
            kvs = sorted({min(k, nb) for k in LEVEL_EDGE_KV + (nb,)})
            kv = torch.as_tensor(np.asarray(kvs, np.int32), device="cuda")
            tiles = spd_tiles(rng, kvs, nb, dtype)
            lfac = hopper_potrf.potrf_plain(tiles, kv)
            held(f"potrf_nb{nb}", hopper_potrf.potrf(tiles, kv), lfac, dtype)
            many = torch.arange(300, device="cuda") % len(kvs)
            lm, km = lfac[many], kv[many]
            dm = torch.as_tensor(rng.standard_normal((300, nb, nb)),
                                 dtype=dtype, device="cuda")
            for sl in (slice(0, len(kvs)), slice(len(kvs) - 1, len(kvs)),
                       slice(0, 300)):
                held(f"trsm_nb{nb}_{sl.stop - sl.start}pairs",
                     trsm(lm[sl], dm[sl], km[sl]),
                     trsm_plain(lm[sl], dm[sl], km[sl]), dtype)
            last = len(kvs) - 1
            require(torch.equal(trsm(lm[last:last + 1], dm[last:last + 1],
                                     km[last:last + 1])[0],
                                trsm(lm, dm, km)[last]),
                    f"trsm nb={nb} {dtype}: one pair alone and the same pair "
                    f"among 300 differ")
            del lm, dm
            for r_ in LEVEL_EDGE_NRHS:
                z = torch.as_tensor(rng.standard_normal((len(kvs), nb, r_)),
                                    dtype=dtype, device="cuda")
                for tr in (False, True):
                    held(f"solve_nb{nb}_nrhs{r_}_{'T' if tr else 'N'}",
                         hopper_solve.left_solve(lfac, z, kv, tr),
                         hopper_solve.left_solve_plain(lfac, z, kv, tr),
                         dtype)
            for col in (0, 17):
                if col >= nb:
                    continue
                bad = tiles[-1:].clone()          # kv = nb
                bad[0, col, col] = -100.0
                for route in (hopper_potrf.potrf, hopper_potrf.potrf_plain):
                    got = route(bad, kv[-1:])
                    require(bool(torch.isnan(got).all()),
                            f"potrf nb={nb} {dtype}: a pivot failing at "
                            f"column {col} did not make the tile NaN")
                batches += 1
    # K3 on hand-made tables at the edges of its packed entries, stages and
    # sub-tiles (skipped against an older tree, which has no such tables)
    kinds = (("compact", "dense")
             if hasattr(hopper_update, "compact_edge_tasks") else ())
    for dtype, nb, kind in itertools.product(
            (torch.float32, torch.float64), (48, 128, 256), kinds):
        make = getattr(hopper_update, f"{kind}_edge_tasks")
        tasks, rows_ = make(nb, SEED + nb)
        t = hopper_update.tasks_to_device(tasks, nb, rows_, "cuda")
        require(t["dense"] == (kind == "dense"),
                f"update edge tasks {kind} nb={nb}: launch choice")
        pool = torch.as_tensor(rng.standard_normal((rows_, nb)),
                               dtype=dtype, device="cuda")
        got = hopper_update.apply_updates(pool.clone(), t)
        again = hopper_update.apply_updates(pool.clone(), t)
        ref = hopper_update.apply_updates_plain(pool.clone(), t)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"update edge tasks {kind} "
                                         f"nb={nb} {dtype}: two launches "
                                         f"differ")
        rel = rel_err(got, ref, pool)[1]
        require(rel <= tols[dtype], f"update edge tasks {kind} nb={nb} "
                                    f"{dtype}: rel err {rel}")
        key = f"update_{str(dtype)[6:]}"
        worst[key] = max(worst.get(key, 0.0), rel)
        batches += 1
    return dict(batches=batches, worst_rel=worst)


def update_synthetic() -> dict:
    """The update kernel on synthetic segments: 1024 destination tiles of 8
    micro-tasks each at nb=128, float32, windows at random in a pool of 4096
    tiles; every row and column live and srcn=128 ('dense'); 32 live rows
    and columns, srcn=128; 6 live rows and columns, srcn=5.  Each is held
    against the plain version, then timed (CUDA events); the rate is the
    useful work over the time as the host issues the launches."""
    from spllt_tpu_torch.numeric import hopper_update as hu

    rng = np.random.default_rng(SEED + 4)
    nb, nseg, per = 128, 1024, 8
    k, rows = nseg * per, 4096 * nb
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    pool = torch.randn((rows, nb), generator=gen, device="cuda")
    out = {}
    for name, live, kn in (("dense", 128, 128), ("live32", 32, 128),
                           ("live6_srcn5", 6, 5)):
        maps = []
        for _ in range(2):
            rel = np.full((k, nb), -1, np.int32)
            pos = np.argsort(rng.random((k, nb)), axis=1)[:, :live]
            np.put_along_axis(rel, pos, rng.integers(0, nb, (k, live)), 1)
            maps.append(rel)
        tasks = hu.tasks_to_device({
            "dst": np.repeat(np.arange(nseg), per),
            "lor": rng.integers(nseg * nb, rows - nb, k),
            "loc": rng.integers(nseg * nb, rows - nb, k),
            "blkn": np.full(k, nb), "srcn": np.full(k, kn),
            "relr": maps[0], "relc": maps[1]}, nb, rows, "cuda")
        got = hu.apply_updates(pool.clone(), tasks)
        ref = hu.apply_updates_plain(pool.clone(), tasks)
        torch.cuda.synchronize()
        mabs, rel = rel_err(got, ref, pool)
        require(rel <= 1e-5, f"update on synthetic {name} tasks: rel {rel}")
        del got, ref
        ms = time_ms(lambda: hu.apply_updates(pool, tasks), 3)
        useful = 2 * live * live * kn * k / 1e9
        out[name] = dict(ms=ms, useful_gflop=useful, useful_tflops=useful / ms,
                         rel_err=rel, device_ms=time_device_ms(
                             lambda: hu.apply_updates(pool, tasks), 3))
    return out


# --------------------------------------------------------------------- #
# the stream kernels against their plain versions
# --------------------------------------------------------------------- #
def time_device_prepared_ms(prepare, fn, reps: int) -> float:
    """Milliseconds of ``fn`` on the device alone where each call needs
    ``prepare`` first: the pairs queued back to back behind a sleep kernel
    (:func:`time_device_ms`), less ``prepare`` alone queued the same way."""
    return time_device_ms(lambda: (prepare(), fn()), reps) - \
        time_device_ms(prepare, reps)


def time_prepared_ms(prepare, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` alone, with ``prepare`` run before every
    call outside the timed region (CUDA events, after one warm-up)."""
    prepare()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        prepare()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def factor_stream_work(stream: dict, nb: int, esz: int):
    """Per run of a factor stream (kind, work items, bytes, operations),
    counted from the stream's own tables as the rows of the batched kernels
    count them: UPD reads the unmasked gathered rows up to ``srcn``, each
    destination tile once and the tables, and writes each destination tile
    once; POTRF reads the lower trapezoid of its columns < kv and writes a
    tile; TRSM reads the kv x kv triangle of L and the columns < kv of dst
    and writes a tile.  Work items as the kernel forms them: UPD destination
    segments, POTRF tiles, TRSM bands of 64 / split dst rows of a pair
    (``run_split``; a stream without that table is unsplit)."""
    h = stream["host"]
    aux = stream["aux"].cpu().numpy().astype(np.int64)
    split = h.get("run_split", np.ones(len(h["run_kind"]), np.int64))
    out = []
    for r, kind in enumerate(h["run_kind"]):
        t0, t1 = int(h["run_ptr"][r]), int(h["run_ptr"][r + 1])
        kvs = aux[t0:t1]
        if kind == 0:
            w = update_level_work(upd_run_tasks(stream, r), nb, True)
            out.append((0, w["segments"], *update_work_bound(w, nb, esz)))
        elif kind == 1:
            out.append((1, t1 - t0, *potrf_work(kvs, nb, esz)))
        else:
            rows = 64 // int(split[r])
            out.append((2, (t1 - t0) * -(-nb // rows),
                        *trsm_work(kvs, nb, esz)))
    return out


def solve_stream_work(stream: dict, nb: int, nrhs: int, esz: int):
    """Per run of a solve stream (kind, work items, bytes, operations):
    every factor tile the run names is read once (SOL/SOLT: its lower
    trapezoid), every source window is read, every destination window is
    read and written once per segment (SOL/SOLT: two windows written), plus
    the tables."""
    h = stream["host"]
    aux = stream["aux"].cpu().numpy().astype(np.int64)
    rel_valid = (stream["rel"] >= 0).sum(1).cpu().numpy().astype(np.int64)
    win = nb * nrhs * esz
    out = []
    for r, kind in enumerate(h["run_kind"]):
        t0, t1 = int(h["run_ptr"][r]), int(h["run_ptr"][r + 1])
        k = t1 - t0
        nseg = max(0, int(h["run_seg"][r + 1]) - int(h["run_seg"][r]) - 1)
        if kind == 0:
            off = int(h["run_rel"][r])
            rows = int(rel_valid[t0 - off:t1 - off].sum())
            out.append((0, nseg, rows * nrhs * esz + 2 * nseg * win
                        + k * (nb + 4) * 4, rows * nrhs))
        elif kind in (1, 2):
            out.append((int(kind), nseg, k * (nb * nb * esz + win)
                        + 2 * nseg * win + k * 16,
                        k * 2 * nb * nb * nrhs))
        else:
            kvs = aux[t0:t1]
            out.append((int(kind), k,
                        int(trapezoid(kvs, nb).sum()) * esz + 3 * k * win
                        + k * 16,
                        int((nrhs * kvs * kvs
                             + 2 * nrhs * (nb - kvs) * kvs).sum())))
    return out


def add_bound(acc: Acc, work) -> None:
    """Add the bounds of the runs ``work`` (kind, items, bytes, operations)
    to ``acc``."""
    for _, _, nbytes, flops in work:
        acc.bound(nbytes, flops)


FACTOR_KINDS = ("upd", "potrf", "trsm")   # by run kind 0..2


def factor_run_times(fex, pool0: torch.Tensor, work) -> dict:
    """Time of each run of the factor stream, as the difference of the times
    of the stream cut after that run and after the one before (one call
    each, on a fresh copy of the assembled pool), summed by kind and, per
    kind, over the runs that have fewer work items than the kernel has
    blocks ("narrow") and the others, each kind beside its bound."""
    from spllt_tpu_torch.numeric.megakernel import mega_factorize

    buf = torch.empty_like(pool0)
    stream = fex.stream
    times = [time_prepared_ms(
        lambda: buf.copy_(pool0),
        lambda: mega_factorize(buf.view(-1, fex.nb),
                               dict(stream, run_kind=stream["run_kind"][:r])),
        1) for r in range(1, len(work) + 1)]
    grid = mega_factorize.last_grid
    kinds = {k: dict(runs=0, ms=0.0, narrow_runs=0, narrow_ms=0.0,
                     wide_ms=0.0, acc=Acc()) for k in FACTOR_KINDS}
    prev, narrow_ms, narrow_runs = 0.0, 0.0, 0
    for t, (kind, items, nbytes, flops) in zip(times, work):
        dt = max(t - prev, 0.0)
        prev = t
        k = kinds[FACTOR_KINDS[kind]]
        k["runs"] += 1
        k["ms"] += dt
        k["acc"].bound(nbytes, flops)
        if items < grid:
            k["narrow_runs"] += 1
            k["narrow_ms"] += dt
            narrow_ms += dt
            narrow_runs += 1
        else:
            k["wide_ms"] += dt
    for k in kinds.values():
        acc = k.pop("acc")
        k["bound_ms"] = (acc.tb + acc.to) * 1e3
        k["bound_by"] = "bytes" if acc.tb >= acc.to else "operations"
    return dict(runs=len(work), blocks=grid, whole_ms=prev,
                upd_ms=kinds["upd"]["ms"], potrf_ms=kinds["potrf"]["ms"],
                trsm_ms=kinds["trsm"]["ms"],
                runs_with_fewer_items_than_blocks=narrow_runs,
                ms_in_those_runs=narrow_ms, by_kind=kinds)


def factor_item_times(dtype=torch.float32, nb: int = 128,
                      nruns: int = 64) -> dict:
    """Latency of one work item of the factor stream kernel, from hand-made
    streams of ``nruns`` runs of one task each (each on its own tile), less
    the time of as many empty runs: one POTRF tile at kv 32, 64 and nb; one
    TRSM pair at kv = nb as the run forms its items (all blocks), and one
    TRSM item of 64 rows (one block, the run unsplit).  The grid barrier per
    run is the slope of the time of empty runs (1 and 1 + ``nruns`` runs).
    Microseconds; CUDA events, a fresh copy of the pool before each call."""
    from spllt_tpu_torch.numeric import megakernel as mk
    from spllt_tpu_torch.numeric.hopper_potrf import potrf_plain

    rng = np.random.default_rng(SEED + 7)
    rows_ = (2 * nruns + 1) * nb
    pool0 = torch.zeros((rows_ // nb, nb, nb), dtype=dtype, device="cuda")
    buf = torch.empty_like(pool0)
    tile = lambda i: np.asarray([i * nb], np.int64)
    one = lambda kind, d, t, kv: (kind, {
        "wr": tile(d), "wc": tile(t), "dst": tile(t),
        "aux": np.asarray([kv], np.int64), "srcn": np.zeros(1, np.int64)},
        None, None)
    empty = (mk.KIND_POTRF, {k: np.empty(0, np.int64) for k in
                             ("wr", "wc", "dst", "aux", "srcn")}, None, None)

    def run_us(runs, max_blocks=0, unsplit=False):
        s = mk.stream_to_device(mk.assemble_stream(runs, nb, rows_), "cuda")
        if unsplit and "run_split" in s:
            s["run_split"] = torch.ones_like(s["run_split"])
        return 1e3 * time_prepared_ms(
            lambda: buf.copy_(pool0),
            lambda: mk.mega_factorize(buf.view(-1, nb), s,
                                      max_blocks=max_blocks), 3)

    out = {}
    for mb, tag in ((0, "all_blocks"), (1, "one_block")):
        e1, en = run_us([empty], mb), run_us([empty] * (nruns + 1), mb)
        out[f"barrier_per_run_us_{tag}"] = (en - e1) / nruns
        out[f"empty_runs_us_{tag}"] = en
    empty_all = out["empty_runs_us_all_blocks"]
    for kv in sorted({min(k, nb) for k in (32, 64, nb)}):
        pool0[:nruns] = spd_tiles(rng, [kv] * nruns, nb, dtype)
        t = run_us([one(mk.KIND_POTRF, i, i, kv) for i in range(nruns)]
                   + [empty])
        out[f"potrf_item_us_kv{kv}"] = (t - empty_all) / nruns
    kv_t = torch.full((nruns,), nb, dtype=torch.int32, device="cuda")
    pool0[:nruns] = potrf_plain(spd_tiles(rng, [nb] * nruns, nb, dtype),
                                kv_t)
    pool0[nruns:2 * nruns] = torch.as_tensor(
        rng.standard_normal((nruns, nb, nb)), dtype=dtype, device="cuda")
    pairs = [one(mk.KIND_TRSM, i, nruns + i, nb) for i in range(nruns)]
    t = run_us(pairs + [empty])
    out[f"trsm_pair_run_us_kv{nb}"] = (t - empty_all) / nruns
    t = run_us(pairs + [empty], 1, unsplit=True)
    out[f"trsm_item_us_kv{nb}_rows64"] = \
        (t - out["empty_runs_us_one_block"]) / (nruns * -(-nb // 64))
    out["blocks"] = mk.mega_factorize.last_grid
    return dict(dtype=str(dtype)[6:], nb=nb, runs=nruns, **out)


def mega_factor_check(num, fex, scan_pool, tol: float = 1e-5):
    """The factor stream kernel on the assembled pool of ``num``: against
    its plain version and against the level executor's factor ``scan_pool``
    unless that is None (each within ``tol`` of max|ref|: other summation
    order, sqrt/division), and bit for bit against the factor the main path
    computed.  Returns (assembled pool, the kernel's factor, errors)."""
    from spllt_tpu_torch.numeric import megakernel
    from spllt_tpu_torch.numeric.assemble import assemble_torch

    nb = fex.nb
    pool0 = assemble_torch(num.plan, num.values_perm, torch.float32,
                           num.pool.device)
    got = pool0.clone()
    megakernel.mega_factorize(got.view(-1, nb), fex.stream)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    require(megakernel.mega_factorize.last_grid == 2 * sms,
            f"mega_factor ran {megakernel.mega_factorize.last_grid} blocks, "
            f"not two on each of the {sms} SMs")
    ref = pool0.clone()
    megakernel.mega_factorize_plain(ref.view(-1, nb), fex.stream)
    torch.cuda.synchronize()
    mabs, rel = rel_err(got, ref)
    require(rel <= tol, f"mega_factor: kernel differs from the plain "
                        f"version: rel {rel} > {tol}")
    del ref
    require(rel_err(got, num.pool)[0] == 0.0,
            "mega_factor is not deterministic: the same stream on the same "
            "pool gave another factor")
    checks = dict(max_abs=mabs, rel=rel)
    if scan_pool is not None:
        vs_scan = rel_err(got, scan_pool)
        require(vs_scan[1] <= tol, f"mega_factor: differs from the level "
                                   f"executor's factor: rel {vs_scan[1]}")
        checks.update(vs_level_executor_rel=vs_scan[1],
                      vs_level_executor_max_abs=vs_scan[0])
    return pool0, got, checks


def mega_kernel_phase(num, fex, sex, scan_pool, nrhs, launches,
                      run_times: bool):
    """K4 and K6 at the shapes the stream main path gave them: the factor
    stream of ``fex`` on the assembled pool of ``num`` against its plain
    version and against the level executor's factor ``scan_pool``; each
    solve direction against its plain version at nrhs 1, ``nrhs`` and 64.
    Returns (kernel rows, details)."""
    from spllt_tpu_torch.numeric import megakernel

    nb, esz = fex.nb, 4
    TOL32 = 1e-5        # of max|ref|: other summation order, sqrt/division
    rng = np.random.default_rng(SEED + 2)
    rows, detail = [], {}

    # ---- K4 ---- #
    pool0, buf, checks = mega_factor_check(num, fex, scan_pool)
    acc = Acc()
    acc.mabs, acc.rel = checks["max_abs"], checks["rel"]
    acc.n = 1
    acc.ms = time_prepared_ms(
        lambda: buf.copy_(pool0),
        lambda: megakernel.mega_factorize(buf.view(-1, nb), fex.stream), 3)
    acc.dms = time_device_prepared_ms(
        lambda: buf.copy_(pool0),
        lambda: megakernel.mega_factorize(buf.view(-1, nb), fex.stream), 3)
    acc.pms = time_prepared_ms(
        lambda: buf.copy_(pool0),
        lambda: megakernel.mega_factorize_plain(buf.view(-1, nb),
                                                fex.stream), 1)
    work = factor_stream_work(fex.stream, nb, esz)
    add_bound(acc, work)
    rows.append(kernel_row(
        "mega_factor", "mega_factor", "spllt_tpu/numeric/megakernel.py:637",
        acc, "factorization",
        f"{fex.num_tasks} tasks in {fex.num_runs} runs, pool "
        f"[{fex.pool_rows},{nb}], {megakernel.mega_factorize.last_grid} "
        f"blocks", launches, TOL32))
    detail["mega_factor"] = dict(
        vs_level_executor_rel=checks["vs_level_executor_rel"],
        vs_level_executor_max_abs=checks["vs_level_executor_max_abs"],
        update_tasks=int(fex.stream["relr"].shape[0]))
    if run_times:
        detail["mega_factor"]["run_times"] = factor_run_times(fex, pool0,
                                                              work)
    del buf, pool0

    # ---- K6 ---- #
    per_nrhs, acc = mega_solve_check(num, sex, nrhs, rng)
    rows.append(kernel_row(
        "mega_solve", "mega_solve", "spllt_tpu/numeric/solve_mega.py:432",
        acc, "forward+backward sweep",
        f"work [{sex.work_rows},{nrhs}], pool [{sex.pool_rows},{nb}]",
        launches, TOL32))
    detail["mega_solve"] = per_nrhs
    return rows, detail


def mega_solve_check(num, sex, nrhs, rng, tol: float = 1e-5):
    """K6 at the shapes the stream main path gives it: each solve direction
    of ``sex`` on the factor of ``num`` against its plain version (within
    ``tol`` of max|ref|: other summation order, division rounding) at nrhs
    1, ``nrhs`` and 64, then timed (CUDA events, a fresh copy of the work
    array before each launch).  Returns (per direction and nrhs: errors,
    times, runs, tasks, blocks; an :class:`Acc` holding one forward +
    backward sweep at ``nrhs`` with its bound)."""
    from spllt_tpu_torch.numeric import solve_mega

    nb = sex.nb
    poolf = num.pool.view(-1, nb)
    acc = Acc()
    per_nrhs = {}
    for r_ in sorted({1, nrhs, 64}):
        x = torch.zeros((num.symb.n + 1, r_), dtype=torch.float32,
                        device="cuda")
        x[:-1] = torch.as_tensor(
            rng.standard_normal((num.symb.n, r_), dtype=np.float32),
            device="cuda")
        w0 = sex._work(x)
        buf = torch.empty_like(w0)
        for d, tag in ((0, "fwd"), (1, "bwd")):
            st_d = sex._streams[d]
            got = solve_mega.mega_solve(poolf, w0.clone(), st_d)
            ref = solve_mega.mega_solve_plain(poolf, w0.clone(), st_d)
            torch.cuda.synchronize()
            mabs, rel = rel_err(got, ref)
            require(rel <= tol, f"mega_solve {tag} nrhs={r_}: kernel "
                                f"differs from the plain version: rel "
                                f"{rel} > {tol}")
            del got, ref
            ms = time_prepared_ms(
                lambda: buf.copy_(w0),
                lambda: solve_mega.mega_solve(poolf, buf, st_d), 3)
            dms = time_device_prepared_ms(
                lambda: buf.copy_(w0),
                lambda: solve_mega.mega_solve(poolf, buf, st_d), 3)
            pms = time_prepared_ms(
                lambda: buf.copy_(w0),
                lambda: solve_mega.mega_solve_plain(poolf, buf, st_d), 1)
            work = solve_stream_work(st_d, nb, r_, 4)
            wacc = Acc()
            add_bound(wacc, work)
            per_nrhs[f"{tag}_nrhs{r_}"] = dict(
                max_abs=mabs, rel=rel, ms=ms, device_ms=dms, plain_ms=pms,
                bound_ms=(wacc.tb + wacc.to) * 1e3,
                runs=len(st_d["host"]["run_kind"]),
                tasks=int(st_d["dst"].shape[0]),
                blocks=solve_mega.mega_solve.last_grid)
            if r_ == nrhs:          # the row: one forward + backward sweep
                acc.n += 1
                acc.ms += ms
                acc.dms = (acc.dms or 0.0) + dms
                acc.pms += pms
                acc.mabs, acc.rel = max(acc.mabs, mabs), max(acc.rel, rel)
                add_bound(acc, work)
        del w0, buf, x
    return per_nrhs, acc


SOLVE_KINDS = ("addg", "mm", "mm", "sol", "sol")   # by run kind 0..4


def solve_run_times(num, sex, nrhs_list=(4, 64)) -> dict:
    """Time of each run of both solve streams, as the difference of the
    times of the stream cut after that run and after the one before (one
    launch each, on a fresh copy of the work array), summed by kind (ADDG,
    MM/MMT, SOL/SOLT) and over the runs that have fewer work items than the
    kernel has blocks, beside the bound of the whole stream (from
    :func:`solve_stream_work`)."""
    from spllt_tpu_torch.numeric import solve_mega

    nb = sex.nb
    poolf = num.pool.view(-1, nb)
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for r_ in nrhs_list:
        x = torch.zeros((num.symb.n + 1, r_), dtype=torch.float32,
                        device="cuda")
        x[:-1] = torch.as_tensor(
            rng.standard_normal((num.symb.n, r_), dtype=np.float32),
            device="cuda")
        w0 = sex._work(x)
        buf = torch.empty_like(w0)
        for d, tag in ((0, "fwd"), (1, "bwd")):
            stream = sex._streams[d]
            work = solve_stream_work(stream, nb, r_, 4)
            items = [len(it) for it in solve_mega.work_items(stream, r_)]
            acc = Acc()
            add_bound(acc, work)
            prev, narrow_ms, narrow_runs = 0.0, 0.0, 0
            by_kind = {"addg": 0.0, "mm": 0.0, "sol": 0.0}
            runs_by_kind = {"addg": 0, "mm": 0, "sol": 0}
            grid = 0
            for r in range(1, len(work) + 1):
                cut = dict(stream, run_kind=stream["run_kind"][:r])
                t = time_prepared_ms(
                    lambda: buf.copy_(w0),
                    lambda: solve_mega.mega_solve(poolf, buf, cut), 1)
                grid = solve_mega.mega_solve.last_grid
                dt = max(t - prev, 0.0)
                prev = t
                kind = SOLVE_KINDS[work[r - 1][0]]
                by_kind[kind] += dt
                runs_by_kind[kind] += 1
                if items[r - 1] < grid:
                    narrow_ms += dt
                    narrow_runs += 1
            out[f"{tag}_nrhs{r_}"] = dict(
                runs=len(work), blocks=grid, whole_ms=prev,
                **{f"{k}_ms": v for k, v in by_kind.items()},
                **{f"{k}_runs": v for k, v in runs_by_kind.items()},
                runs_with_fewer_items_than_blocks=narrow_runs,
                ms_in_those_runs=narrow_ms,
                bound_ms=(acc.tb + acc.to) * 1e3,
                bound_by="bytes" if acc.tb >= acc.to else "operations")
        del w0, buf, x
    return out


EDGE_TOLS = {torch.float32: 1e-5, torch.float64: 1e-11}


def edge_check(out, tag, run_kernel, run_plain, dtype, base=None):
    """run_kernel(max_blocks) / run_plain() each return a new tensor;
    ``base`` as for :func:`rel_err`.  The kernel with 1, 3 and all blocks
    must equal the plain version within ``EDGE_TOLS`` and the run with all
    blocks bit for bit; the errors go to ``out``.  Returns the kernel's
    result with all blocks."""
    ref = run_plain()
    full = run_kernel(0)
    for mb in (1, 3, 0):
        got = run_kernel(mb)
        torch.cuda.synchronize()
        mabs, rel = rel_err(got, ref, base)
        require(rel <= EDGE_TOLS[dtype], f"edge stream {tag}, max_blocks="
                                         f"{mb}: rel err {rel}")
        same = torch.equal(torch.nan_to_num(got), torch.nan_to_num(full))
        require(same, f"edge stream {tag}: {mb} blocks and all blocks "
                      f"gave different results")
        out[f"{tag}_blocks{mb or 'all'}"] = {"max_abs": mabs, "rel": rel}
    return full


def factor_edge_streams(out, rng, wide: int = 300) -> None:
    """The POTRF and TRSM items of the factor stream kernel on hand-made
    streams, nb 8, 48, 128 and 256, float32 and float64, kv 0, 1, 31, 32,
    33, 127 and nb (those <= nb): a narrow run of one tile, a narrow run of
    one tile at each kv, a narrow TRSM run of two pairs per tile, a TRSM run
    of one pair, and a wide POTRF and a wide TRSM run of ``wide`` tiles and
    pairs (more items than blocks); then a one-tile run whose pivot fails at
    column min(40, nb - 1), which must leave the whole tile NaN.  Each
    through :func:`edge_check` (1, 3 and all blocks)."""
    from spllt_tpu_torch.numeric import megakernel as mk

    for nb in (8, 48, 128, 256):
        for dtype in (torch.float32, torch.float64):
            tag = f"items_nb{nb}_{str(dtype)[-7:]}"
            kvs = sorted({min(k, nb) for k in (0, 1, 31, 32, 33, 127, nb)},
                         reverse=True)
            k = len(kvs)
            wkv = [kvs[i % k] for i in range(wide)]
            wkv.sort(reverse=True)       # the plan's order: longest first
            a, b, c = 1, 1 + k, 1 + 3 * k          # first tile of each part
            e, f = c + 1, c + 1 + wide
            ntile = f + wide
            pool0 = torch.zeros((ntile, nb, nb), dtype=dtype, device="cuda")
            pool0[0:1] = spd_tiles(rng, [nb], nb, dtype)
            pool0[a:b] = spd_tiles(rng, kvs, nb, dtype)
            pool0[e:f] = spd_tiles(rng, wkv, nb, dtype)
            for lo, hi in ((b, c + 1), (f, ntile)):
                pool0[lo:hi] = torch.as_tensor(
                    rng.standard_normal((hi - lo, nb, nb)), dtype=dtype,
                    device="cuda")
            t = lambda ids: np.asarray(ids, np.int64) * nb
            z = lambda n: np.zeros(n, np.int64)
            potrf = lambda ids, kv: (mk.KIND_POTRF, {
                "wr": t(ids), "wc": t(ids), "dst": t(ids),
                "aux": np.asarray(kv, np.int64), "srcn": z(len(ids))},
                None, None)
            trsm = lambda dg, ds, kv: (mk.KIND_TRSM, {
                "wr": t(dg), "wc": t(ds), "dst": t(ds),
                "aux": np.asarray(kv, np.int64), "srcn": z(len(ds))},
                None, None)
            pairs = [a + i // 2 for i in range(2 * k)]
            stream = mk.stream_to_device(mk.assemble_stream([
                potrf([0], [nb]),
                potrf(list(range(a, b)), kvs),
                trsm(pairs, list(range(b, c)), [kvs[p - a] for p in pairs]),
                trsm([0], [c], [nb]),
                potrf(list(range(e, f)), wkv),
                trsm(list(range(e, f)), list(range(f, ntile)), wkv),
            ], nb, ntile * nb), "cuda")
            edge_check(out, f"factor_{tag}",
                       lambda mb: mk.mega_factorize(
                           pool0.clone().view(-1, nb), stream, max_blocks=mb),
                       lambda: mk.mega_factorize_plain(
                           pool0.clone().view(-1, nb), stream), dtype)
            # a failed pivot in a one-tile run: the whole tile NaN
            bad = pool0[:2].clone()
            col = min(40, nb - 1)
            bad[0, col, col] = -1.0
            stream = mk.stream_to_device(mk.assemble_stream(
                [potrf([0], [nb]), potrf([1], [kvs[1]])], nb, 2 * nb),
                "cuda")
            got = edge_check(out, f"factor_{tag}_failed_pivot",
                             lambda mb: mk.mega_factorize(
                                 bad.clone().view(-1, nb), stream,
                                 max_blocks=mb),
                             lambda: mk.mega_factorize_plain(
                                 bad.clone().view(-1, nb), stream), dtype)
            got = got.view(2, nb, nb)
            require(bool(torch.isnan(got[0]).all())
                    and not bool(torch.isnan(got[1]).any()),
                    f"edge stream {tag}: a failed pivot did not leave its "
                    f"tile, and only it, NaN")
            del pool0, bad, got


def edge_stream_phase():
    """The stream kernels on small and on hand-made streams with 1, 3 and
    all blocks: more items than blocks, fewer items than blocks, a
    destination segment of many tasks, kv = 0 and kv = nb tiles, an empty
    run, ragged rhs chunks.  Every run must equal the plain version to the
    tolerance, and the runs with fewer blocks must equal the full one bit
    for bit (no result depends on which block took an item)."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.api import _plans
    from spllt_tpu_torch.numeric import hopper_update as hu
    from spllt_tpu_torch.numeric import megakernel as mk
    from spllt_tpu_torch.numeric import solve_mega as sm
    from spllt_tpu_torch.numeric.assemble import assemble_torch
    from spllt_tpu_torch.numeric.hopper_potrf import potrf_plain
    from spllt_tpu_torch.plan.solve_mega import build_solve_mega_plan

    rng = np.random.default_rng(SEED + 3)
    tols = EDGE_TOLS
    out = {}
    check = lambda *a, **k: edge_check(out, *a, **k)

    # ---- real small problems through both stream kernels ---- #
    for tag, a, kw, dtype in (
            ("p3d8_nb128_f32", st.poisson3d(8),
             dict(ordering="nd-grid", grid_shape=(8, 8, 8), nb=128,
                  nemin=192), torch.float32),
            ("p2d12_nb8_f32", st.poisson2d(12),
             dict(ordering="nd", nb=8, nemin=4), torch.float32),
            ("p2d12_nb8_f64", st.poisson2d(12),
             dict(ordering="nd", nb=8, nemin=4), torch.float64)):
        symb = st.analyse(a, st.Options(**kw))
        plan, fplan, _ = _plans(symb, symb.options)
        nb = plan.nb
        rows_ = (plan.nblocks + 1) * nb
        stream = mk.stream_to_device(mk.build_mega_stream(fplan, rows_),
                                     "cuda")
        pool0 = assemble_torch(plan, symb.a_perm.values, dtype, "cuda")
        check(f"factor_{tag}",
              lambda mb: mk.mega_factorize(pool0.clone().view(-1, nb),
                                           stream, max_blocks=mb),
              lambda: mk.mega_factorize_plain(pool0.clone().view(-1, nb),
                                              stream), dtype)
        poolf = mk.mega_factorize_plain(pool0.clone().view(-1, nb), stream)
        smp = build_solve_mega_plan(symb, plan)
        for r_ in (3, 70):
            w0 = torch.as_tensor(rng.standard_normal((smp.P + smp.X, r_)),
                                 dtype=dtype, device="cuda")
            w0[:smp.P] = 0
            for d, runs in (("fwd", smp.fwd_runs), ("bwd", smp.bwd_runs)):
                st_d = sm.stream_to_device(
                    sm.solve_stream(runs, nb, rows_, smp.P + smp.X), "cuda")
                check(f"solve_{d}_{tag}_nrhs{r_}",
                      lambda mb: sm.mega_solve(poolf, w0.clone(), st_d,
                                               max_blocks=mb),
                      lambda: sm.mega_solve_plain(poolf, w0.clone(), st_d),
                      dtype)

    # ---- hand-made streams ---- #
    for tag, dtype, nb, kv3 in (("f32_nb128", torch.float32, 128, 37),
                                ("f64_nb48", torch.float64, 48, 17),
                                ("f32_nb256", torch.float32, 256, 200)):
        nblk = 12
        rows_ = nblk * nb
        kvs = [0, nb, kv3]
        pool0 = torch.as_tensor(rng.standard_normal((nblk, nb, nb)),
                                dtype=dtype, device="cuda")
        pool0[:3] = spd_tiles(rng, kvs, nb, dtype)
        seg_len = [1, 11, 3]
        kk = sum(seg_len)
        lo = rng.integers(6 * nb, rows_ - nb + 1, size=(2, kk))
        lo[0, 1] = lo[1, 2] = rows_ - nb          # windows at the pool's end
        relr = rng.integers(-1, nb, size=(kk, nb))
        relc = rng.integers(-1, nb, size=(kk, nb))
        relr[1, :] = -1
        relr[1, 5] = 7                            # nearly empty task
        blkn = rng.integers(1, nb + 1, size=kk)
        srcn = rng.integers(0, nb + 1, size=kk)
        srcn[0], srcn[3], srcn[4] = nb, 0, 1
        none = np.empty(0, np.int64)
        zeros3 = np.zeros(3, np.int64)
        tile = lambda *ids: np.asarray(ids, np.int64) * nb
        pairs_d, pairs_t = [1, 2, 0, 1, 1, 2], [3, 4, 5, 6, 7, 8]
        stream = mk.stream_to_device(mk.assemble_stream([
            (mk.KIND_UPD, {"wr": lo[0], "wc": lo[1],
                           "dst": np.repeat(tile(3, 4, 5), seg_len),
                           "aux": blkn, "srcn": srcn}, relr, relc),
            (mk.KIND_POTRF, {k: none for k in ("wr", "wc", "dst", "aux",
                                               "srcn")}, None, None),
            (mk.KIND_POTRF, {"wr": tile(0, 1, 2), "wc": tile(0, 1, 2),
                             "dst": tile(0, 1, 2), "aux": np.asarray(kvs),
                             "srcn": zeros3}, None, None),
            (mk.KIND_TRSM, {"wr": tile(*pairs_d), "wc": tile(*pairs_t),
                            "dst": tile(*pairs_t),
                            "aux": np.asarray([kvs[i] for i in pairs_d]),
                            "srcn": np.zeros(6, np.int64)}, None, None),
        ], nb, rows_), "cuda")
        check(f"factor_handmade_{tag}",
              lambda mb: mk.mega_factorize(pool0.clone().view(-1, nb),
                                           stream, max_blocks=mb),
              lambda: mk.mega_factorize_plain(pool0.clone().view(-1, nb),
                                              stream), dtype)
        # solve: windows 0..9 of a random work array, tiles 0..2 factored
        kv_t = torch.as_tensor(np.asarray(kvs, np.int32), device="cuda")
        poolf = pool0.clone()
        poolf[:3] = potrf_plain(pool0[:3], kv_t)
        poolf = poolf.view(-1, nb)
        wrows = 10 * nb
        rel = rng.integers(-1, nb, size=(4, nb))
        zrel = np.zeros((3, nb), np.int32)
        runs = [
            dict(kind=0, wA=tile(11, 11, 11, 11), wS=tile(5, 6, 7, 8),
                 dst=tile(0, 0, 0, 1), aux=np.zeros(4, np.int64), rel=rel),
            dict(kind=1, wA=none, wS=none, dst=none, aux=none,
                 rel=np.empty((0, nb), np.int32)),
            dict(kind=1, wA=tile(3, 4, 5), wS=tile(5, 6, 7),
                 dst=tile(2, 2, 3), aux=zeros3, rel=zrel),
            dict(kind=2, wA=tile(6, 7, 8), wS=tile(0, 1, 2),
                 dst=tile(4, 4, 4), aux=zeros3, rel=zrel),
            dict(kind=3, wA=tile(0, 1, 2), wS=tile(0, 1, 2),
                 dst=tile(7, 8, 9), aux=np.asarray(kvs), rel=zrel),
            dict(kind=4, wA=tile(2, 1, 0), wS=tile(3, 4, 5),
                 dst=tile(6, 7, 8), aux=np.asarray(kvs[::-1]), rel=zrel),
        ]
        st_d = sm.stream_to_device(sm.solve_stream(runs, nb, rows_, wrows),
                                   "cuda")
        for r_ in (3, 70):
            w0 = torch.as_tensor(rng.standard_normal((wrows, r_)),
                                 dtype=dtype, device="cuda")
            check(f"solve_handmade_{tag}_nrhs{r_}",
                  lambda mb: sm.mega_solve(poolf, w0.clone(), st_d,
                                           max_blocks=mb),
                  lambda: sm.mega_solve_plain(poolf, w0.clone(), st_d),
                  dtype)

    # ---- solve streams at the edges of the rhs chunks and of the panels of
    # the blocked substitution: one chain ADDG -> MM -> SOL -> SOLT -> MMT,
    # each run reading what the one before wrote ---- #
    for nb in (48, 128, 256):
        for dtype in (torch.float32, torch.float64):
            runs, kvs, nblk, wrows = sm.edge_case_runs(nb, SEED + nb)
            pool0 = torch.as_tensor(rng.standard_normal((nblk, nb, nb)),
                                    dtype=dtype, device="cuda")
            kv_t = torch.as_tensor(np.asarray(kvs, np.int32), device="cuda")
            k = len(kvs)
            pool0[:k] = potrf_plain(spd_tiles(rng, kvs, nb, dtype), kv_t)
            poolf = pool0.view(-1, nb)
            st_d = sm.stream_to_device(
                sm.solve_stream(runs, nb, nblk * nb, wrows), "cuda")
            for r_ in (1, 3, 4, 16, 63, 64, 65, 128):
                w0 = torch.as_tensor(rng.standard_normal((wrows, r_)),
                                     dtype=dtype, device="cuda")
                check(f"solve_edges_nb{nb}_{str(dtype)[-7:]}_nrhs{r_}",
                      lambda mb: sm.mega_solve(poolf, w0.clone(), st_d,
                                               max_blocks=mb),
                      lambda: sm.mega_solve_plain(poolf, w0.clone(), st_d),
                      dtype)

    factor_edge_streams(out, rng)

    # ---- update tasks that stress the masks and skip rules: K4 and K3 ---- #
    for nb in (48, 128, 256):
        for dtype in (torch.float32, torch.float64):
            tag = f"upd_nb{nb}_{str(dtype)[-7:]}"
            rows_ = 12 * nb
            tasks = hu.edge_case_tasks(nb, rows_, SEED + nb)
            pool0 = torch.as_tensor(rng.standard_normal((rows_, nb)),
                                    dtype=dtype, device="cuda")
            stream = mk.stream_to_device(mk.assemble_stream([
                (mk.KIND_UPD, {"wr": tasks["lor"], "wc": tasks["loc"],
                               "dst": tasks["dst"].astype(np.int64) * nb,
                               "aux": tasks["blkn"], "srcn": tasks["srcn"]},
                 tasks["relr"], tasks["relc"])], nb, rows_), "cuda")
            check(f"factor_{tag}",
                  lambda mb: mk.mega_factorize(pool0.clone(), stream,
                                               max_blocks=mb),
                  lambda: mk.mega_factorize_plain(pool0.clone(), stream),
                  dtype, pool0)
            tdev = hu.tasks_to_device(tasks, nb, rows_, "cuda")
            ref = hu.apply_updates_plain(pool0.clone(), tdev)
            got = hu.apply_updates(pool0.clone(), tdev)
            again = hu.apply_updates(pool0.clone(), tdev)
            torch.cuda.synchronize()
            mabs, rel = rel_err(got, ref, pool0)
            require(rel <= tols[dtype], f"update {tag}: rel err {rel}")
            require(torch.equal(got, again), f"update {tag}: two launches "
                                             f"gave different results")
            out[f"update_{tag}"] = {"max_abs": mabs, "rel": rel}
    return out


def profile_main_path(num, fex, sex, nrhs):
    """Kernel-time breakdown of one factorization and one forward+backward
    sweep by torch.profiler.  Returns the summed device kernel time of each
    and the profiler's tables (device time by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spllt_tpu_torch.numeric.assemble import assemble_torch

    xp = torch.zeros((num.symb.n + 1, nrhs), dtype=torch.float32,
                     device="cuda")
    xp[:-1] = 1.0

    def one_factor():
        fex(assemble_torch(num.plan, num.values_perm, torch.float32,
                           num.pool.device))

    shares, tables = {}, []
    for tag, fn in (("factor", one_factor),
                    ("solve_fwd_bwd", lambda: sex.full(num.pool, xp))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        # device rows only: operator rows repeat their kernels' time
        dev_ms = sum(e.self_device_time_total for e in ka
                     if e.device_type == DeviceType.CUDA) / 1e3
        ours = {k: sum(e.self_device_time_total for e in ka
                       if e.device_type == DeviceType.CUDA
                       and "::" + k + "_" in e.key) / 1e3
                for k in ("potrf", "trsm", "update", "left_solve",
                          "mega_factor", "mega_solve")}
        shares[tag] = {"device_kernel_ms": dev_ms,
                       "by_hand_kernel_ms": {k: v for k, v in ours.items()
                                             if v}}
        tables.append(f"==== {tag}: device kernel time {dev_ms:.3f} ms\n"
                      + ka.table(sort_by="self_device_time_total",
                                 row_limit=25, max_name_column_width=70)
                      + "\n")
    return shares, "".join(tables)


def solve_stream_phase(num, sex, rec, card, run_times: bool = True) -> dict:
    """K6 on the stream main path of ``sex``: each direction against its
    plain version at nrhs 1, 4 and 64 and timed, and its per-run times."""
    rng = np.random.default_rng(SEED + 6)
    per_nrhs, acc = mega_solve_check(num, sex, rec["nrhs"], rng)
    row = dict(ms=acc.ms, device_ms=acc.dms, plain_ms=acc.pms,
               bound_ms=(acc.tb + acc.to) * 1e3,
               bound_by="bytes" if acc.tb >= acc.to else "operations",
               max_abs_err=acc.mabs, rel_err=acc.rel,
               launches=rec["launches"]["mega_solve"],
               per="forward+backward sweep",
               shape=f"work [{sex.work_rows},{rec['nrhs']}], pool "
                     f"[{sex.pool_rows},{sex.nb}]")
    emit("stream_kernels", card=card, matrix=rec["matrix"],
         mega_solve_row=row, mega_solve=per_nrhs)
    if run_times:
        emit("solve_run_times", card=card, matrix=rec["matrix"],
             **solve_run_times(num, sex))
    return row


def level_launch(check, run, items, nbytes, flops, plain=None,
                 library=None, reps: int = 5) -> dict:
    """One launch of a level kernel at a level's shape: ``check()`` holds it
    against its plain version and returns (max abs error, relative error);
    ``run()`` launches it for the timing.  Microseconds as the host issues
    the launches (``us``) and on the device alone (``device_us``, launches
    back to back), the bound, and the same two times of ``plain`` (its
    plain version) and ``library`` (one PyTorch call computing the same
    function) where given."""
    mabs, rel = check()
    out = dict(items=int(items), mabs=mabs, rel=rel,
               bound_us=1e6 * max(nbytes / H100_BYTES_PER_S,
                                  flops / H100_F32_FLOPS),
               bytes=int(nbytes), flops=int(flops))
    for tag, fn in (("", run), ("plain_", plain), ("library_", library)):
        if fn is not None:
            out[f"{tag}us"] = 1e3 * time_ms(fn, reps)
            out[f"{tag}device_us"] = 1e3 * time_device_ms(fn, reps)
    return out


UPD_KEYS = ("dst", "lor", "loc", "blkn", "srcn", "relr", "relc")


def segment_tasks(t: dict, s: int, nb: int, pool_rows: int) -> dict:
    """Segment ``s`` of one level's update tables alone, built by the
    package's own ``tasks_to_device`` from the JAX-format fields (so the
    same code times any tree's update kernel)."""
    from spllt_tpu_torch.numeric.hopper_update import tasks_to_device

    sp = t["seg_ptr"].cpu().numpy()
    a, b = int(sp[s]), int(sp[s + 1])
    return tasks_to_device({k: t[k][a:b].cpu().numpy() for k in UPD_KEYS},
                           nb, pool_rows, "cuda")


def table_bytes(t: dict) -> int:
    """Device bytes of one level's update tables."""
    return sum(v.numel() * v.element_size() for v in t.values()
               if isinstance(v, torch.Tensor))


def update_level_extra(t: dict, w: dict, work, nb: int,
                       pool_rows: int) -> dict:
    """K3's per-level shape (tasks per segment, live rows and columns,
    srcn, useful and executed GFLOP, table bytes) and the device time of
    the level's longest segment launched alone."""
    from spllt_tpu_torch.numeric.hopper_update import apply_updates

    seg = np.diff(t["seg_ptr"].cpu().numpy())
    ar = torch.arange(nb, device="cuda")
    vr = (t["relr"] >= 0).sum(1).double()
    vc = ((t["relc"] >= 0) & (ar[None, :] < t["blkn"][:, None])).sum(1)
    one = segment_tasks(t, int(seg.argmax()), nb, pool_rows)
    return dict(seg_max=int(seg.max()), seg_mean=float(seg.mean()),
                live_rows_mean=float(vr.mean()),
                live_cols_mean=float(vc.double().mean()),
                srcn_mean=float(t["srcn"].double().mean()),
                useful_gflop=w["unmasked_trimmed_k"] / 1e9,
                executed_gflop=w["executed"] / 1e9,
                table_bytes=table_bytes(t),
                longest_seg_device_us=1e3 * time_device_ms(
                    lambda: apply_updates(work, one), 5))


def level_summary(rows: list, sms: int) -> dict:
    """Sums over the launches of one kernel (one factorization, or one
    sweep direction at one nrhs): ms as the host issues the launches, ms on
    the device alone, bound ms, and the same over the launches with fewer
    work items than the card has SMs ("narrow") and the others ("wide")."""
    def part(rs):
        out = dict(launches=len(rs),
                   ms=sum(r["us"] for r in rs) / 1e3,
                   device_ms=sum(r["device_us"] for r in rs) / 1e3,
                   bound_ms=sum(r["bound_us"] for r in rs) / 1e3,
                   device_us_per_launch=(
                       sum(r["device_us"] for r in rs) / len(rs)
                       if rs else None))
        if rs and "library_us" in rs[0]:
            out.update(library_ms=sum(r["library_us"] for r in rs) / 1e3,
                       library_device_ms=sum(r["library_device_us"]
                                             for r in rs) / 1e3)
        return out
    return dict(**part(rows), max_rel=max((r["rel"] for r in rows),
                                          default=0.0),
                narrow=part([r for r in rows if r["items"] < sms]),
                wide=part([r for r in rows if r["items"] >= sms]))


def scan_level_times(num, fex, sex, nrhs_list=(1, 4, 64),
                     plain_times: bool = False, library_times: bool = False):
    """K1, K2, K3 and K5 at every level shape the level main path gave
    them, each launch held against its plain version (float32, 1e-5 of
    max|ref|; the update: of the size of the update) and timed as the host
    issues it and on the device alone: K1/K2/K3 over one factorization, K5
    per sweep direction at each of ``nrhs_list``.  K1 takes synthetic SPD
    tiles with each level's kv, K2 and K5 the real factor's tiles, K3 each
    level's own task tables on a random pool of the real pool's shape.
    K3's rows also hold :func:`update_level_extra` (tasks per segment,
    live rows, GFLOP, table bytes, the longest segment alone); every row
    its ``level`` (1-based, as in the plan).  ``plain_times``: also the
    times of the plain versions and, for K2 and K5 (also with
    ``library_times``), of one ``torch.linalg.solve_triangular`` call on
    the identity-padded tiles.  Returns (summary by kernel, per-launch rows
    by kernel)."""
    from spllt_tpu_torch.numeric import (hopper_potrf, hopper_solve,
                                         hopper_trsm, hopper_update)

    rng = np.random.default_rng(SEED + 8)
    nb, esz, tol = fex.nb, 4, 1e-5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    levels = {"potrf": [], "trsm": [], "update": []}
    ar = torch.arange(nb, device="cuda")
    eye = torch.eye(nb, dtype=torch.float32, device="cuda")
    opt = lambda fn: fn if plain_times else None
    lib = lambda fn: fn if plain_times or library_times else None

    def checked(got, ref, base=None):
        torch.cuda.synchronize()
        mabs, rel = rel_err(got, ref, base)
        require(rel <= tol, f"level kernel differs from its plain version: "
                            f"rel {rel} > {tol}")
        return mabs, rel

    def repeated(kernel, pool, t):
        """The kernel's update of a copy of ``pool``, required to equal a
        second launch's bit for bit."""
        got, again = kernel(pool.clone(), t), kernel(pool.clone(), t)
        torch.cuda.synchronize()
        require(torch.equal(got, again), "update: two launches on the same "
                                         "pool gave different results")
        return got

    def padded(tl, kv_t):
        """The tiles with an identity on the diagonal of rows >= kv."""
        return tl + eye[None] * (ar[None, :, None] >= kv_t[:, None, None])

    poolf = torch.as_tensor(
        rng.standard_normal((fex.pool_rows, nb), dtype=np.float32),
        device="cuda")
    work = poolf.clone()
    for li, lv in enumerate(fex.levels, 1):
        if "upd" in lv:
            t = lv["upd"]
            w = update_level_work(t, nb)
            row = level_launch(
                lambda: checked(repeated(hopper_update.apply_updates,
                                         poolf, t),
                                hopper_update.apply_updates_plain(
                                    poolf.clone(), t), poolf),
                lambda: hopper_update.apply_updates(work, t),
                w["segments"], *update_work_bound(w, nb, esz),
                plain=opt(lambda: hopper_update.apply_updates_plain(work, t)))
            row.update(level=li, tasks=w["tasks"],
                       us_per_task=row["device_us"] / w["tasks"],
                       **update_level_extra(t, w, work, nb, fex.pool_rows))
            levels["update"].append(row)
        if "potrf" in lv:
            kv_t = lv["potrf"][1]
            kvs = kv_t.cpu().numpy().astype(np.int64)
            tiles = spd_tiles(rng, kvs, nb, torch.float32)
            levels["potrf"].append(dict(level_launch(
                lambda: checked(hopper_potrf.potrf(tiles, kv_t),
                                hopper_potrf.potrf_plain(tiles, kv_t)),
                lambda: hopper_potrf.potrf(tiles, kv_t),
                len(kvs), *potrf_work(kvs, nb, esz),
                plain=opt(lambda: hopper_potrf.potrf_plain(tiles, kv_t))),
                level=li, kv_max=int(kvs.max()), kv_mean=float(kvs.mean())))
        if "trsm" in lv:
            dg, _, kv_t = lv["trsm"]
            kvs = kv_t.cpu().numpy().astype(np.int64)
            lt = num.pool[dg]
            dst = torch.as_tensor(
                rng.standard_normal(tuple(lt.shape), dtype=np.float32),
                device="cuda")
            # the library call also computes the columns >= kv trsm zeroes
            lpad_t = padded(lt, kv_t).mT
            levels["trsm"].append(dict(level_launch(
                lambda: checked(hopper_trsm.trsm(lt, dst, kv_t),
                                hopper_trsm.trsm_plain(lt, dst, kv_t)),
                lambda: hopper_trsm.trsm(lt, dst, kv_t),
                len(kvs), *trsm_work(kvs, nb, esz),
                plain=opt(lambda: hopper_trsm.trsm_plain(lt, dst, kv_t)),
                library=lib(lambda: torch.linalg.solve_triangular(
                    lpad_t, dst, upper=True, left=False))),
                level=li, kv_max=int(kvs.max()), kv_mean=float(kvs.mean())))
    del poolf, work
    for r_ in nrhs_list:
        for lvs, tr, tag in ((sex._fwd_levels, False, "fwd"),
                             (sex._bwd_levels, True, "bwd")):
            rows = levels[f"left_solve_{tag}_nrhs{r_}"] = []
            for li, lv in enumerate(lvs, 1):
                if "sol" not in lv:
                    continue
                kv_t = lv["sol"]["kv"]
                kvs = kv_t.cpu().numpy().astype(np.int64)
                tl = num.pool[lv["sol"]["blk"]]
                z = torch.as_tensor(rng.standard_normal(
                    (len(kvs), nb, r_), dtype=np.float32), device="cuda")
                mpad = padded(tl, kv_t)
                if tr:
                    mpad = mpad.mT
                rows.append(dict(level_launch(
                    lambda: checked(
                        hopper_solve.left_solve(tl, z, kv_t, tr),
                        hopper_solve.left_solve_plain(tl, z, kv_t, tr)),
                    lambda: hopper_solve.left_solve(tl, z, kv_t, tr),
                    len(kvs),
                    # read: the lower trapezoid of the columns < kv, z;
                    # written: y
                    int(trapezoid(kvs, nb).sum()) * esz
                    + 2 * len(kvs) * nb * r_ * esz + len(kvs) * 4,
                    int((r_ * kvs * kvs
                         + 2 * r_ * (nb - kvs) * kvs).sum()),
                    plain=opt(lambda: hopper_solve.left_solve_plain(
                        tl, z, kv_t, tr)),
                    library=lib(lambda: torch.linalg.solve_triangular(
                        mpad, z, upper=tr))),
                    level=li, kv_max=int(kvs.max()),
                    kv_mean=float(kvs.mean())))
    summary = {k: level_summary(v, sms) for k, v in levels.items()}
    upd = levels["update"]
    dev_ms = summary["update"]["device_ms"]
    summary["update"].update(
        tasks=sum(r["tasks"] for r in upd),
        segments=sum(r["items"] for r in upd),
        useful_gflop=sum(r["useful_gflop"] for r in upd),
        executed_gflop=sum(r["executed_gflop"] for r in upd),
        useful_device_tflops=sum(r["useful_gflop"] for r in upd) / dev_ms,
        executed_device_tflops=sum(r["executed_gflop"] for r in upd) / dev_ms,
        table_bytes=sum(r["table_bytes"] for r in upd))
    return summary, levels


def level_item_times(nb: int = 128, reps: int = 20) -> dict:
    """Latency of one launch of a level kernel on one tile (float32, nb
    128; microseconds on the device, launches back to back, so each
    includes the gap between two launches): K1 at kv 0, 16, 32, 64 and nb,
    and on one kv = nb tile per SM; K5 at kv 0, 32 and nb, nrhs 4 and 64,
    each direction."""
    from spllt_tpu_torch.numeric.hopper_potrf import potrf, potrf_plain
    from spllt_tpu_torch.numeric.hopper_solve import left_solve

    rng = np.random.default_rng(SEED + 9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    for kv in sorted({min(k, nb) for k in (0, 16, 32, 64, nb)}):
        t, k = spd_tiles(rng, [kv], nb, torch.float32), i32([kv])
        out[f"potrf_us_kv{kv}"] = 1e3 * time_device_ms(lambda: potrf(t, k),
                                                       reps)
    t, k = spd_tiles(rng, [nb] * sms, nb, torch.float32), i32([nb] * sms)
    out[f"potrf_us_kv{nb}_{sms}_tiles"] = 1e3 * time_device_ms(
        lambda: potrf(t, k), reps)
    for kv in sorted({min(k, nb) for k in (0, 32, nb)}):
        k = i32([kv])
        tl = potrf_plain(spd_tiles(rng, [kv], nb, torch.float32), k)
        for r_ in (4, 64):
            z = torch.as_tensor(rng.standard_normal((1, nb, r_)),
                                dtype=torch.float32, device="cuda")
            for tr, tag in ((False, "fwd"), (True, "bwd")):
                out[f"left_solve_us_{tag}_kv{kv}_nrhs{r_}"] = \
                    1e3 * time_device_ms(lambda: left_solve(tl, z, k, tr),
                                         reps)
    return dict(dtype="float32", nb=nb, sms=sms, **out)


def scan_only(card: str, large: bool, t_start: float,
              levels_out=None) -> int:
    """``--scan-only``: the level main path (``schedule='scan'``) at
    poisson3d(32) and (64); K1, K2, K3 and K5 at every level shape it gave
    them (:func:`scan_level_times`, K5 per direction at nrhs 1, 4 and 64,
    K2 and K5 beside one library call), the device time of one
    factorization and one sweep against their CUDA-event times (how much
    of each is the host's level loop), and the single-tile latencies of
    :func:`level_item_times`.  ``levels_out``: a file that receives every
    per-level row, one JSON object a line.  Runs against any tree whose
    level kernels have the same wrappers (to compare two trees in one
    call)."""
    if levels_out:
        open(levels_out, "w").close()
    for m in (32, 64) if large else (32,):
        rec, num, fex, sex = main_path(m, card, False, "scan")
        emit("main_path", **rec)
        summary, levels = scan_level_times(num, fex, sex, library_times=True)
        emit("scan_level_times", card=card, matrix=rec["matrix"],
             launches=rec["launches"], **summary)
        if levels_out:
            with open(levels_out, "a") as f:
                for kernel, rows in levels.items():
                    for r in rows:
                        f.write(json.dumps(dict(matrix=rec["matrix"],
                                                kernel=kernel, card=card,
                                                **r)) + "\n")
        prof, _ = profile_main_path(num, fex, sex, rec["nrhs"])
        emit("scan_device_share", card=card, matrix=rec["matrix"],
             factor_ms=rec["factor_ms"],
             solve_fwd_bwd_ms=rec["solve_fwd_bwd_ms"], **prof)
        del num, fex, sex
        torch.cuda.empty_cache()
    emit("level_edge_batches", card=card, **level_edge_batches())
    emit("level_item_times", card=card, **level_item_times())
    return finish(t_start)


def solve_only(card: str, large: bool, run_times: bool,
               t_start: float) -> int:
    """``--solve-only``: the stream main path at poisson3d(32) and (64), K6
    held against its plain version and timed there, and its per-run times.
    Runs against any tree whose package has the same stream executor (to
    compare two trees in one call)."""
    rows = []
    for m in (32, 64) if large else (32,):
        rec, num, fex, sex = main_path(m, card, False, "mega")
        emit("main_path", **rec)
        rows.append(dict(matrix=rec["matrix"],
                         **solve_stream_phase(num, sex, rec, card,
                                              run_times)))
        del num, fex, sex
        torch.cuda.empty_cache()
    print(json.dumps({"mega_solve_rows": rows}), flush=True)
    return finish(t_start)


def factor_only(card: str, large: bool, t_start: float) -> int:
    """``--factor-only``: the stream main path at poisson3d(32) and (64), K4
    held against its plain version (and bit for bit against the main path's
    factor) and timed there, its per-run times by kind, and the item
    latencies of :func:`factor_item_times`.  Runs against any tree whose
    package has the same factor stream executor (to compare two trees in one
    call)."""
    from spllt_tpu_torch.numeric.megakernel import mega_factorize

    for m in (32, 64) if large else (32,):
        rec, num, fex, sex = main_path(m, card, False, "mega")
        emit("main_path", **rec)
        pool0, buf, checks = mega_factor_check(num, fex, None)
        ms = time_prepared_ms(
            lambda: buf.copy_(pool0),
            lambda: mega_factorize(buf.view(-1, fex.nb), fex.stream), 3)
        work = factor_stream_work(fex.stream, fex.nb, 4)
        acc = Acc()
        add_bound(acc, work)
        emit("stream_run_times", card=card, matrix=rec["matrix"],
             mega_factor_ms=ms, factor_ms=rec["factor_ms"],
             bound_ms=(acc.tb + acc.to) * 1e3,
             bound_by="bytes" if acc.tb >= acc.to else "operations",
             checks=checks, **factor_run_times(fex, pool0, work))
        del num, fex, sex, pool0, buf
        torch.cuda.empty_cache()
    edges = {}
    factor_edge_streams(edges, np.random.default_rng(SEED + 3))
    emit("factor_edge_streams", card=card, streams=len(edges), worst_rel={
        d: max(v["rel"] for k, v in edges.items() if d in k)
        for d in ("float32", "float64")})
    emit("factor_item_times", card=card, **factor_item_times())
    return finish(t_start)


# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# the entry points: coarse dense subtrees, the CLI, checkpoints, tracing
# --------------------------------------------------------------------- #
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "entry")


def poison_coarse(a, symb, fplan):
    """``a`` with a negative diagonal entry on a column inside the first
    coarsened subtree that has a diagonal entry in its assembly map."""
    import spllt_tpu_torch as st

    col = None
    for b in fplan.dense:
        hit = np.flatnonzero(b["asm_r"] == b["asm_c"])
        if len(hit):
            vidx = int(b["asm_vidx"][hit[0]])
            col = int(np.searchsorted(symb.a_perm.colptr, vidx,
                                      side="right") - 1)
            break
    require(col is not None, "no diagonal entry inside a coarse subtree")
    u = int(symb.perm[col])
    vals = a.values.copy()
    lo, hi = a.colptr[u], a.colptr[u + 1]
    vals[lo + int(np.flatnonzero(a.rowind[lo:hi] == u)[0])] = -1.0
    return st.CscMatrix(a.n, a.colptr, a.rowind, vals)


def dense_kernel_rows(dx, pool0, matrix, launches, tol=1e-5, reps=5):
    """K1 on each bucket's real fronts (gathered from the assembled pool
    ``pool0``) against its plain version, timed as the host issues the
    launch (``ms``) and on the device alone (``device_ms``); bound: bytes
    (every front written whole, the trapezoid of its kv columns read) over
    the memory rate against its operations over the float32 rate.
    ``launches[i]``: bucket i's K1 launches counted in the coarse runs."""
    from spllt_tpu_torch.numeric import hopper_potrf

    rows = []
    for t, n in zip(dx.buckets, launches):
        fronts, kv = dx.fronts(pool0, t), t["kvec"]
        sp = t["spad"]
        name = f"potrf (coarse fronts, spad {sp}, {matrix})"
        mabs, rel, ms, pms, _ = compare(
            name, hopper_potrf.potrf, hopper_potrf.potrf_plain,
            lambda: (fronts, kv), tol, reps)
        dms = time_device_ms(lambda: hopper_potrf.potrf(fronts, kv), reps)
        pdms = time_device_ms(lambda: hopper_potrf.potrf_plain(fronts, kv),
                              reps)
        acc = Acc()
        acc.add(t["nsub"], mabs, rel, ms, pms, None,
                *potrf_work(kv.cpu().numpy(), sp, 4), device=(dms, pdms,
                                                              None))
        row = kernel_row("potrf", "potrf", "spllt_tpu/numeric/"
                         "pallas_potrf.py:167", acc,
                         "the bucket's one launch of a coarse factorization",
                         f"fronts [{t['nsub']},{sp},{sp}], kv up to "
                         f"{int(kv.max())}", {"potrf": n}, tol)
        # a float32 front of spad 256 does not fit a block's shared memory
        row.update(name=name, path=f"{'shared' if sp <= 128 else 'global'}"
                                    "-memory elimination")
        rows.append(row)
    return rows


def coarse_phase(m: int, card: str):
    """Options(coarse_subtrees=True) at poisson3d(m) in bench.py's
    configuration, default span and waste, under 'scan' and 'mega' through
    the public API: the dense phase's buckets, the factor against the
    non-coarse factor of the same pattern, the refined backward error,
    ``factor_ms`` with and without the coarse layer, a front that is not
    positive definite, and K1 on each bucket's real fronts.  Returns the
    ``kernels`` rows of K1 at the fronts' shapes."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.api import _dense_key, _exec_key
    from spllt_tpu_torch.numeric import hopper_potrf
    from spllt_tpu_torch.numeric.assemble import assemble_torch

    wrappers = kernel_wrappers()
    a = st.poisson3d(m)
    b = np.random.default_rng(SEED + 10).standard_normal((a.n, 4))
    t0 = time.perf_counter()
    symb = st.analyse(a, main_options(m, "scan"))
    t_analyse = time.perf_counter() - t0
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = dict(matrix=f"poisson3d({m})", nb=128, nemin=192, dtype="float32",
               refine=2, nrhs=4, coarse_span=256, coarse_waste=8.0,
               host_analyse_s=t_analyse, card=card)
    for w in wrappers.values():
        w.launches = 0
    per, dx, pool0, bucket_launches = {}, None, None, None
    for schedule in ("scan", "mega"):
        opts = main_options(m, schedule, coarse_subtrees=True)
        plain_opts = main_options(m, schedule)
        # the dense executor serves both schedules: its per-bucket counts
        # are zeroed with the wrappers' (a new executor starts at 0)
        dkey = _dense_key(opts, dev)
        known = getattr(symb, "_cache", {}).get(dkey)
        for t in (known.buckets if known is not None else ()):
            t["launches"] = 0
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        num = st.factor(symb, options=opts)
        first_factor_s = time.perf_counter() - t0
        x = st.solve(num, b)
        launches = {k: int(w.launches) for k, w in wrappers.items()}
        dx = symb._cache[dkey]
        counted = [int(t["launches"]) for t in dx.buckets]
        require(counted == [1] * len(counted), f"coarse {schedule}: K1 "
                f"launches per bucket {counted}, not one each")
        bucket_launches = [c + p for c, p in
                           zip(counted, bucket_launches or [0] * len(counted))]
        err = bwd_err(a, x, b)
        require(err <= BWD_ERR_MAX, f"coarse {schedule}: refined backward "
                                    f"error {err} > {BWD_ERR_MAX}")
        buckets = [dict(spad=int(t["spad"]), nsub=int(t["nsub"]),
                        max_kv=int(np.max(t["kvec"])))
                   for t in num.fplan.dense or []]
        require(sum(t["nsub"] for t in buckets) >= 1,
                f"no subtree of poisson3d({m}) was coarsened")
        for k in PATH_KERNELS[schedule] + ("potrf",):
            require(launches[k] > 0, f"coarse {schedule}: kernel {k} was "
                                     "never launched")
        fex = symb._cache[_exec_key("fex", opts, dev)]
        levels = (sum("potrf" in lv for lv in fex.levels)
                  if schedule == "scan" else 0)
        require(launches["potrf"] == len(buckets) + levels,
                f"coarse {schedule}: {launches['potrf']} potrf launches, not "
                f"one for each of the {len(buckets)} buckets and {levels} "
                "levels")
        plain = st.factor(symb, options=plain_opts)
        mabs, rel = rel_err(num.pool, plain.pool)
        require(rel <= 1e-5, f"coarse {schedule}: factor differs from the "
                             f"non-coarse factor: rel {rel}")
        pfex = symb._cache[_exec_key("fex", plain_opts, dev)]

        def assembled():
            return assemble_torch(num.plan, num.values_perm, torch.float32,
                                  dev)

        pool0 = assembled()
        work = pool0.clone()
        dense_ms = time_prepared_ms(lambda: work.copy_(pool0),
                                    lambda: dx(work), 3)
        del work
        factor_ms = time_ms(lambda: fex(dx(assembled())[0]), 3)
        plain_factor_ms = time_ms(lambda: pfex(assembled()), 3)
        try:
            st.factor(symb, poison_coarse(a, symb, num.fplan), options=opts)
        except st.NotPositiveDefiniteError:
            pass
        else:
            raise AssertionError(f"coarse {schedule}: a front that is not "
                                 "positive definite did not raise")
        per[schedule] = dict(
            buckets=buckets, launches=launches,
            bucket_potrf_launches=counted, bwd_err=err,
            vs_non_coarse_max_abs=mabs, vs_non_coarse_rel=rel,
            factor_ms=factor_ms, non_coarse_factor_ms=plain_factor_ms,
            dense_phase_ms=dense_ms, first_factor_s=first_factor_s,
            num_tasks=int(num.fplan.num_tasks),
            non_coarse_num_tasks=int(plain.fplan.num_tasks),
            nlevels=int(num.fplan.nlevels),
            non_coarse_nlevels=int(plain.fplan.nlevels),
            not_posdef_raises=True)
        del num, plain, x
    # the dense phase's parts: the indexed gathers, K1, the indexed stores
    fronts = [dx.fronts(pool0, t) for t in dx.buckets]
    lfs = [hopper_potrf.potrf(f, t["kvec"])
           for f, t in zip(fronts, dx.buckets)]
    work = pool0.clone()
    rec.update(
        dense_gather_ms=time_ms(lambda: [dx.fronts(pool0, t)
                                         for t in dx.buckets], 3),
        dense_potrf_ms=time_ms(lambda: [hopper_potrf.potrf(f, t["kvec"])
                                        for f, t in zip(fronts, dx.buckets)],
                               3),
        dense_scatter_ms=time_ms(lambda: [dx.scatter(work, t, lf) for t, lf
                                          in zip(dx.buckets, lfs)], 3),
        dense_tiles=int(sum(t["blk"].shape[0] for t in dx.buckets)))
    del work, lfs, fronts
    # each bucket's K1 launches, counted over both coarse factor + solves
    rows = dense_kernel_rows(dx, pool0, rec["matrix"], bucket_launches)
    emit("coarse_phase", **rec, **per,
         potrf_fronts=[{k: r[k] for k in ("name", "max_abs_err", "rel_err",
                                           "ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")}
                       for r in rows])
    del pool0, dx, symb
    torch.cuda.empty_cache()
    return rows


def cli_phase(card: str, large: bool) -> None:
    """``python3 -m spllt_tpu_torch`` as a user runs it, each run a
    subprocess that must exit 0 and print a JSON ``bwd_err`` <= 1e-13: 64³
    (32³ with ``large`` off) under 'mega' with --stats, --timers, --trace and
    --dot-tree, the same with --coarse under 'scan', and a 32³ matrix
    written as MatrixMarket (--mm) and as Rutherford-Boeing (--mat), read
    back at the default amd ordering."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.sparse.io import (write_matrix_market,
                                           write_rutherford_boeing)

    os.makedirs(OUT_DIR, exist_ok=True)
    m = 64 if large else 32
    common = ["--nb", "128", "--nemin", "192", "--nrhs", "4", "--refine",
              "2", "--json"]
    trace, dot = (os.path.join(OUT_DIR, f) for f in ("cli_trace.json",
                                                     "cli_atree.dot"))
    flags = ["--stats", "--timers", "--trace", trace, "--dot-tree", dot]
    mm, rb = (os.path.join(OUT_DIR, f) for f in ("p32.mtx", "p32.rb"))
    a32 = st.poisson3d(32)
    write_matrix_market(mm, a32)
    write_rutherford_boeing(rb, a32)
    runs = [("mega", ["--poisson3d", str(m), "--schedule", "mega"] + flags),
            ("coarse_scan", ["--poisson3d", str(m), "--schedule", "scan",
                             "--coarse"] + flags),
            ("mm_amd", ["--mm", mm, "--schedule", "mega"]),
            ("rb_amd", ["--mat", rb, "--schedule", "mega"])]
    out = {}
    try:
        for tag, args in runs:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "spllt_tpu_torch"]
                               + args + common, capture_output=True,
                               text=True, timeout=300,
                               cwd=os.path.dirname(os.path.abspath(
                                   __file__)))
            wall = time.perf_counter() - t0
            require(p.returncode == 0, f"CLI run {tag} exited "
                                       f"{p.returncode}:\n{p.stderr[-3000:]}")
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            require(rec["bwd_err"] <= BWD_ERR_MAX,
                    f"CLI run {tag}: bwd_err {rec['bwd_err']}")
            if "--trace" in args:
                names = [e["name"] for e in
                         json.load(open(trace))["traceEvents"]]
                require("factor" in names and "solve" in names,
                        f"CLI run {tag}: trace events {names}")
                with open(dot) as f:
                    require(f.read().startswith("digraph"),
                            f"CLI run {tag}: the DOT file is not a digraph")
                require("num_tasks" in p.stdout and "GFLOP/s" in p.stdout,
                        f"CLI run {tag}: no --stats / --timers output")
            out[tag] = dict(args=" ".join(args + common).replace(
                OUT_DIR + os.sep, ""), wall_s=wall, **{
                k: rec[k] for k in ("n", "nnz", "nnz_L", "flops",
                                    "t_analyse", "t_factor", "t_solve",
                                    "gflops", "bwd_err")})
    finally:
        for f in (mm, rb):
            if os.path.exists(f):
                os.remove(f)
    emit("cli_phase", card=card, **out)


def persist_phase(card: str) -> None:
    """save_factor → load_factor onto the card → solve, bit for bit the
    original factor's solve; load_symbolic → factor, bit for bit the
    original factor (poisson3d(32), 'mega': its kernels are deterministic).
    The checkpoint files are removed afterwards."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.utils.persist import (load_factor, load_symbolic,
                                               save_factor)

    os.makedirs(OUT_DIR, exist_ok=True)
    a = st.poisson3d(32)
    b = np.random.default_rng(SEED + 11).standard_normal((a.n, 4))
    num = st.factor(st.analyse(a, main_options(32, "mega")))
    x = st.solve(num, b)
    path = os.path.join(OUT_DIR, "factor.npz")
    try:
        t0 = time.perf_counter()
        save_factor(path, num)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        num2 = load_factor(path)
        t_load = time.perf_counter() - t0
        require(num2.pool.is_cuda and num2.pool.dtype == torch.float32,
                "load_factor did not put a float32 pool on the card")
        require(torch.equal(num2.pool, num.pool),
                "the reloaded pool differs from the saved one")
        x2 = st.solve(num2, b)
        require(np.array_equal(x2, x), "the reloaded factor's solve is not "
                                       "bit for bit the original's")
        symb2 = load_symbolic(path + ".symb.npz")
        num3 = st.factor(symb2)
        require(torch.equal(num3.pool, num.pool), "the refactorization of "
                "load_symbolic's object differs from the original factor")
        nbytes = os.path.getsize(path) + os.path.getsize(path + ".symb.npz")
    finally:
        for f in (path, path + ".symb.npz"):
            if os.path.exists(f):
                os.remove(f)
    emit("persist_phase", card=card, matrix="poisson3d(32)", schedule="mega",
         save_s=t_save, load_s=t_load, file_bytes=nbytes,
         bwd_err=bwd_err(a, x2, b), solve_bit_for_bit=True,
         refactor_bit_for_bit=True)


def device_trace_phase(card: str) -> None:
    """One 'mega' factor + solve of poisson3d(32) under
    ``utils.tracing.device_trace``: the exported Chrome trace must name the
    launches of both stream kernels."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.utils.tracing import device_trace

    a = st.poisson3d(32)
    b = np.random.default_rng(SEED + 12).standard_normal((a.n, 4))
    symb = st.analyse(a, main_options(32, "mega"))
    st.solve(st.factor(symb), b)             # tables built outside the trace
    logdir = os.path.join(OUT_DIR, "device_trace")
    with device_trace(logdir) as prof:
        x = st.solve(st.factor(symb), b)
        torch.cuda.synchronize()
    require(bwd_err(a, x, b) <= BWD_ERR_MAX, "traced run: bwd_err")
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sorted(n for n in names if k + "_kernel" in n)
             for k in ("mega_factor", "mega_solve")}
    for k, v in found.items():
        require(v, f"the device trace names no {k} launch")
    from torch.autograd import DeviceType

    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    emit("device_trace", card=card, matrix="poisson3d(32)", file=path,
         trace_bytes=os.path.getsize(path), kernels=found,
         device_kernel_ms=dev_ms)


def entry_phases(card: str, large: bool) -> list:
    """The phases of ``--entry-only`` (also part of the full run); returns
    the ``kernels`` rows of K1 at the coarse fronts."""
    rows = []
    for m in (32, 64) if large else (32,):
        rows += coarse_phase(m, card)
    cli_phase(card, large)
    persist_phase(card)
    device_trace_phase(card)
    return rows


# --------------------------------------------------------------------- #
# the forest path (Options(ndevices=k)), the rhs-sharded solve, the C API
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_kernels():
    """The factor executors' kernel wrappers replaced by their plain
    versions, so that a factorization runs them on the card's tensors."""
    from unittest import mock

    from spllt_tpu_torch.numeric import (factor_scan, hopper_potrf,
                                         hopper_trsm, hopper_update,
                                         megakernel)

    with mock.patch.multiple(factor_scan, potrf=hopper_potrf.potrf_plain,
                             trsm=hopper_trsm.trsm_plain,
                             apply_updates=hopper_update.apply_updates_plain), \
            mock.patch.object(megakernel, "mega_factorize",
                              megakernel.mega_factorize_plain):
        yield


def forest_options(m: int, schedule: str, k: int, dtype: str = "float32"):
    return dataclasses.replace(main_options(m, schedule), ndevices=k,
                               dtype=dtype)


def forest_devices(k: int, ncards: int, symb, opts):
    """None (the device rule of Options(ndevices=k)) when k cards are
    visible; else [cuda:0] * k, after checking that Options(ndevices=k)
    refuses to run rather than run elsewhere."""
    import spllt_tpu_torch as st

    if ncards >= k:
        return None
    try:
        st.factor(symb, options=opts)
    except ValueError:
        return [torch.device("cuda", 0)] * k
    raise AssertionError(f"Options(ndevices={k}) ran with {ncards} card(s)")


def forest_expected_launches(fx, refine: int) -> dict:
    """What the wrappers must count in one factorization and in one refined
    solve (refine + 1 sweeps each way) of the forest executor ``fx``: a
    stream executor launches once if its stream has runs, a level executor
    once per level that has tasks of the kernel's kind."""
    local, top = fx.solvers()
    fexs, sexs = fx.local_ex + [fx.top_ex], local + [top]
    if fx.mega:
        return {"mega_factor": sum(ex.num_runs > 0 for ex in fexs),
                "mega_solve": (refine + 1) * sum(
                    s["run_kind"].shape[0] > 0 for ex in sexs
                    for s in ex._streams)}
    return {"potrf": sum("potrf" in lv for ex in fexs for lv in ex.levels),
            "trsm": sum("trsm" in lv for ex in fexs for lv in ex.levels),
            "update": sum("upd" in lv for ex in fexs for lv in ex.levels),
            "left_solve": (refine + 1) * sum(
                "sol" in lv for ex in sexs
                for lv in ex._fwd_levels + ex._bwd_levels)}


def forest_pool_err(pools, md, ref: torch.Tensor):
    """max |local block − the single-device factor's block| over every
    device's blocks (the top from the first device), and that over
    max |L|; the tops of all devices must be bit for bit equal."""
    part = md.part
    mabs = 0.0
    for d, p in enumerate(pools):
        require(torch.equal(p[:part.ntop], pools[0][:part.ntop]),
                f"the top of device {d} differs from the first device's")
        sel = np.flatnonzero((part.blk_dev == d)
                             | ((part.blk_dev == -1) & (d == 0)))
        li = torch.as_tensor(part.blk_local[sel], device=p.device)
        gi = torch.as_tensor(sel, device=ref.device)
        mabs = max(mabs, float((p[li].to(ref.device) - ref[gi]).abs().max()))
    return mabs, mabs / float(ref.abs().max())


def forest_times(num, b) -> dict:
    """CUDA-event times of the forest factorization (as a whole and by
    phase: A per shard, B, C) and of one unrefined solve, and the host wall
    time of the refined solve."""
    import spllt_tpu_torch as st

    fx = num.mdf
    values = num.values_perm
    pools0, top0 = fx.assemble(values)
    work = [p.clone() for p in pools0]

    def restore(src):
        for w, s in zip(work, src):
            w.copy_(s)

    out = dict(
        factor_ms=time_ms(lambda: fx.factor(values), 3),
        assemble_ms=time_ms(lambda: fx.assemble(values), 3),
        phase_a_ms=[time_prepared_ms(lambda d=d: work[d].copy_(pools0[d]),
                                     lambda d=d: fx.local_ex[d](work[d]), 3)
                    for d in range(len(work))])
    restore(pools0)
    fx.run_local(work)
    after = [w.clone() for w in work]
    out["phase_b_ms"] = time_prepared_ms(lambda: restore(after),
                                         lambda: fx.reduce_top(work, top0), 3)
    after = [w.clone() for w in work]
    out["phase_c_ms"] = time_prepared_ms(lambda: restore(after),
                                         lambda: fx.run_top(work), 3)
    del work, after, pools0
    n = num.symb.n
    xp = torch.zeros((n + 1, b.shape[1]), dtype=fx.dtype,
                     device=fx.devices[0])
    xp[:n] = torch.as_tensor(b[num.symb.perm], device=xp.device)
    out["solve_fwd_bwd_ms"] = time_ms(lambda: fx.solve(num.pool, xp, 0), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.solve(num, b)
    out["refined_solve_wall_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def forest_run(symb, a, b, opts, ncards: int, ref_pool, plain_check: bool,
               rerun: bool):
    """One forest factor + refined solve of ``opts`` (through Options when
    the cards are there, else on [cuda:0] * k) with its checks, launches
    and times; returns (record, kernel launches)."""
    import spllt_tpu_torch as st

    wrappers = kernel_wrappers()
    k = opts.ndevices
    devices = forest_devices(k, ncards, symb, opts)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    num = st.factor(symb, options=opts, devices=devices)
    torch.cuda.synchronize()
    first_factor_s = time.perf_counter() - t0
    launches = {nm: int(w.launches) for nm, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    x = st.solve(num, b)
    first_solve_s = time.perf_counter() - t0
    for nm, w in wrappers.items():
        launches[nm] += int(w.launches)
    fx = num.mdf
    tag = f"{opts.schedule} k={k} {opts.dtype}"
    require(x.shape == b.shape and np.isfinite(x).all(),
            f"forest {tag}: solution has the wrong shape or is not finite")
    err = bwd_err(a, x, b)
    require(err <= BWD_ERR_MAX, f"forest {tag}: refined backward error "
                                f"{err} > {BWD_ERR_MAX}")
    fam = "Mega" if opts.schedule == "mega" else "Scan"
    want = {"factor": [f"{fam}FactorExecutor"] * k,
            "factor_top": f"{fam}FactorExecutor",
            "solve": [f"{fam}SolveExecutor"] * k,
            "solve_top": f"{fam}SolveExecutor"}
    require(fx.executors() == want, f"forest {tag}: executors "
                                    f"{fx.executors()}")
    require(all(p.is_cuda for p in num.pool), f"forest {tag}: a pool is not "
                                              "on the card")
    expected = forest_expected_launches(fx, opts.refine)
    path = {nm: launches[nm] for nm in PATH_KERNELS[opts.schedule]}
    require(path == expected and all(v > 0 for v in path.values()),
            f"forest {tag}: launches {path}, expected {expected}")
    require(not any(v for nm, v in launches.items() if nm not in path),
            f"forest {tag}: kernels of the other schedule ran: {launches}")
    tol = 1e-11 if opts.dtype == "float64" else 1e-5
    mabs, rel = forest_pool_err(num.pool, fx.md, ref_pool)
    require(rel <= tol, f"forest {tag}: global pool differs from the "
                        f"single-device factor: rel {rel} > {tol}")
    part = fx.md.part
    rec = dict(
        schedule=opts.schedule, ndevices=k, dtype=opts.dtype,
        devices=[str(d) for d in fx.devices],
        route="Options(ndevices)" if devices is None else
        "factor(devices=[cuda:0] * k)",
        shards_share_one_card=len(set(map(str, fx.devices))) < k,
        ntop=part.ntop, nown=[int(c) for c in part.nown],
        executors=fx.executors(), launches=path, bwd_err=err,
        vs_single_device_max_abs=mabs, vs_single_device_rel=rel,
        first_factor_s=first_factor_s, first_solve_s=first_solve_s)
    if plain_check:
        with plain_kernels():
            pools_plain, _ = fx.factor(num.values_perm)
        worst = max(rel_err(p, q)[1] for p, q in zip(num.pool, pools_plain))
        require(worst <= 1e-5, f"forest {tag}: the kernels' factor differs "
                               f"from the plain versions': rel {worst}")
        rec["vs_plain_versions_rel"] = worst
        del pools_plain
        # a negative pivot in a shard's first leaf, and one in the top
        diag = np.flatnonzero(a.rowind == np.repeat(np.arange(a.n),
                                                    np.diff(a.colptr)))
        for col in (symb.perm[0], symb.perm[-1]):
            vals = a.values.copy()
            vals[diag[col]] = -1.0
            try:
                st.factor(symb, st.CscMatrix(a.n, a.colptr, a.rowind, vals),
                          options=opts, devices=devices)
            except st.NotPositiveDefiniteError:
                pass
            else:
                raise AssertionError(f"forest {tag}: a negative pivot in "
                                     f"column {col} did not raise")
        rec["indefinite_raises"] = True
    if rerun:
        again = st.factor(symb, options=opts, devices=devices)
        require(all(torch.equal(p, q) for p, q in zip(again.pool, num.pool)),
                f"forest {tag}: a second factorization is not bit for bit "
                "the first")
        require(np.array_equal(st.solve(again, b), x),
                f"forest {tag}: a second solve is not bit for bit the first")
        rec["rerun_bit_for_bit"] = True
        del again
    rec.update(forest_times(num, b))
    del num
    return rec, path


def rhs_sharded_run(num, a, ncards: int) -> dict:
    """solve_rhs_sharded at nrhs 64 over 2 and 4 shards of the
    single-device factor ``num``, against its own refined solve."""
    import spllt_tpu_torch as st
    from spllt_tpu_torch.parallel.rhs import solve_rhs_sharded

    left_solve = kernel_wrappers()["left_solve"]
    b = np.random.default_rng(SEED + 21).standard_normal((a.n, 64))
    x1 = st.solve(num, b)
    out = {}
    for k in (2, 4):
        devices = [torch.device("cuda", i if ncards >= k else 0)
                   for i in range(k)]
        if ncards < k:
            try:
                solve_rhs_sharded(num, b, ndev=k)
            except ValueError:
                pass
            else:
                raise AssertionError(f"solve_rhs_sharded(ndev={k}) ran with "
                                     f"{ncards} card(s)")
        left_solve.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = solve_rhs_sharded(num, b, devices=devices)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = int(left_solve.launches)
        require(launches > 0, f"rhs-sharded k={k}: K5 was never launched")
        err = bwd_err(a, x, b)
        require(err <= BWD_ERR_MAX, f"rhs-sharded k={k}: bwd_err {err}")
        rel = float(np.abs(x - x1).max() / np.abs(x1).max())
        require(rel <= 1e-8, f"rhs-sharded k={k}: differs from the "
                             f"single-device solve by {rel}")
        t0 = time.perf_counter()
        solve_rhs_sharded(num, b, devices=devices)
        out[f"k={k}"] = dict(
            devices=[str(d) for d in devices], launches={"left_solve":
                                                         launches},
            bwd_err=err, vs_single_device_rel=rel, first_wall_ms=wall_ms,
            refined_wall_ms=(time.perf_counter() - t0) * 1e3,
            shards_share_one_card=ncards < k)
    return out


def capi_run(card: str) -> dict:
    """examples/c/simple.c linked against the port's C library (built from
    native/capi.cpp) and run on the card: exit 0, and its printed error
    within its own check (max |x − 1| ≤ 1e-10)."""
    import re

    from spllt_tpu_torch.numeric._build import (build_c_program, build_capi,
                                                embedded_env)

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    lib = build_capi()
    exe = build_c_program(os.path.join(root, "examples", "c", "simple.c"),
                          os.path.join(os.path.dirname(lib), "simple_c"))
    build_s = time.perf_counter() - t0
    env = embedded_env()
    env.pop("SPLLT_CAPI_DEVICE", None)          # the default: the card
    t0 = time.perf_counter()
    p = subprocess.run([exe], env=env, capture_output=True, text=True,
                       timeout=300, cwd=root)
    run_s = time.perf_counter() - t0
    require(p.returncode == 0 and p.stdout.strip().endswith("ok"),
            f"the C example exited {p.returncode}:\n{p.stdout}\n"
            f"{p.stderr[-3000:]}")
    err = float(re.search(r"max \|x - 1\| = (\S+)", p.stdout).group(1))
    require(err <= 1e-10, f"the C example's error {err} > 1e-10")
    return dict(card=card, library=os.path.basename(lib), build_s=build_s,
                run_s=run_s, max_abs_err=err,
                stdout=p.stdout.strip().splitlines())


def forest_phase(card: str, large: bool) -> dict:
    """The forest path through ``factor``/``solve`` with
    ``Options(ndevices=k)`` (on [cuda:0] * k when fewer than k cards are
    visible: said in each record): Poisson 64³ 'mega' f32 at k = 2 and 4
    (unless not ``large``), 32³ 'scan' at k = 2 and 4, 32³ 'mega' k = 2
    (rerun bit for bit; the 'scan' and 'mega' k = 2 runs also against the
    plain versions on the card and with a negative pivot in a shard and in
    the top) and in float64; each against the
    single-device factor of its schedule and dtype (whose ``factor_ms`` is
    timed beside it), with the executors per shard, each kernel's launches
    (exactly those the executors call for), the refined backward error and
    the times of every phase.  Then the rhs-sharded solve at the largest
    size, nrhs 64, over 2 and 4 shards, and the C example on the card.
    Returns {kernel: {run: launches}}."""
    import spllt_tpu_torch as st

    ncards = torch.cuda.device_count()
    emit("forest_cards", card=card, cards_visible=ncards,
         shards_share_one_card=ncards < 2, note="on one card the shards of "
         "a phase run one after the other; phase A is timed shard by shard")
    runs = {64: [("mega", 2, "float32"), ("mega", 4, "float32")],
            32: [("scan", 2, "float32"), ("scan", 4, "float32"),
                 ("mega", 2, "float32"), ("mega", 2, "float64")]}
    launches = {}
    for m in (64, 32) if large else (32,):
        a = st.poisson3d(m)
        b = np.random.default_rng(SEED + 20).standard_normal((a.n, 4))
        t0 = time.perf_counter()
        # one symbolic object serves every device count: the partition
        # prunes the tree for each count itself
        symb = st.analyse(a, main_options(m, "mega"))
        t_analyse = time.perf_counter() - t0
        singles = {}
        for schedule, k, dtype in runs[m]:
            if (schedule, dtype) not in singles:
                opts1 = forest_options(m, schedule, 1, dtype)
                num1 = st.factor(symb, options=opts1)
                singles[schedule, dtype] = (num1, time_ms(
                    lambda: st.factor(symb, options=opts1), 3))
            num1, single_ms = singles[schedule, dtype]
            rec, path = forest_run(
                symb, a, b, forest_options(m, schedule, k, dtype), ncards,
                num1.pool, plain_check=(m, k, dtype) == (32, 2, "float32"),
                rerun=(m, schedule, k, dtype) == (32, "mega", 2, "float32"))
            name = f"{m}^3 {schedule} k={k} {dtype}"
            emit("forest_run", card=card, matrix=f"poisson3d({m})", nb=128,
                 nemin=192, refine=2, nrhs=4, host_analyse_s=t_analyse,
                 single_device_factor_ms=single_ms, **rec)
            for nm, v in path.items():
                launches.setdefault(nm, {})[name] = v
            torch.cuda.empty_cache()
        if m == (64 if large else 32):
            emit("rhs_sharded", card=card, matrix=f"poisson3d({m})",
                 nrhs=64, refine=2, **rhs_sharded_run(
                     singles["mega", "float32"][0], a, ncards))
        del singles
        torch.cuda.empty_cache()
    emit("capi_round_trip", **capi_run(card))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-large", action="store_true",
                    help="skip the poisson3d(64) main-path runs")
    ap.add_argument("--solve-only", action="store_true",
                    help="only the stream main path and the solve stream "
                         "kernel's checks and times (poisson3d 32 and 64)")
    ap.add_argument("--factor-only", action="store_true",
                    help="only the stream main path and the factor stream "
                         "kernel's checks and times (poisson3d 32 and 64)")
    ap.add_argument("--scan-only", action="store_true",
                    help="only the level main path and its four kernels at "
                         "every level shape, per launch (poisson3d 32 and "
                         "64), and their single-tile latencies")
    ap.add_argument("--levels-out", metavar="FILE",
                    help="with --scan-only: write every per-level row of "
                         "the level kernels to FILE (JSON lines)")
    ap.add_argument("--no-run-times", action="store_true",
                    help="with --solve-only: skip the per-run times (for a "
                         "tree whose solve stream has no work_items)")
    ap.add_argument("--entry-only", action="store_true",
                    help="only the entry-point phases: coarse dense "
                         "subtrees (poisson3d 32 and 64, both schedules, "
                         "K1 on every front bucket), the CLI, checkpoints "
                         "and the device trace")
    ap.add_argument("--forest-only", action="store_true",
                    help="only the multi-device phase: the forest path "
                         "(Options(ndevices=k), poisson3d 64 and 32), the "
                         "rhs-sharded solve and the C interface")
    ap.add_argument("--profile", metavar="FILE",
                    help="also write a torch.profiler kernel-time table of "
                         "one factorization and one solve sweep to FILE")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    # float32 products stay full float32 (no TF32) — stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from spllt_tpu_torch.numeric._build import build_all

    card = smi_line()
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)
    emit("build", seconds=build_all())
    if args.solve_only:
        return solve_only(card, not args.no_large, not args.no_run_times,
                          t_start)
    if args.factor_only:
        return factor_only(card, not args.no_large, t_start)
    if args.scan_only:
        return scan_only(card, not args.no_large, t_start, args.levels_out)
    if args.entry_only:
        print(json.dumps({"kernels": entry_phases(card, not args.no_large)}),
              flush=True)
        return finish(t_start)
    if args.forest_only:
        emit("forest_launches", **forest_phase(card, not args.no_large))
        return finish(t_start)

    # level path (schedule='scan') and its four kernels
    rec, num, fex, sex = main_path(32, card, True, "scan")
    emit("main_path", **rec)
    kernels, edge = kernel_phase(num, fex, sex, rec["nrhs"],
                                 rec["launches"])
    emit("kernel_edge_cases", card=card, **edge)
    emit("level_edge_batches", card=card, **level_edge_batches())
    emit("update_synthetic", card=card, **update_synthetic())
    k3 = next(k for k in kernels if k["name"] == "update")
    emit("update_rates", card=card, matrix=rec["matrix"], kernel="update",
         **update_rates(rec["update_gflop"], k3["ms"], k3["device_ms"]))

    def profiled(path, schedule, rec, num, fex, sex):
        """The profiler's breakdown of the main path, its tables to
        ``path``."""
        shares, tables = profile_main_path(num, fex, sex, rec["nrhs"])
        with open(path, "w") as f:
            f.write(tables)
        emit("profile", card=card, matrix=rec["matrix"], schedule=schedule,
             file=path, **shares)

    if args.profile:
        profiled(args.profile, "scan", rec, num, fex, sex)
    scan_pool = num.pool
    del num, fex, sex

    # stream path (schedule='mega') and its two kernels
    rec, num, fex, sex = main_path(32, card, True, "mega")
    emit("main_path", **rec)
    rows, detail = mega_kernel_phase(num, fex, sex, scan_pool, rec["nrhs"],
                                     rec["launches"], run_times=True)
    kernels += rows
    rt = detail["mega_factor"].pop("run_times")
    emit("stream_kernels", card=card, matrix=rec["matrix"], **detail)
    emit("stream_run_times", card=card, matrix=rec["matrix"],
         bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"], **rt)
    emit("factor_item_times", card=card, **factor_item_times())
    emit("solve_run_times", card=card, matrix=rec["matrix"],
         **solve_run_times(num, sex))
    emit("update_rates", card=card, matrix=rec["matrix"],
         kernel="mega_factor UPD runs",
         **update_rates(rec["update_gflop"], rt["upd_ms"]))
    emit("stream_edge_cases", card=card, **edge_stream_phase())
    if args.profile:
        profiled(args.profile + ".mega", "mega", rec, num, fex, sex)
    del num, fex, sex, scan_pool
    torch.cuda.empty_cache()

    if not args.no_large:
        # both main paths again; the level kernels held against their plain
        # versions at every level, the factor stream kernel against its
        # plain version and the level executor's factor, the solve stream
        # kernel against its plain version
        by_name = {k["name"]: k for k in kernels}
        for schedule in ("scan", "mega"):
            rec64, num, fex, sex = main_path(64, card, False, schedule)
            emit("main_path", **rec64)
            if schedule == "scan":
                # K1, K2, K3 and K5 at every level shape of this size too
                _, levels = scan_level_times(num, fex, sex, (rec64["nrhs"],),
                                             plain_times=True)
                for big in level_kernel_rows(levels, fex, rec64["nrhs"],
                                             rec64["launches"], 1e-5):
                    by_name[big["name"]]["large"] = dict(
                        matrix=rec64["matrix"],
                        **{k: big[k] for k in LARGE_KEYS})
                k3 = by_name["update"]["large"]
                emit("update_rates", card=card, matrix=rec64["matrix"],
                     kernel="update", levels_checked=k3["launches_timed"],
                     max_rel_err=k3["rel_err"], **update_rates(
                         rec64["update_gflop"], k3["ms"], k3["device_ms"]))
                scan_pool = num.pool
            else:
                pool0, got, checks = mega_factor_check(num, fex, scan_pool)
                del got, scan_pool
                work = factor_stream_work(fex.stream, 128, 4)
                rt = factor_run_times(fex, pool0, work)
                acc = Acc()
                add_bound(acc, work)
                # whole_ms is the mega_factor kernel's time at this size
                emit("stream_run_times", card=card, matrix=rec64["matrix"],
                     bound_ms=(acc.tb + acc.to) * 1e3,
                     bound_by="bytes" if acc.tb >= acc.to else "operations",
                     checks=checks, **rt)
                emit("update_rates", card=card, matrix=rec64["matrix"],
                     kernel="mega_factor UPD runs",
                     **update_rates(rec64["update_gflop"], rt["upd_ms"]))
                del pool0
                by_name["mega_solve"]["large"] = dict(
                    matrix=rec64["matrix"],
                    **solve_stream_phase(num, sex, rec64, card))
            if args.profile:
                profiled(f"{args.profile}.large.{schedule}", schedule, rec64,
                         num, fex, sex)
            del num, fex, sex
            torch.cuda.empty_cache()

    # coarse dense subtrees, the CLI, checkpoints and the device trace
    kernels += entry_phases(card, not args.no_large)
    # the multi-device paths: each kernel's launches per forest run
    forest = forest_phase(card, not args.no_large)
    for row in kernels:
        if row["name"] in forest:
            row["forest_launches"] = forest[row["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    return finish(t_start)


def finish(t_start: float) -> int:
    """The closing lines: elapsed time, the card's name and power limit, and
    the result line."""
    emit("elapsed", seconds=time.perf_counter() - t_start)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
