"""The whole numeric factorization as one stream kernel.

``build_mega_stream`` flattens a FactorPlan into one task stream in
dependency order: per level a run of UPD tasks (the between-node update
micro-tasks merged with the within-node syrk/gemm products as identity-map
tasks, sorted by destination), then the level's POTRF run, then its TRSM
run.  ``mega_factorize`` executes the stream in place on the flat pool
[rows, nb]; ``MegaFactorExecutor`` wraps it behind the interface of
:class:`.factor_scan.ScanFactorExecutor`.

The stream is one set of flat int32 tables for the whole factorization:

  run_ptr [R+1], run_kind [R]   task range and kind of each run
  wr, wc, dst, aux, srcn [K]    per task: two window row bases, the
                                destination row base, aux (UPD: valid
                                columns ``blkn`` of the destination tile;
                                POTRF/TRSM: factor columns ``kv``) and, for
                                UPD, the valid width of the source block
                                column (the contraction stops there)
  eptr [K+1], enr [K], ent      UPD tasks: the live rows and columns as
                                packed entries (``hopper_update.
                                pack_live_entries`` of each UPD run alone, so
                                no ``CHAIN`` crosses a run; POTRF and TRSM
                                tasks have none)
  run_dense [R]                 UPD run r: one block an SM
                                (``hopper_update.dense_level`` of the run)
  seg_ptr, run_seg [R+1]        UPD run r: seg_ptr[run_seg[r]:run_seg[r+1]]
                                are the task offsets of its runs of equal
                                dst (one more entry than segments)
  run_split [R]                 TRSM run r: its work items are bands of
                                ``TRSM_ROWS // run_split[r]`` dst rows of a
                                pair (1, 2 or 4; see :func:`trsm_split`)
  relr, relc [K_upd, nb]        window-relative row maps of the UPD tasks,
  run_rel [R]                   UPD run r: task t has rel row t − run_rel[r]
                                (the plain version's; the kernel reads the
                                packed entries)

What crosses over from ``spllt_tpu.numeric.megakernel.build_mega_stream``
is the task order and the run boundaries (its ``drain`` steps).  Its step
machinery — runs padded to a group size with scratch tasks, keep/sact/seg
bits for the grouped scan, chunks sized by a scalar-table budget and padded
to one shape — serves a sequential grid and has no counterpart here.

Kernel note.  Replaces the TPU kernel ``spllt_tpu/numeric/megakernel.py``
(``mega_factorize`` / ``_kernel``); the source is ``csrc/mega_factor.cu``.
Its bound is the sum of its bodies' bounds (bytes for the sparse update
tasks and the leaf potrf tiles; dependent chains of potrf and trsm near the
root) plus one launch or grid barrier per run.  One call launches the
stream in parts (:func:`run_parts`: a level's UPD run, then its POTRF and
TRSM runs), each in a kernel of its own.  A UPD run is one ordinary launch
of the level path's compact update body (``csrc/update_compact.cuh``, K3's):
one block per destination segment, its tasks multiplied over their live
rows and columns only and summed in registers, the destination's live cells
read and written once; two blocks an SM, or one where the run's ``dense``
flag is set.  A part of POTRF and TRSM runs is one persistent cooperative
launch: it loops over its runs, inside a run whichever block is free takes
the next work item from a counter (POTRF: one tile in place; TRSM: a band of
rows of one pair in place) and a grid barrier at every run boundary orders
the runs; their bodies are K4's own (``csrc/mega_factor_body.cuh``: blocked
in 16-column panels, one warp's registers for each diagonal block, one
thread a row below), since near the root most of their runs have fewer
items than the card has blocks and last as long as one item.  The launch
boundary orders one part, and one UPD run, before the next.  ``precision``
(``Options.precision``) picks the UPD runs' product as it picks K3's
(``hopper_update.body_variant``: float32 pools at 'default' in one TF32
pass on the tensor cores); the POTRF and TRSM runs stay IEEE.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, load, require_cuda_tensors
from .factor_scan import canonical_device
from .hopper_potrf import potrf_plain
from .hopper_trsm import trsm_plain
from .hopper_update import (VARIANT_TAGS, apply_updates_plain,
                            body_variant, build_micro_tasks,
                            dense_edge_tasks, dense_level,
                            pack_live_entries)

__all__ = ["KIND_UPD", "KIND_POTRF", "KIND_TRSM", "TRSM_ROWS", "BLOCKS",
           "build_mega_stream", "trsm_split", "trsm_work_items",
           "run_parts", "stream_to_device", "plain_maps", "upd_edge_runs",
           "mega_factorize", "mega_factorize_plain", "MegaFactorExecutor"]

KIND_UPD, KIND_POTRF, KIND_TRSM = 0, 1, 2
# dst rows of a TRSM work item in an unsplit run, and the block count the
# split is sized for (two blocks on each of the H100's 132 SMs); neither
# depends on the grid a launch gets, so neither does any result
TRSM_ROWS, BLOCKS = 64, 264

_TASK_KEYS = ("wr", "wc", "dst", "aux", "srcn")
# what the kernel reads on the device, in the order of its C arguments
_DEV_KEYS = ("run_ptr", "run_kind", "run_split", "seg_ptr", "wr", "wc",
             "dst", "aux", "srcn", "eptr", "enr", "ent")
# the plain version's maps, on the device only where it runs (the CPU)
_PLAIN_KEYS = ("relr", "relc")
# per-run tables the host keeps
_HOST_KEYS = ("run_ptr", "run_kind", "run_seg", "run_rel", "run_split",
              "run_dense")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {f"spllt_mega_factor_{s}":
        [_P] * 14 + [_I, _I, _P, _P, _I, _P, _P, _I,
                     ctypes.POINTER(ctypes.c_int), _P]
        for s in ("f32", "f64", "f32_tf32")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def segment_offsets(dst: np.ndarray, base: int = 0) -> np.ndarray:
    """Offsets (plus ``base``) of the runs of equal value in the sorted
    ``dst``, with the end appended: nseg + 1 entries."""
    k = len(dst)
    starts = np.flatnonzero(np.diff(dst, prepend=-1)) if k else \
        np.empty(0, np.int64)
    return (np.concatenate([starts, [k]]) + base).astype(np.int64)


def build_mega_stream(fp, pool_rows: int) -> dict:
    """Flatten the FactorPlan into the factor stream (NumPy int32 tables,
    see the module docstring).  Raises ``ValueError`` when a table breaks
    what the kernel relies on."""
    nb = fp.nb
    iden = np.arange(nb, dtype=np.int32)
    runs = []        # (kind, {wr, wc, dst, aux, srcn}, relr, relc)

    for lvl in range(1, fp.nlevels + 1):
        # ---- UPD: between-update micro-tasks + intra-node syrk ------- #
        mt = build_micro_tasks(fp, lvl, lvl, nb, pool_rows)
        s0, s1 = int(fp.syrk_ptr[lvl]), int(fp.syrk_ptr[lvl + 1])
        k_syrk = s1 - s0
        if len(mt["dst"]) + k_syrk:
            sdst = np.asarray(fp.syrk_dst[s0:s1], np.int64)
            ssrc_j = np.asarray(fp.syrk_src_j[s0:s1], np.int64)
            cols = {
                "dst": np.concatenate([mt["dst"].astype(np.int64) * nb,
                                       sdst * nb]),
                "wr": np.concatenate([
                    mt["lor"].astype(np.int64),
                    np.asarray(fp.syrk_src_i[s0:s1], np.int64) * nb]),
                "wc": np.concatenate([mt["loc"].astype(np.int64),
                                      ssrc_j * nb]),
                "aux": np.concatenate([mt["blkn"].astype(np.int64),
                                       fp.blk_n[sdst].astype(np.int64)]),
                "srcn": np.concatenate([mt["srcn"].astype(np.int64),
                                        fp.blk_n[ssrc_j].astype(np.int64)]),
            }
            relr = np.concatenate([mt["relr"], np.tile(iden, (k_syrk, 1))])
            relc = np.concatenate([mt["relc"], np.tile(iden, (k_syrk, 1))])
            order = np.argsort(cols["dst"], kind="stable")
            runs.append((KIND_UPD, {k: v[order] for k, v in cols.items()},
                         relr[order], relc[order]))
        # ---- POTRF (the plan sorts by descending kv) ----------------- #
        p0, p1 = int(fp.potrf_ptr[lvl]), int(fp.potrf_ptr[lvl + 1])
        if p1 > p0:
            blk = np.asarray(fp.potrf_blk[p0:p1], np.int64) * nb
            runs.append((KIND_POTRF, {
                "wr": blk, "wc": blk, "dst": blk,
                "aux": np.asarray(fp.potrf_k[p0:p1], np.int64),
                "srcn": np.zeros(p1 - p0, np.int64)}, None, None))
        # ---- TRSM ---------------------------------------------------- #
        t0, t1 = int(fp.trsm_ptr[lvl]), int(fp.trsm_ptr[lvl + 1])
        if t1 > t0:
            dstt = np.asarray(fp.trsm_dst[t0:t1], np.int64) * nb
            runs.append((KIND_TRSM, {
                "wr": np.asarray(fp.trsm_diag[t0:t1], np.int64) * nb,
                "wc": dstt, "dst": dstt,
                "aux": np.asarray(fp.trsm_k[t0:t1], np.int64),
                "srcn": np.zeros(t1 - t0, np.int64)}, None, None))
    return assemble_stream(runs, nb, pool_rows)


def trsm_split(npairs: int, nb: int) -> int:
    """How finely a TRSM run of ``npairs`` pairs cuts each pair: 4, 2 or 1
    (bands of 16, 32 or 64 dst rows), the most that keeps the run's items
    within ``BLOCKS``, so that a run with few pairs spreads over more
    blocks."""
    items = npairs * -(-nb // TRSM_ROWS)
    return 4 if 4 * items <= BLOCKS else 2 if 2 * items <= BLOCKS else 1


def trsm_work_items(stream: dict) -> list:
    """The TRSM work items of each run as the kernel forms them: per run a
    list of (task offset in the run, first dst row, rows); empty for the
    other kinds."""
    h = stream["host"] if "host" in stream else stream
    nb = stream["nb"]
    out = []
    for r, kind in enumerate(h["run_kind"]):
        items = []
        if kind == KIND_TRSM:
            rows = TRSM_ROWS // int(h["run_split"][r])
            for t in range(int(h["run_ptr"][r + 1]) - int(h["run_ptr"][r])):
                for r0 in range(0, nb, rows):
                    items.append((t, r0, min(rows, nb - r0)))
        out.append(items)
    return out


def assemble_stream(runs, nb: int, pool_rows: int) -> dict:
    """Concatenate runs ``(kind, {wr, wc, dst, aux, srcn}, relr, relc)``
    into the flat tables, packing each UPD run's live entries on its own,
    and check what the kernel relies on: windows inside the pool, ``dst``
    tile-aligned everywhere and sorted inside a UPD run, map entries in
    [-1, nb), ``aux`` and ``srcn`` in [0, nb], nb below 2**15 (the packed
    entries), ``pool_rows`` at most 2**31 (the tables hold row bases in
    int32; the kernels form each element offset, row base × nb, in 64
    bits)."""
    if nb >= 2 ** 15:
        raise ValueError("factor stream: nb must be below 2**15")
    if pool_rows > 2 ** 31:
        raise ValueError("factor stream: pool rows past 2**31 do not fit "
                         "the int32 row bases")
    run_ptr, run_kind, run_seg, run_rel, run_split = [0], [], [0], [], []
    run_dense, seg_ptr, relr_all, relc_all = [], [], [], []
    estart, enr_all, ent_all = [], [], []
    cols = {k: [] for k in _TASK_KEYS}
    ntask = nrel = nsegent = nent = 0
    for kind, tab, relr, relc in runs:
        k = len(tab["dst"])
        for nm in _TASK_KEYS:
            a = np.asarray(tab[nm], np.int64)
            if a.shape != (k,):
                raise ValueError(f"factor stream: {nm} must be [{k}]")
            hi = pool_rows - nb if nm in ("wr", "wc", "dst") else nb
            if k and (a.min() < 0 or a.max() > hi):
                raise ValueError(f"factor stream: {nm} outside [0, {hi}]")
            cols[nm].append(a)
        if (np.asarray(tab["dst"]) % nb).any():
            raise ValueError("factor stream: dst is not tile-aligned")
        run_rel.append(ntask - nrel)
        if kind == KIND_UPD:
            if (np.diff(tab["dst"]) < 0).any():
                raise ValueError("factor stream: dst must be sorted inside "
                                 "a UPD run")
            for nm, a in (("relr", relr), ("relc", relc)):
                a = np.asarray(a)
                if a.shape != (k, nb):
                    raise ValueError(f"factor stream: {nm} must be [K, nb]")
                if k and (a.min() < -1 or a.max() >= nb):
                    raise ValueError(f"factor stream: {nm} outside [-1, nb)")
            relr_all.append(np.asarray(relr, np.int32))
            relc_all.append(np.asarray(relc, np.int32))
            seg = segment_offsets(np.asarray(tab["dst"]), ntask)
            seg_ptr.append(seg)
            nsegent += len(seg)
            nrel += k
            eptr, enr, ent = pack_live_entries(relr, relc, tab["aux"],
                                               tab["dst"], nb)
            estart.append(eptr[:-1].astype(np.int64) + nent)
            enr_all.append(enr)
            ent_all.append(ent)
            nent += int(eptr[-1])
            run_dense.append(int(dense_level(enr, eptr, len(seg) - 1, nb)))
        elif kind not in (KIND_POTRF, KIND_TRSM):
            raise ValueError(f"factor stream: unknown kind {kind}")
        else:
            estart.append(np.full(k, nent, np.int64))
            enr_all.append(np.zeros(k, np.int32))
            run_dense.append(0)
        ntask += k
        run_ptr.append(ntask)
        run_kind.append(kind)
        run_seg.append(nsegent)
        run_split.append(trsm_split(k, nb) if kind == KIND_TRSM else 1)

    if nent >= 2 ** 31:
        raise ValueError("factor stream: too many live entries for int32")

    def cat(parts, shape=(0,)):
        return (np.concatenate(parts) if parts
                else np.empty(shape, np.int64)).astype(np.int32)

    out = {nm: cat(cols[nm]) for nm in _TASK_KEYS}
    out.update(run_ptr=np.asarray(run_ptr, np.int32),
               run_kind=np.asarray(run_kind, np.int32),
               run_seg=np.asarray(run_seg, np.int32),
               run_rel=np.asarray(run_rel, np.int32),
               run_split=np.asarray(run_split, np.int32),
               run_dense=np.asarray(run_dense, np.int32),
               seg_ptr=cat(seg_ptr), relr=cat(relr_all, (0, nb)),
               relc=cat(relc_all, (0, nb)),
               eptr=cat(estart + [np.asarray([nent])]), enr=cat(enr_all),
               ent=cat(ent_all), nb=nb, pool_rows=pool_rows)
    return out


def upd_edge_runs(nb: int, seed: int):
    """Two hand-made UPD runs, one after the other, for the checks of the
    stream's UPD launches on the card, and the pool rows they need.  Run 1
    (destinations tiles 24–67, sources from tile 88 on): one segment of four
    identity-map (syrk) tasks, a chain, at srcn nb, 17, 0 and 1; an
    identity task at blkn nb // 2 alone; one segment of three sparse tasks
    with the same live rows and columns (a chain) and a fourth with others;
    40 one-task segments of 1–5 live rows and columns; an identity task at
    srcn 0 alone.  Run 2: :func:`.hopper_update.dense_edge_tasks` (24
    destinations, chains of near-dense tasks, a run flagged ``dense``),
    whose windows read the tiles run 1 wrote."""
    rng = np.random.default_rng(seed)
    dense, rows2 = dense_edge_tasks(nb, seed)      # windows in tiles 24–87
    src0, ntile = rows2 // nb, rows2 // nb + 40
    iden = np.arange(nb)

    def live(count):
        rel = np.full(nb, -1)
        rel[rng.permutation(nb)[:count]] = rng.integers(0, nb, count)
        return rel

    def window():
        return int(rng.integers(src0 * nb, (ntile - 1) * nb + 1))

    tasks = []          # (dst tile, wr, wc, blkn, srcn, relr, relc)
    for kn in (nb, min(17, nb), 0, 1):
        i, j = rng.integers(src0, ntile, 2)
        tasks.append((24, i * nb, j * nb, nb, kn, iden, iden))
    i, j = rng.integers(src0, ntile, 2)
    tasks.append((25, i * nb, j * nb, nb // 2, nb, iden, iden))
    rr, rc = live(max(1, nb // 3)), live(max(1, nb // 2))
    for q in range(4):
        if q == 3:
            rr, rc = live(max(1, nb // 4)), live(nb)
        tasks.append((26, window(), window(), nb, int(rng.integers(1, nb + 1)),
                      np.where(rr >= 0, rng.integers(0, nb, nb), -1),
                      np.where(rc >= 0, rng.integers(0, nb, nb), -1)))
    for tile in range(27, 67):
        tasks.append((tile, window(), window(), nb,
                      int(rng.integers(1, min(8, nb) + 1)),
                      live(int(rng.integers(1, min(5, nb) + 1))),
                      live(int(rng.integers(1, min(5, nb) + 1)))))
    i, j = rng.integers(src0, ntile, 2)
    tasks.append((67, i * nb, j * nb, nb, 0, iden, iden))
    d, wr, wc, blkn, srcn, relr, relc = zip(*tasks)
    runs = [(KIND_UPD, {"wr": np.asarray(wr), "wc": np.asarray(wc),
                        "dst": np.asarray(d) * nb, "aux": np.asarray(blkn),
                        "srcn": np.asarray(srcn)},
             np.stack(relr), np.stack(relc)),
            (KIND_UPD, {"wr": dense["lor"], "wc": dense["loc"],
                        "dst": dense["dst"].astype(np.int64) * nb,
                        "aux": dense["blkn"], "srcn": dense["srcn"]},
             dense["relr"], dense["relc"])]
    return runs, ntile * nb


def tables_to_device(stream: dict, dev_keys, meta_keys, device,
                     host_keys=("run_ptr", "run_kind", "run_seg", "run_rel",
                                "run_split")) -> dict:
    """The tables ``dev_keys`` of a stream as int32 tensors on ``device``;
    the per-run tables ``host_keys`` stay available on the host (under
    ``host``) for the launches and the plain version's loop over the runs,
    and ``meta_keys`` are copied."""
    out = {k: torch.as_tensor(np.ascontiguousarray(stream[k], np.int32),
                              device=device) for k in dev_keys}
    out["host"] = {k: np.asarray(stream[k]) for k in host_keys}
    for k in meta_keys:
        out[k] = stream[k]
    return out


def run_parts(run_kind) -> tuple:
    """The stream's runs in parts of one kind each, UPD runs or POTRF and
    TRSM runs, as the kernel launches them (a launch per UPD run, one
    cooperative launch per POTRF/TRSM part):
    (part starts with the end appended, int32 [P + 1]; whether each part is
    POTRF/TRSM, int32 [P])."""
    fac = np.asarray(run_kind) != KIND_UPD
    starts = np.flatnonzero(np.diff(fac.astype(np.int8), prepend=-1))
    return (np.append(starts, len(fac)).astype(np.int32),
            fac[starts].astype(np.int32))


def stream_to_device(stream: dict, device) -> dict:
    """The factor stream's tables on ``device`` (see
    :func:`tables_to_device`), with its parts (:func:`run_parts`) on the
    host.  The kernel reads the packed entries; the plain version's maps
    ``relr``/``relc`` stay on the host (int16, under ``host``) and go to the
    device only where the plain version runs, the CPU
    (:func:`plain_maps`)."""
    dev = torch.device(device)
    out = tables_to_device(
        stream, _DEV_KEYS + (_PLAIN_KEYS if dev.type == "cpu" else ()),
        ("nb", "pool_rows"), dev, _HOST_KEYS)
    for k in _PLAIN_KEYS:
        out["host"][k] = np.asarray(stream[k], np.int16)
    out["parts"], out["part_fac"] = run_parts(stream["run_kind"])
    return out


def plain_maps(stream: dict, device) -> dict:
    """``relr``/``relc`` of a device stream's UPD tasks on ``device``: the
    stream's own tensors where they are there, else copies of the host's."""
    return {k: stream[k] if k in stream and stream[k].device == device
            else torch.as_tensor(stream["host"][k], device=device)
            for k in _PLAIN_KEYS}


def mega_factorize_plain(poolf: torch.Tensor, stream: dict,
                         precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version (any device), in place on ``poolf`` [rows, nb]:
    a loop over the runs calling the plain update (at ``precision``),
    potrf and trsm on the tiles the tables name."""
    nb = stream["nb"]
    pool = poolf.view(-1, nb, nb)
    h = stream["host"]
    maps = plain_maps(stream, poolf.device)
    for r, kind in enumerate(h["run_kind"]):
        t0, t1 = int(h["run_ptr"][r]), int(h["run_ptr"][r + 1])
        sl = slice(t0, t1)
        if kind == KIND_UPD:
            rel = slice(t0 - int(h["run_rel"][r]), t1 - int(h["run_rel"][r]))
            apply_updates_plain(poolf, {
                "dst": stream["dst"][sl] // nb, "lor": stream["wr"][sl],
                "loc": stream["wc"][sl], "blkn": stream["aux"][sl],
                "srcn": stream["srcn"][sl], "relr": maps["relr"][rel],
                "relc": maps["relc"][rel]}, precision)
        elif kind == KIND_POTRF:
            blk = (stream["dst"][sl] // nb).to(torch.int64)
            pool[blk] = potrf_plain(pool[blk], stream["aux"][sl])
        else:
            diag = (stream["wr"][sl] // nb).to(torch.int64)
            dst = (stream["dst"][sl] // nb).to(torch.int64)
            pool[dst] = trsm_plain(pool[diag], pool[dst], stream["aux"][sl])
    return poolf


def mega_factorize(poolf: torch.Tensor, stream: dict,
                   max_blocks: int = 0,
                   precision: str = "highest") -> torch.Tensor:
    """``poolf`` [rows, nb] float32/float64, factored in place and returned;
    ``stream`` as :func:`stream_to_device` returns it, on the same device.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    its UPD runs with the product ``precision`` picks
    (``hopper_update.body_variant``; no other: a TF32 body that fails
    raises).  Calls count per variant (``hopper_update.VARIANT_TAGS``):
    ``launches`` (IEEE), ``launches_tf32``.  ``max_blocks`` > 0 caps the
    grid of the POTRF/TRSM launches (tests of their item loops; a UPD
    launch runs one block per segment); the most blocks one of them ran is
    left in ``mega_factorize.last_grid``."""
    variant = body_variant(poolf.dtype, precision)
    if poolf.device.type == "cpu":
        return mega_factorize_plain(poolf, stream, precision)
    tens = [stream[k] for k in _DEV_KEYS]
    require_cuda_tensors("mega_factorize", poolf, *tens)
    nb = stream["nb"]
    if poolf.ndim != 2 or poolf.shape != (stream["pool_rows"], nb):
        raise ValueError(f"mega_factorize: pool must be "
                         f"[{stream['pool_rows']}, {nb}], got "
                         f"{tuple(poolf.shape)}")
    if poolf.dtype not in _SUFFIX or any(t.dtype != torch.int32
                                         for t in tens):
        raise ValueError("mega_factorize: pool must be float32/float64 and "
                         "the stream tables int32")
    nruns = stream["run_kind"].shape[0]
    if nruns == 0:
        return poolf
    suffix, count = VARIANT_TAGS[variant]
    fn = getattr(load("mega_factor", _SIG),
                 "spllt_mega_factor_" + _SUFFIX[poolf.dtype] + suffix)
    grid = ctypes.c_int(0)
    # one work-item counter per run, zero at launch
    counters = torch.zeros(nruns, dtype=torch.int32, device=poolf.device)
    parts, part_fac = stream["parts"], stream["part_fac"]
    h = stream["host"]
    with torch.cuda.device(poolf.device):
        status = fn(poolf.data_ptr(), *(t.data_ptr() for t in tens),
                    counters.data_ptr(), nruns, nb, parts.ctypes.data,
                    part_fac.ctypes.data, len(part_fac),
                    h["run_seg"].ctypes.data, h["run_dense"].ctypes.data,
                    int(max_blocks),
                    ctypes.byref(grid),
                    torch.cuda.current_stream().cuda_stream)
    check_launch(status, "mega_factorize")
    setattr(mega_factorize, count, getattr(mega_factorize, count) + 1)
    mega_factorize.last_grid = grid.value
    return poolf


mega_factorize.launches = 0
mega_factorize.launches_tf32 = 0
mega_factorize.last_grid = 0


class MegaFactorExecutor:
    """Holds the factor stream of one FactorPlan on ``device``; call-compatible
    with :class:`.factor_scan.ScanFactorExecutor`.

    The tables do not depend on the matrix values, so one executor serves
    every refactorization of the same pattern.  float32 and float64 pools
    are both taken (one kernel template), at any nb; ``matmul_precision``
    (``Options.precision``) picks the UPD runs' product
    (:func:`mega_factorize`)."""

    def __init__(self, fp, dtype: torch.dtype = torch.float32,
                 matmul_precision: str = "highest", device="cuda"):
        if dtype not in _SUFFIX:
            raise ValueError(f"the factor stream kernel takes float32 or "
                             f"float64 pools, not {dtype}")
        self.fp = fp
        self.nb = fp.nb
        self.dtype = dtype
        self.precision = matmul_precision
        self.device = canonical_device(device)
        self.pool_rows = (fp.nblocks + 1) * fp.nb
        stream = build_mega_stream(fp, self.pool_rows)
        self.num_runs = len(stream["run_kind"])
        self.num_tasks = len(stream["dst"])
        self.stream = stream_to_device(stream, self.device)

    def __call__(self, pool: torch.Tensor):
        """pool: [nblocks+1, nb, nb] on the executor's device, with the
        trailing zero block.  Factored IN PLACE.  Returns (pool,
        not_posdef_flag); the flag is a 0-d bool tensor (a failed potrf
        tile is NaN everywhere and NaNs spread from there), read it with
        ``bool()``."""
        fp = self.fp
        if pool.shape != (fp.nblocks + 1, self.nb, self.nb):
            raise ValueError("pool must be [nblocks+1, nb, nb] (with the "
                             "trailing zero block)")
        if pool.dtype != self.dtype or pool.device != self.device \
                or not pool.is_contiguous():
            raise ValueError(
                f"pool must be contiguous {self.dtype} on {self.device}, "
                f"got {pool.dtype} on {pool.device}")
        mega_factorize(pool.view(-1, self.nb), self.stream,
                       precision=self.precision)
        notpos = torch.isnan(pool[:, 0, 0].sum())
        return pool, notpos
