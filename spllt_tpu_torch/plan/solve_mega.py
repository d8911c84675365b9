"""Panel-space micro-task stream for the solve stream kernel.

The level solve executor is bound by its per-level launches.  This module
re-expresses the whole forward / backward solve as a stream of nb-row
*window* operations on a flat work array, so that ONE kernel per direction
(see numeric/solve_mega.py) can execute it with no per-level launches — the
replacement for the reference's solve dependency engine and OMP task
managers (SpLLT:src/spllt_solve_dep_mod.F90:27-1609,
task_manager_omp.F90:444-1165).  Own copy of
``spllt_tpu.plan.solve_mega`` (NumPy only); a parity test holds the two
equal field by field.

Layout
------
Work array ``work[P + X, nrhs]``:

* rows [0, P): per-node partial-sum panels (the reference's ``p_upd``
  panels, SpLLT:src/spllt_data_mod.F90:175-209).  Node nd's panel row-tile ib
  lives at flat rows [(node_blk_ptr[nd] + ib)*nb, +nb) — column-0
  blocks of a node are contiguous, so P = (nblocks+1)*nb and the last
  window is scratch (shared with padded tasks).
* rows [P, P + X): the right-hand side in NODE-PADDED order ``xp``:
  node nd's columns occupy [xseg[nd], xseg[nd] + nctiles*nb); the tail
  of the last window is padding so full-window writes never touch
  another node's rows.

Micro-task kinds (fwd / bwd mirror):

  ADDG  gather-add: dst_win[i] += src_win[rel[i]]  (rel[i] = -1 masks).
        Covers INIT (xp -> panel, identity masked to the column count),
        FRED (child below panel -> ancestor panel; the map inverted to
        gather form — segment maps are injective) and the bwd BINIT /
        BRED mirrors.
  MM    matmul-add: dst_win -= blk @ src_win        (fwd update)
  MMT   matmul-add: dst_win -= blk^T @ src_win      (bwd update)
  SOL   in-window triangular solve y = [[L,0],[B,I]]^{-1} z on the
        diagonal tile (covers the diagonal solve AND the within-tile
        below-row update), then writes the window back to BOTH the
        panel and its xp slot (the OUT step fused in).
  SOLT  transposed mirror for bwd (columns >= k pass through).

Reduction routing: each below row of a node is routed to the first
ancestor whose row list contains it (with the standard assembly-tree
subset property this is always the direct parent); the monotone
child-position -> ancestor-position correspondence is chopped into
segments that stay inside one nb-aligned window on both sides.

Leveling: per panel-tile ``add_lvl`` (commutative adds) and ``sol_lvl``
(exclusive solve) with a fixed phase order inside one level —
[ADDG] -> [MM] -> [SOL] — exactly mirroring the factor plan's
last_write/pending scheme (plan/factor_tasks.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .blocking import BlockPlan, blk_id

__all__ = ["SolveMegaPlan", "build_solve_mega_plan",
           "KIND_ADDG", "KIND_MM", "KIND_MMT", "KIND_SOL", "KIND_SOLT"]

KIND_ADDG, KIND_MM, KIND_MMT, KIND_SOL, KIND_SOLT = 0, 1, 2, 3, 4

# phase order inside one level (drain boundaries between runs order them)
_PH_ADDG, _PH_MM, _PH_SOL = 0, 1, 2


@dataclasses.dataclass
class SolveMegaPlan:
    nb: int
    n: int
    P: int                    # panel rows (incl. trailing scratch window)
    X: int                    # xp rows
    xp_src: np.ndarray        # [X] permuted-row index feeding xp (n = pad)
    col_to_xp: np.ndarray     # [n] xp row of permuted column
    # runs: list of dicts {kind, wA, wS, dst, aux, rel[k, nb]} in stream
    # order (the executor flattens them into its tables)
    fwd_runs: list
    bwd_runs: list
    num_tasks: int


def _node_segments(plan: BlockPlan, sparent, nd):
    """Reduction segments of node nd's below rows.

    Returns a list of (src_tile, anc_tile, anc_is_col, p_slots, q_slots)
    where src_tile/anc_tile are global panel-tile ids (col-0 block ids),
    p/q are window-relative slot arrays (child/ancestor side).
    """
    nb = plan.nb
    rows = plan.rows
    rptr = plan.node_rptr
    w = int(plan.node_en[nd] - plan.node_sa[nd] + 1)
    br = rows[rptr[nd] + w: rptr[nd + 1]]
    if len(br) == 0:
        return []
    segs = []
    rem_r = br
    rem_p = np.arange(w, w + len(br), dtype=np.int64)
    a = int(sparent[nd])
    while len(rem_r):
        assert a >= 0, "below row with no ancestor owning it"
        arows = rows[rptr[a]:rptr[a + 1]]
        q = np.searchsorted(arows, rem_r)
        ok = q < len(arows)
        ok[ok] = arows[q[ok]] == rem_r[ok]
        if ok.any():
            pp = rem_p[ok]
            qq = q[ok]
            ct = pp // nb
            at = qq // nb
            cut = np.nonzero((np.diff(ct) != 0) | (np.diff(at) != 0))[0] + 1
            bounds = np.concatenate([[0], cut, [len(pp)]])
            b0c = int(plan.node_blk_ptr[nd])
            b0a = int(plan.node_blk_ptr[a])
            ca = int(plan.node_nctiles[a])
            for s0, s1 in zip(bounds[:-1], bounds[1:]):
                s0, s1 = int(s0), int(s1)
                segs.append((b0c + int(ct[s0]), b0a + int(at[s0]),
                             int(at[s0]) < ca,
                             (pp[s0:s1] % nb).astype(np.int32),
                             (qq[s0:s1] % nb).astype(np.int32)))
        rem_r = rem_r[~ok]
        rem_p = rem_p[~ok]
        a = int(sparent[a]) if len(rem_r) else a
    return segs


def _assemble_runs(addg, mm, sol, mm_kind, sol_kind, nb, scratch_pool):
    """Bucket tasks by (level, phase), dest-sort ADD buckets, emit runs.

    Each task carries the node that emitted it (``own``) so the
    distributed executor can split the stream by subtree owner."""
    zrel = np.zeros(nb, dtype=np.int32)
    tasks = []   # (key, kind, wA, wS, dst, aux, rel, own)
    for (L, wS, dst, rel, nd) in addg:
        tasks.append((L * 4 + _PH_ADDG, KIND_ADDG, scratch_pool, wS, dst,
                      0, rel, nd))
    for (L, wA, wS, dst, nd) in mm:
        tasks.append((L * 4 + _PH_MM, mm_kind, wA, wS, dst, 0, zrel, nd))
    for (L, wA, wS, dst, k, nd) in sol:
        tasks.append((L * 4 + _PH_SOL, sol_kind, wA, wS, dst, k, zrel,
                      nd))
    # stable sort by (key, -k, dst): dest grouping for the RMW pipeline;
    # SOL runs additionally sort by descending column count so groups
    # share a small kvmax and the substitution body's panel skipping
    # pays off (ADD kinds have aux = 0, unaffected)
    tasks.sort(key=lambda t: (t[0], -t[5], t[4]))
    runs = []
    i = 0
    while i < len(tasks):
        j = i
        key = tasks[i][0]
        while j < len(tasks) and tasks[j][0] == key:
            j += 1
        grp = tasks[i:j]
        runs.append({
            "kind": grp[0][1],
            "wA": np.asarray([t[2] for t in grp], np.int64),
            "wS": np.asarray([t[3] for t in grp], np.int64),
            "dst": np.asarray([t[4] for t in grp], np.int64),
            "aux": np.asarray([t[5] for t in grp], np.int64),
            "rel": np.stack([t[6] for t in grp]).astype(np.int32),
            "own": np.asarray([t[7] for t in grp], np.int64),
        })
        i = j
    return runs


def build_solve_mega_plan(symb, plan: BlockPlan) -> SolveMegaPlan:
    nb = plan.nb
    n = symb.n
    forest = symb.forest
    sparent = forest.sparent
    nnodes = plan.nnodes
    nblocks = plan.nblocks
    sa = plan.node_sa
    en = plan.node_en
    Tn = plan.node_ntiles
    Cn = plan.node_nctiles
    b0s = plan.node_blk_ptr
    P = (nblocks + 1) * nb
    scratch_pool = nblocks * nb          # pool flat row base of pad tile
    iden = np.arange(nb, dtype=np.int32)

    # ------------------ xp (node-padded rhs) layout -------------------- #
    xseg = np.zeros(nnodes + 1, dtype=np.int64)
    xseg[1:] = np.cumsum(Cn * nb)
    X = int(xseg[-1])
    xp_src = np.full(X, n, dtype=np.int64)
    col_to_xp = np.empty(n, dtype=np.int64)
    for nd in range(nnodes):
        w = int(en[nd] - sa[nd] + 1)
        xp_src[xseg[nd]:xseg[nd] + w] = np.arange(sa[nd], sa[nd] + w + 0)
        col_to_xp[sa[nd]:sa[nd] + w] = xseg[nd] + np.arange(w)

    segs_per_node = [_node_segments(plan, sparent, nd)
                     for nd in range(nnodes)]

    # ------------------------- forward --------------------------------- #
    add_lvl = np.zeros(nblocks + 1, dtype=np.int64)
    sol_lvl = np.zeros(nblocks + 1, dtype=np.int64)
    F_addg, F_mm, F_sol = [], [], []
    for nd in range(nnodes):
        T = int(Tn[nd])
        C = int(Cn[nd])
        b0 = int(b0s[nd])
        w = int(en[nd] - sa[nd] + 1)
        for jb in range(C):
            k = min(nb, w - jb * nb)
            rel = np.where(iden < k, iden, -1).astype(np.int32)
            F_addg.append((1, P + int(xseg[nd]) + jb * nb,
                           (b0 + jb) * nb, rel, nd))
            add_lvl[b0 + jb] = max(add_lvl[b0 + jb], 1)
        for jb in range(C):
            tile = b0 + jb
            k = min(nb, w - jb * nb)
            L = max(int(add_lvl[tile]), 1)
            d = int(blk_id(plan, nd, jb, jb))
            F_sol.append((L, d * nb, tile * nb,
                          P + int(xseg[nd]) + jb * nb, k, nd))
            sol_lvl[tile] = L
            for ib in range(jb + 1, T):
                blk = int(blk_id(plan, nd, ib, jb))
                F_mm.append((L + 1, blk * nb, tile * nb,
                             (b0 + ib) * nb, nd))
                add_lvl[b0 + ib] = max(add_lvl[b0 + ib], L + 1)
        for (st, at, _a_is_col, pp, qq) in segs_per_node[nd]:
            is_col = (st - b0) < C
            fin = sol_lvl[st] if is_col else add_lvl[st]
            L = int(fin) + 1
            rel = np.full(nb, -1, dtype=np.int32)
            rel[qq] = pp                 # gather form: dst slot q <- src p
            F_addg.append((L, st * nb, at * nb, rel, nd))
            add_lvl[at] = max(add_lvl[at], L)
    fwd_runs = _assemble_runs(F_addg, F_mm, F_sol, KIND_MM, KIND_SOL,
                              nb, scratch_pool)

    # ------------------------- backward -------------------------------- #
    badd = np.zeros(nblocks + 1, dtype=np.int64)
    bsol = np.zeros(nblocks + 1, dtype=np.int64)
    B_addg, B_mm, B_sol = [], [], []
    for nd in range(nnodes - 1, -1, -1):
        T = int(Tn[nd])
        C = int(Cn[nd])
        b0 = int(b0s[nd])
        w = int(en[nd] - sa[nd] + 1)
        for jb in range(C):
            k = min(nb, w - jb * nb)
            rel = np.where(iden < k, iden, -1).astype(np.int32)
            B_addg.append((1, P + int(xseg[nd]) + jb * nb,
                           (b0 + jb) * nb, rel, nd))
            badd[b0 + jb] = max(badd[b0 + jb], 1)
        for (st, at, a_is_col, pp, qq) in segs_per_node[nd]:
            fin = bsol[at] if a_is_col else badd[at]
            L = int(fin) + 1
            rel = np.full(nb, -1, dtype=np.int32)
            rel[pp] = qq                 # gather: dst slot p <- ancestor q
            B_addg.append((L, at * nb, st * nb, rel, nd))
            badd[st] = max(badd[st], L)
        for jb in range(C - 1, -1, -1):
            tile = b0 + jb
            k = min(nb, w - jb * nb)
            for ib in range(T - 1, jb, -1):
                blk = int(blk_id(plan, nd, ib, jb))
                if ib < C:
                    L = int(bsol[b0 + ib]) + 1
                else:
                    L = max(int(badd[b0 + ib]), 1)
                B_mm.append((L, blk * nb, (b0 + ib) * nb, tile * nb, nd))
                badd[tile] = max(badd[tile], L)
            d = int(blk_id(plan, nd, jb, jb))
            L = max(int(badd[tile]), 1)
            B_sol.append((L, d * nb, tile * nb,
                          P + int(xseg[nd]) + jb * nb, k, nd))
            bsol[tile] = L
    bwd_runs = _assemble_runs(B_addg, B_mm, B_sol, KIND_MMT, KIND_SOLT,
                              nb, scratch_pool)

    num_tasks = sum(len(r["wS"]) for r in fwd_runs + bwd_runs)
    return SolveMegaPlan(nb=nb, n=n, P=P, X=X,
                         xp_src=xp_src, col_to_xp=col_to_xp,
                         fwd_runs=fwd_runs, bwd_runs=bwd_runs,
                         num_tasks=num_tasks)
