"""Multi-device forest-parallel factorization and solve.

Counterpart of ``spllt_tpu.parallel.forest``.  The elimination forest is
partitioned: the flop-balanced layer of the tree pruning assigns whole
subtrees to devices (LPT bin packing on subtree weight), and the blocks of
the nodes above that layer form the *top*.  Device d holds a local pool

    [the top blocks (ntop) | its subtrees' blocks (nown[d]) | a zero block]

with the blocks of each region in global order (the reference's layout
without its padding to one size).

Factorization (one process issues every device's work):

  A. local: each device factors its subtrees with the executor its schedule
     names — :class:`..numeric.factor_scan.ScanFactorExecutor` (K1, K2, K3)
     or :class:`..numeric.megakernel.MegaFactorExecutor` (K4) — on a
     FactorPlan-shaped view of its own tasks with local block ids; the
     between-node updates into top ancestors accumulate in the zero top
     region of its pool.
  B. reduce: on the first device, top = assembled top + Σ_d contributions,
     summed in device order (copies between cards where the devices
     differ), so reruns are bit for bit equal.
  C. top: the first device factors the top subforest in its pool, and the
     factored top is copied into every other pool: the top is bit for bit
     the same on every device.

Solve (job 0: both sweeps; 1: forward; 2: backward), on a panel that the
first device holds between the phases: forward = every device's local
sweep on its own copy, x = x0 + Σ_d (x_d − x0) in device order, then the
top sweep; backward = the top sweep, then the local sweeps and the same
merge.  The level schedule runs :class:`..numeric.solve_scan.ScanSolveExecutor`
(K5) per device; ``'mega'`` runs :class:`..numeric.solve_mega.MegaSolveExecutor`
(K6) on the per-device streams of :mod:`.forest_mega`.

What the reference needs for ``shard_map`` — every device's tables padded
to one shape (level buckets, scratch-block tasks, ``ppart``) — has no
counterpart: each device gets tables and a pool of its own size.  Its
overlap of the reduction with later phase-A buckets is not done here.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..numeric.factor_scan import canonical_device

__all__ = ["ForestPartition", "partition_forest", "MultiDeviceFactor",
           "build_multidevice_factor", "reconstruct_global_pool",
           "ForestExecutor", "FACTOR_FIELDS", "SOLVE_FIELDS"]

# the fields of each task kind, in the order of the reference's task tuples
FACTOR_FIELDS = {"potrf": ("blk", "k"), "trsm": ("diag", "dst", "k"),
                 "syrk": ("i", "j", "dst"),
                 "updbt": ("dst", "mr", "mc", "svp", "c")}
SOLVE_FIELDS = {"sol": ("blk", "rows", "k"),
                "upd": ("blk", "rows", "c0", "k")}
# the FactorPlan attribute of each factor field
_FPLAN_ATTR = {"potrf": ("potrf_blk", "potrf_k"),
               "trsm": ("trsm_diag", "trsm_dst", "trsm_k"),
               "syrk": ("syrk_src_i", "syrk_src_j", "syrk_dst"),
               "updbt": ("updbt_dst", "updbt_mr", "updbt_mc", "updbt_svp",
                         "updbt_c")}
# fields that hold block ids (mapped to local ids)
_BLOCK_FIELDS = {"blk", "diag", "dst", "i", "j"}


@dataclasses.dataclass
class ForestPartition:
    ndev: int
    part_of_node: np.ndarray    # device per node, -1 = top
    ntop: int                   # top blocks (local ids 0..ntop-1)
    nown: np.ndarray            # [ndev] blocks of each device's subtrees
    blk_local: np.ndarray       # global blk -> local id (within its region)
    blk_dev: np.ndarray         # global blk -> device or -1 (top)

    @property
    def nlocal(self) -> np.ndarray:
        """[ndev] blocks of each local pool, the zero block included."""
        return self.ntop + self.nown + 1


def partition_forest(symb, plan, ndev: int) -> ForestPartition:
    """Assign pruned subtrees to devices (LPT bin packing on flop weight)."""
    from ..analyse.prune import prune_tree, subtree_list

    small = prune_tree(symb.forest, symb.weight, ndev)
    subtrees = subtree_list(symb.forest, small)
    part_of_node = np.full(plan.nnodes, -1, dtype=np.int64)
    # LPT: heaviest subtree first onto the least loaded device
    loads = np.zeros(ndev)
    order = np.argsort([-symb.weight[t[-1]] for t in subtrees])
    for si in order:
        t = subtrees[si]
        d = int(np.argmin(loads))
        loads[d] += float(symb.weight[t[-1]])
        part_of_node[t] = d

    blk_dev = part_of_node[plan.blk_node]
    ntop = int(np.sum(blk_dev == -1))
    blk_local = np.empty(plan.nblocks, dtype=np.int64)
    blk_local[blk_dev == -1] = np.arange(ntop)
    nown = np.zeros(ndev, dtype=np.int64)
    for d in range(ndev):
        sel = blk_dev == d
        nown[d] = int(np.sum(sel))
        blk_local[sel] = ntop + np.arange(nown[d])
    return ForestPartition(ndev=ndev, part_of_node=part_of_node, ntop=ntop,
                           nown=nown, blk_local=blk_local, blk_dev=blk_dev)


def _levels(ptr) -> np.ndarray:
    """The level of each task of a level-bucketed table."""
    ptr = np.asarray(ptr, np.int64)
    return np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))


def _ptr(lvl: np.ndarray, nlevels: int) -> np.ndarray:
    """Level offsets [nlevels+2] of a level-sorted task table."""
    counts = np.bincount(lvl, minlength=nlevels + 1)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _split(owner, ndev: int, lvl, fields: dict, blk_local):
    """Split one task kind by owner, keeping the order: ([ndev] tables,
    top table), each {'lvl', field...} with block fields as local ids."""
    out = []
    for d in list(range(ndev)) + [-1]:
        sel = np.flatnonzero(owner == d)
        t = {"lvl": lvl[sel]}
        for nm, a in fields.items():
            a = np.asarray(a)[sel].astype(np.int64)
            t[nm] = blk_local[a] if nm in _BLOCK_FIELDS else a
        out.append(t)
    return out[:-1], out[-1]


@dataclasses.dataclass
class MultiDeviceFactor:
    """The host plan of the forest path for (symb, plan, ndev): the
    partition, the per-device and top task tables of the factorization and
    of the solve, and the assembly split."""

    part: ForestPartition
    nb: int
    n: int
    nlevels: int
    maps: np.ndarray
    srcvec_local: np.ndarray    # srcvec with local block ids
    blk_n_local: list           # [ndev] valid columns per local block
    a_tasks: dict               # kind -> [ndev] task tables (phase A)
    c_tasks: dict               # kind -> task table of the top (phase C)
    s_tasks: dict | None        # 'fwd'/'bwd' -> kind -> ([ndev], top)
    nlevels_solve: tuple        # (forward, backward)
    asm: list                   # [ndev] (local rowflat, col, value index)
    top_asm: tuple              # the same for the top region

    def factor_view(self, dev: int):
        """A FactorPlan-shaped view of device ``dev``'s phase-A tasks (or,
        for ``dev`` = -1, of the top's phase-C tasks on the first device's
        pool), with local block ids, for the factor executors."""
        blk_n = self.blk_n_local[max(dev, 0)]
        view = dict(nb=self.nb, nblocks=len(blk_n) - 1, nlevels=self.nlevels,
                    maps=self.maps, srcvec=self.srcvec_local, blk_n=blk_n,
                    dense=None, num_tasks=0)
        for kind, attrs in _FPLAN_ATTR.items():
            t = self.a_tasks[kind][dev] if dev >= 0 else self.c_tasks[kind]
            view[kind + "_ptr"] = _ptr(t["lvl"], self.nlevels)
            for nm, attr in zip(FACTOR_FIELDS[kind], attrs):
                view[attr] = t[nm]
            view["num_tasks"] += len(t["lvl"])
        return types.SimpleNamespace(**view)

    def solve_view(self, dev: int):
        """A SolvePlan-shaped view of device ``dev``'s solve tasks (-1: the
        top's), with local block ids, for the level solve executor."""
        view = dict(nb=self.nb, n=self.n, nlevels_fwd=self.nlevels_solve[0],
                    nlevels_bwd=self.nlevels_solve[1])
        for (dirn, p), nlev in zip((("fwd", "f"), ("bwd", "b")),
                                   self.nlevels_solve):
            for kind, names in SOLVE_FIELDS.items():
                per, top = self.s_tasks[dirn][kind]
                t = per[dev] if dev >= 0 else top
                view[f"{p}{kind}_ptr"] = _ptr(t["lvl"], nlev)
                for nm in names:
                    view[f"{p}{kind}_{nm}"] = t[nm]
        return types.SimpleNamespace(**view)

    def local_pools(self, values: np.ndarray, dtype: torch.dtype, devices):
        """The assembled local pools ([ndev] tensors [nlocal_d, nb, nb] on
        ``devices``, top region zero) and the assembled top [ntop, nb, nb]
        on the first device."""
        nb = self.nb
        vals = np.asarray(values, np.float64)

        def assemble(rowflat, col, idx, nblk, dev):
            poolf = torch.zeros((nblk * nb, nb), dtype=dtype, device=dev)
            poolf.index_put_(
                (torch.as_tensor(rowflat, device=dev),
                 torch.as_tensor(col, device=dev)),
                torch.as_tensor(vals[idx], device=dev).to(dtype),
                accumulate=True)
            return poolf.view(nblk, nb, nb)

        pools = [assemble(*self.asm[d], int(self.part.nlocal[d]), dev)
                 for d, dev in enumerate(devices)]
        top = assemble(*self.top_asm, self.part.ntop, devices[0])
        return pools, top


def build_multidevice_factor(symb, plan, fplan, ndev: int, splan=None
                             ) -> MultiDeviceFactor:
    """Partition the factor plan (and the solve plan, when given) into
    per-device phase-A task tables and the top's phase-C tables, and the
    assembly into per-device parts."""
    part = partition_forest(symb, plan, ndev)
    nb = plan.nb
    L = part.blk_local
    blk_dev = part.blk_dev
    node_shift = L[plan.node_blk_ptr[:-1]] - plan.node_blk_ptr[:-1]

    a_tasks, c_tasks = {}, {}
    for kind, attrs in _FPLAN_ATTR.items():
        fields = {nm: np.asarray(getattr(fplan, attr))
                  for nm, attr in zip(FACTOR_FIELDS[kind], attrs)}
        if kind == "updbt":      # owned by the device of the source node
            owner = part.part_of_node[fplan.srcvec_node[fields["svp"]]]
        else:                    # by the device of the first block
            owner = blk_dev[fields[FACTOR_FIELDS[kind][0]]]
        a_tasks[kind], c_tasks[kind] = _split(
            owner, ndev, _levels(getattr(fplan, kind + "_ptr")), fields, L)
    # a device's tasks only read srcvec entries of its own nodes, the top's
    # only those of top nodes: one table serves all
    srcvec_local = (np.asarray(fplan.srcvec, np.int64)
                    + node_shift[fplan.srcvec_node]).astype(np.int64)
    blk_n = np.asarray(plan.blk_n, np.int64)
    blk_n_local = [np.concatenate([blk_n[blk_dev == -1], blk_n[blk_dev == d],
                                   [nb]]) for d in range(ndev)]

    s_tasks, nlevels_solve = None, (0, 0)
    if splan is not None:
        s_tasks = {}
        for dirn, p in (("fwd", "f"), ("bwd", "b")):
            s_tasks[dirn] = {}
            for kind, names in SOLVE_FIELDS.items():
                fields = {nm: np.asarray(getattr(splan, f"{p}{kind}_{nm}"))
                          for nm in names}
                s_tasks[dirn][kind] = _split(
                    blk_dev[fields["blk"]], ndev,
                    _levels(getattr(splan, f"{p}{kind}_ptr")), fields, L)
        nlevels_solve = (int(splan.nlevels_fwd), int(splan.nlevels_bwd))

    asm_rowflat = np.asarray(plan.asm_rowflat, np.int64)
    asm_blk = asm_rowflat // nb
    asm_dev = blk_dev[asm_blk]
    rowflat_local = L[asm_blk] * nb + asm_rowflat % nb
    asm_col = np.asarray(plan.asm_col, np.int64)
    asm = []
    for d in list(range(ndev)) + [-1]:
        sel = np.flatnonzero(asm_dev == d)
        asm.append((rowflat_local[sel], asm_col[sel], sel))

    return MultiDeviceFactor(
        part=part, nb=nb, n=symb.n, nlevels=int(fplan.nlevels),
        maps=fplan.maps, srcvec_local=srcvec_local, blk_n_local=blk_n_local,
        a_tasks=a_tasks, c_tasks=c_tasks, s_tasks=s_tasks,
        nlevels_solve=nlevels_solve, asm=asm[:-1], top_asm=asm[-1])


def reconstruct_global_pool(md: MultiDeviceFactor, pools) -> np.ndarray:
    """Gather the factored local pools (tensors or arrays, [nlocal_d, nb,
    nb] or flat) back into the global block pool [nblocks, nb, nb] (the top
    from the first device)."""
    part = md.part
    nb = md.nb
    local = [(p.detach().cpu().numpy() if isinstance(p, torch.Tensor)
              else np.asarray(p)).reshape(-1, nb, nb) for p in pools]
    out = np.empty((len(part.blk_dev), nb, nb), dtype=local[0].dtype)
    for d in range(-1, part.ndev):
        sel = np.flatnonzero(part.blk_dev == d)
        out[sel] = local[max(d, 0)][part.blk_local[sel]]
    return out


class ForestExecutor:
    """The executors of one :class:`MultiDeviceFactor` on ``devices`` (one
    per device of the partition; a device may repeat, and then its shards
    run one after the other on it).

    ``schedule`` 'scan' (or 'unrolled') runs the level executors, 'mega' the
    stream executors; both take float32 and float64 at any nb.  ``smp``,
    the solve stream plan of (symb, plan), is needed for 'mega'.  The
    tables do not depend on the values: one executor serves every
    refactorization of the pattern."""

    def __init__(self, md: MultiDeviceFactor, devices, dtype=torch.float32,
                 matmul_precision: str = "highest", schedule: str = "scan",
                 smp=None):
        if len(devices) != md.part.ndev:
            raise ValueError(f"{len(devices)} devices for a partition over "
                             f"{md.part.ndev}")
        if schedule == "mega":
            from ..numeric.megakernel import MegaFactorExecutor as Executor

            if smp is None:
                raise ValueError("schedule='mega' needs the solve stream "
                                 "plan (smp)")
        else:
            from ..numeric.factor_scan import ScanFactorExecutor as Executor
        self.md = md
        self.devices = [canonical_device(d) for d in devices]
        self.dtype = dtype
        self.precision = matmul_precision
        self.mega = schedule == "mega"
        self.smp = smp
        kw = dict(dtype=dtype, matmul_precision=matmul_precision)
        self.local_ex = [Executor(md.factor_view(d), device=dev, **kw)
                         for d, dev in enumerate(self.devices)]
        self.top_ex = Executor(md.factor_view(-1), device=self.devices[0],
                               **kw)
        self._solvers = None

    # ------------------------------------------------------------------ #
    def executors(self) -> dict:
        """The class names of the executors: per device and for the top, of
        the factorization and (once a solve ran) of the solve."""
        out = {"factor": [type(e).__name__ for e in self.local_ex],
               "factor_top": type(self.top_ex).__name__}
        if self._solvers is not None:
            out["solve"] = [type(e).__name__ for e in self._solvers[0]]
            out["solve_top"] = type(self._solvers[1]).__name__
        return out

    def assemble(self, values):
        """(local pools, assembled top) of ``values`` (permuted)."""
        return self.md.local_pools(values, self.dtype, self.devices)

    def run_local(self, pools) -> list:
        """Phase A, in place; returns each device's not-positive-definite
        flag (0-d tensors)."""
        return [ex(p)[1] for ex, p in zip(self.local_ex, pools)]

    def reduce_top(self, pools, top) -> None:
        """Phase B: the first pool's top region becomes the assembled top
        plus every device's contributions, summed in device order."""
        ntop = self.md.part.ntop
        if ntop == 0:
            return
        dev0 = self.devices[0]
        acc = pools[0][:ntop].clone()
        for p in pools[1:]:
            acc += p[:ntop].to(dev0)
        pools[0][:ntop] = top + acc

    def run_top(self, pools):
        """Phase C: factor the top in the first pool, then copy it into the
        others; returns its not-positive-definite flag."""
        pool0, flag = self.top_ex(pools[0])
        ntop = self.md.part.ntop
        for p in pools[1:]:
            p[:ntop].copy_(pool0[:ntop])
        return flag

    def factor(self, values):
        """Assemble and factor; returns (pools, not_posdef_flag), the flag a
        0-d bool tensor on the first device (the flags of every phase
        OR-ed)."""
        pools, top = self.assemble(values)
        flags = self.run_local(pools)
        self.reduce_top(pools, top)
        flags.append(self.run_top(pools))
        dev0 = self.devices[0]
        return pools, torch.stack([f.to(dev0) for f in flags]).any()

    # ------------------------------------------------------------------ #
    def solvers(self):
        """([per-device solve executors], top solve executor), built at the
        first solve; they serve any number of right-hand sides."""
        if self._solvers is None:
            kw = dict(dtype=self.dtype, matmul_precision=self.precision)
            if self.mega:
                from .forest_mega import device_solve_executors

                self._solvers = device_solve_executors(self.md, self.smp,
                                                       self.devices, **kw)
            else:
                from ..numeric.solve_scan import ScanSolveExecutor

                self._solvers = (
                    [ScanSolveExecutor(self.md.solve_view(d), 0, device=dev,
                                       **kw)
                     for d, dev in enumerate(self.devices)],
                    ScanSolveExecutor(self.md.solve_view(-1), 0,
                                      device=self.devices[0], **kw))
        return self._solvers

    def _sweep(self, ex, pool, w, forward: bool):
        """One sweep of ``ex`` on a copy of ``w`` on its device."""
        if self.mega:
            return ex._sweep(ex._pool(pool), w.to(ex.device, copy=True),
                             forward)
        return (ex.fwd if forward else ex.bwd)(pool, w)

    @staticmethod
    def _merge(w, outs):
        """w + Σ (out − w), summed in device order on w's device."""
        acc = None
        for o in outs:
            delta = o.to(w.device) - w
            acc = delta if acc is None else acc.add_(delta)
        return w + acc

    def solve(self, pools, xp, job: int = 0) -> torch.Tensor:
        """Forward (job 1), backward (job 2) or both (job 0) on the padded
        rhs ``xp`` [n+1, nrhs] (array or tensor, in factor order); returns
        [n+1, nrhs] in the pool dtype on the first device."""
        if job not in (0, 1, 2):
            raise ValueError(f"job must be 0, 1 or 2, got {job}")
        local, top = self.solvers()
        w = top._work(xp) if self.mega else top._rhs(xp)
        if job in (0, 1):
            w = self._merge(w, [self._sweep(ex, p, w, True)
                                for ex, p in zip(local, pools)])
            w = self._sweep(top, pools[0], w, True)
        if job in (0, 2):
            if self.mega:
                w[:self.smp.P] = 0     # the panels start every sweep at zero
            w = self._sweep(top, pools[0], w, False)
            w = self._merge(w, [self._sweep(ex, p, w, False)
                                for ex, p in zip(local, pools)])
        return top._out(w) if self.mega else w
