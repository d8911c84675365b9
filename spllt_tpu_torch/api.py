"""User API: analyse / factor / solve.

Mirrors the reference's three-phase interface (``spllt_analyse`` /
``spllt_factor`` / ``spllt_solve`` with the akeep/fkeep split,
SpLLT:src/spllt_mod.F90, doc/source/subroutines.rst) and the behaviour of
``spllt_tpu.api``: the symbolic object is reusable across repeated
factorizations of the same pattern; the numeric object holds the factor
pool and shares the cached executors.

Jobs (reference job table, include/spllt_iface.h):
  job=0 both, job=1 forward only, job=2 backward only.

Device rule: ``Options.device`` (None means "cuda") names where the pool
and the executors live.  ``factor`` raises ``RuntimeError`` when a CUDA
device is asked for and none is available; it never carries on on the CPU.
With ``Options(ndevices=k)`` (k > 1, mode 'batched') the factor runs on the
forest path (:mod:`.parallel.forest`) over the devices of
:func:`.parallel.device_list`: ``cuda:N … cuda:N+k-1`` for a CUDA device,
``ValueError`` when fewer cards are visible, and k shards on the CPU for
``device='cpu'``; its solve refines on the host.  ``mode='stf'`` ignores
``ndevices``, as the reference does.

``Options(coarse_subtrees=True)`` runs the dense phase
(:mod:`.numeric.subtree`) on the assembled pool before whichever factor
executor follows; ``Options(timers=True)`` / ``Options(trace=True)`` time
and trace ``factor`` and ``solve`` (:func:`_diag`, as ``spllt_tpu.api``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .analyse.analyse import SymbolicFactor, analyse
from .errors import NotPositiveDefiniteError
from .inform import Inform
from .options import Options
from .plan.blocking import BlockPlan, build_block_plan
from .plan.factor_tasks import FactorPlan, build_factor_plan
from .plan.solve_tasks import SolvePlan, build_solve_plan
from .sparse.csc import CscMatrix

__all__ = ["analyse", "factor", "solve", "SymbolicFactor", "NumericFactor",
           "Options"]


@dataclasses.dataclass
class NumericFactor:
    """fkeep analogue: block plan + factor pool + executor cache."""

    symb: SymbolicFactor
    plan: BlockPlan
    fplan: FactorPlan
    splan: SolvePlan
    pool: object                 # np.ndarray (stf) or torch.Tensor (batched)
    values_perm: np.ndarray      # permuted values actually factored
    options: Options
    inform: Inform
    _solve_execs: dict = dataclasses.field(default_factory=dict)
    # the forest path (Options.ndevices > 1): its ForestExecutor; ``pool``
    # then holds the list of the devices' local pools
    mdf: object | None = None

    @property
    def mode(self) -> str:
        return self.options.mode

    @property
    def trace_log(self):
        """TraceLog accumulated under Options(trace=True), else None."""
        return getattr(self.options, "_trace_log", None)


def _torch_dtype(options: Options) -> torch.dtype:
    return torch.float64 if options.dtype == "float64" else torch.float32


def _resolve_device(options: Options) -> torch.device:
    dev = torch.device(options.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Options(device={options.device!r}) asks for CUDA device "
            f"'{dev}' but torch.cuda.is_available() is false; pass "
            "device='cpu' to run on the CPU")
    from .numeric.factor_scan import canonical_device

    return canonical_device(dev)


def _forest_run(options: Options) -> bool:
    return options.mode == "batched" and options.ndevices > 1


def _resolve_devices(options: Options) -> list:
    """The devices of a batched factor: [the one device], or those of the
    forest path (see the module docstring)."""
    if not _forest_run(options):
        return [_resolve_device(options)]
    from .parallel import device_list

    return device_list(options.torch_device, options.ndevices)


def _coarse_key(options: Options):
    """What the factor plan's coarse layer depends on (None when off).  The
    forest path partitions the flat task stream, so its plans are built
    without the coarse layer, as the reference's are."""
    if not options.coarse_subtrees or options.ndevices > 1:
        return None
    return (options.coarse_span, options.coarse_waste)


def _plans(symb: SymbolicFactor, options: Options):
    """Plans for (symb, blocking options) — cached on the symbolic object
    so repeated refactorizations (the reference's akeep-reuse pipeline,
    doc/source/subroutines.rst:37-75) pay the plan build once."""
    coarse_key = _coarse_key(options)
    key = ("plans", options.nb, coarse_key)
    cache = getattr(symb, "_cache", None)
    if cache is None:
        cache = symb._cache = {}
    if key in cache:
        return cache[key]
    plan = build_block_plan(symb, options.nb)
    coarse = None
    if coarse_key is not None:
        from .analyse.coarsen import coarse_partition

        coarse = coarse_partition(symb.forest, symb.node_flops,
                                  max_span=options.coarse_span,
                                  waste=options.coarse_waste)
    fplan = build_factor_plan(symb, plan, coarse=coarse)
    splan = build_solve_plan(symb, plan)
    cache[key] = (plan, fplan, splan)
    return cache[key]


def _solve_mega_plan(symb: SymbolicFactor, plan: BlockPlan):
    """The solve stream plan of (symb, blocking) — cached beside the other
    plans, so a refactorization or another nrhs rebuilds nothing."""
    from .plan.solve_mega import build_solve_mega_plan

    key = ("smplan", plan.nb)
    if key not in symb._cache:
        symb._cache[key] = build_solve_mega_plan(symb, plan)
    return symb._cache[key]


def _exec_key(kind: str, options: Options, dev: torch.device):
    # 'scan' and 'unrolled' share the level executors; 'mega' has its own.
    # The factor plan, and so the factor executor, depends on the coarse
    # layer; the solve plan does not.
    family = "mega" if options.schedule == "mega" else "level"
    key = (kind, family, options.nb, options.dtype, options.precision,
           str(dev))
    return key if kind == "sex" else key + (_coarse_key(options),)


def _dense_key(options: Options, dev: torch.device):
    """Cache key of the dense phase's executor (coarse_subtrees=True): it
    serves both schedules, so the schedule is not part of it."""
    return ("dense", options.nb, str(dev), _coarse_key(options))


def _diag(options: Options, name: str, flops: float = 0.0):
    """Phase context for Options.timers/trace (ref timer_mod/trace_mod):
    timers feed the global registry (utils.timers.print_timers /
    timer_csv); trace events accumulate on the options' TraceLog (dump via
    num.trace_log.dump/dump_paje).  Both read the host clock, which the
    phases keep honest: each ends in a host synchronisation."""
    import contextlib

    if not (options.timers or options.trace):
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if options.timers:
        from .utils.timers import timer

        stack.enter_context(timer(name, flops=flops))
    if options.trace:
        tl = getattr(options, "_trace_log", None)
        if tl is None:
            from .utils.tracing import TraceLog

            tl = TraceLog()
            object.__setattr__(options, "_trace_log", tl)
        stack.enter_context(tl.event(name))
    return stack


def trace_log(obj):
    """The TraceLog accumulated under Options(trace=True) for this
    Options/NumericFactor (None if tracing is off)."""
    opts = obj.options if hasattr(obj, "options") else obj
    return getattr(opts, "_trace_log", None)


def _factor_executor(fplan: FactorPlan, options: Options, dtype, dev):
    """The stream executor for schedule='mega', else the level executor.
    Both pool dtypes and every nb are eligible for either, so the schedule
    alone decides, here, once; nothing falls back from one to the other."""
    if options.schedule == "mega":
        from .numeric.megakernel import MegaFactorExecutor as Executor
    else:
        from .numeric.factor_scan import ScanFactorExecutor as Executor
    return Executor(fplan, dtype=dtype, matmul_precision=options.precision,
                    device=dev)


def factor(symb: SymbolicFactor, a: CscMatrix | None = None,
           options: Options | None = None, devices=None) -> NumericFactor:
    """Numeric factorization.  ``a`` defaults to the matrix captured at
    analyse time; passing a new matrix with the same pattern refactorizes
    (the akeep-reuse workflow of the reference).  ``devices``, for the
    forest path only, replaces the device rule by an explicit list of
    ``options.ndevices`` torch devices (a device may repeat: its shards then
    run one after the other there)."""
    options = options or symb.options
    if devices is not None and (not _forest_run(options)
                                or len(devices) != options.ndevices):
        raise ValueError(f"devices takes a list of ndevices="
                         f"{options.ndevices} devices, and only on the "
                         "forest path (mode 'batched', ndevices > 1)")
    with _diag(options, "factor", flops=float(symb.inform.num_flops)):
        return _factor_impl(symb, a, options, devices)


def _factor_impl(symb: SymbolicFactor, a: CscMatrix | None,
                 options: Options, devices=None) -> NumericFactor:
    values = (symb.a_perm.values if a is None
              else _permuted_values(symb, a))
    plan, fplan, splan = _plans(symb, options)

    inform = dataclasses.replace(symb.inform)
    inform.num_blocks = plan.nblocks
    inform.num_levels = fplan.nlevels
    inform.num_tasks = fplan.num_tasks

    if _forest_run(options):
        return _factor_forest(symb, values, options, plan, fplan, splan,
                              inform, devices or _resolve_devices(options))
    if options.mode == "stf":
        from .numeric.assemble import assemble_np
        from .numeric.stf import factorize_np

        pool = assemble_np(plan, values, dtype=np.float64)
        if fplan.dense:
            from .numeric.subtree import subtree_np

            pool = subtree_np(pool, np.asarray(values, np.float64), fplan)
        pool = factorize_np(pool, fplan)
        solve_execs = {}
    else:
        from .numeric.assemble import assemble_torch

        dev = _resolve_device(options)
        dtype = _torch_dtype(options)
        # executors are values-independent: cache per (symb, options) so
        # the refactorization pipeline skips the table rebuilds
        ekey = _exec_key("fex", options, dev)
        ex = symb._cache.get(ekey)
        if ex is None:
            ex = symb._cache[ekey] = _factor_executor(fplan, options, dtype,
                                                      dev)
        pool = assemble_torch(plan, values, dtype, dev)
        dense_bad = None
        if fplan.dense:
            dkey = _dense_key(options, dev)
            dx = symb._cache.get(dkey)
            if dx is None:
                from .numeric.subtree import DenseSubtreeExecutor

                dx = symb._cache[dkey] = DenseSubtreeExecutor(fplan, dev)
            pool, dense_bad = dx(pool)
        pool, notpos = ex(pool)
        if dense_bad is not None:
            notpos = notpos | dense_bad
        # positive-definiteness flag computed on the device (one scalar
        # crosses; this is also the synchronisation point of the factor)
        if bool(notpos):
            raise NotPositiveDefiniteError()
        solve_execs = symb._cache.setdefault(_exec_key("sex", options, dev),
                                             {})
    return NumericFactor(symb=symb, plan=plan, fplan=fplan, splan=splan,
                         pool=pool, values_perm=np.asarray(values),
                         options=options, inform=inform,
                         _solve_execs=solve_execs)


def _forest_executor(symb: SymbolicFactor, options: Options, plan, fplan,
                     splan, devices):
    """The cached ForestExecutor of (symb, options) on ``devices``; the
    forest plan is cached beside it, keyed by the device count only."""
    from .parallel.forest import ForestExecutor, build_multidevice_factor

    family = "mega" if options.schedule == "mega" else "level"
    key = ("forest", family, options.nb, options.ndevices, options.dtype,
           options.precision, tuple(str(d) for d in devices))
    fx = symb._cache.get(key)
    if fx is None:
        mkey = ("mdf", options.nb, options.ndevices)
        md = symb._cache.get(mkey)
        if md is None:
            md = symb._cache[mkey] = build_multidevice_factor(
                symb, plan, fplan, options.ndevices, splan=splan)
        smp = _solve_mega_plan(symb, plan) if family == "mega" else None
        fx = symb._cache[key] = ForestExecutor(
            md, devices, dtype=_torch_dtype(options),
            matmul_precision=options.precision, schedule=options.schedule,
            smp=smp)
    return fx


def _factor_forest(symb: SymbolicFactor, values, options: Options, plan,
                   fplan, splan, inform, devices) -> NumericFactor:
    fx = _forest_executor(symb, options, plan, fplan, splan, devices)
    pools, notpos = fx.factor(values)
    if bool(notpos):
        raise NotPositiveDefiniteError()
    return NumericFactor(symb=symb, plan=plan, fplan=fplan, splan=splan,
                         pool=pools, values_perm=np.asarray(values),
                         options=options, inform=inform, mdf=fx)


def _permuted_values(symb: SymbolicFactor, a: CscMatrix) -> np.ndarray:
    """Re-permute values of a new matrix with the analysed pattern."""
    ap = a.permute(symb.perm)
    if (not np.array_equal(ap.colptr, symb.a_perm.colptr)
            or not np.array_equal(ap.rowind, symb.a_perm.rowind)):
        raise ValueError("matrix pattern differs from analysed pattern")
    return ap.values


def solve(num: NumericFactor, b: np.ndarray, job: int = 0,
          refine: int | None = None) -> np.ndarray:
    """Solve A x = b (job=0), L y = Pb (job=1) or Lᵀ(Px) = y (job=2).

    ``b`` is [n] or [n, nrhs] in user ordering; the result is a float64
    NumPy array of the same shape.  For job=0 with ``refine`` > 0 steps
    (default from options), runs f64 iterative refinement — restoring
    double-precision backward error from the f32 factor.  In batched mode
    with ``refine_device`` (the default) the whole refined solve runs on the
    device the pool lies on; otherwise, in stf mode and on the forest path
    (``ndevices`` > 1), the residuals are computed on the host.
    """
    with _diag(num.options, f"solve(job={job})"):
        return _solve_impl(num, b, job, refine)


def _solve_impl(num: NumericFactor, b, job: int,
                refine: int | None) -> np.ndarray:
    b = np.asarray(b)
    symb = num.symb
    n = symb.n
    one_d = b.ndim == 1
    bb = b.reshape(n, -1).astype(np.float64)
    refine = num.options.refine if refine is None else refine
    if job != 0:
        refine = 0

    if job == 0 and refine > 0 and num.options.mode == "batched" \
            and num.options.refine_device and num.mdf is None:
        x = _solve_refined_device(num, bb, refine)
        return x[:, 0] if one_d else x

    x = _solve_once(num, bb, job)
    if job == 0 and refine > 0:
        for _ in range(refine):
            r = bb - _user_matvec(num, x)
            dx = _solve_once(num, r, 0)
            x = x + dx
    return x[:, 0] if one_d else x


def _padded_perm(num: NumericFactor, bb: np.ndarray) -> np.ndarray:
    """Permute into factor ordering and append the zero dump row."""
    xp = np.zeros((num.symb.n + 1, bb.shape[1]), dtype=np.float64)
    xp[:num.symb.n] = bb[num.symb.perm]
    return xp


def _unpermute(num: NumericFactor, xp: np.ndarray) -> np.ndarray:
    out = np.empty((num.symb.n, xp.shape[1]), dtype=np.float64)
    out[num.symb.perm] = xp[:num.symb.n]
    return out


def _solve_refined_device(num: NumericFactor, bb: np.ndarray,
                          refine: int) -> np.ndarray:
    """Refined solve on the pool's device (solves in the pool dtype + f64
    ELL-SpMV residuals; see numeric/spmv.py)."""
    from .numeric.spmv import build_ell, ell_vals

    symb = num.symb
    dev = num.pool.device
    ell = getattr(symb, "_ell", None)
    if ell is None:
        ell = symb._ell = build_ell(symb.a_perm)
    # cached on the NumericFactor (NOT the shared executor cache: the
    # ELL values change with every refactorization)
    ell_dev = getattr(num, "_ell_dev", None)
    if ell_dev is None:
        ell_dev = num._ell_dev = (
            torch.as_tensor(ell_vals(ell, num.values_perm), device=dev),
            torch.as_tensor(ell.idx.astype(np.int64), device=dev))
    vals64, idx = ell_dev
    ex = _solve_executor(num, bb.shape[1])
    x64 = ex.full_refined(num.pool, _padded_perm(num, bb), vals64, idx,
                          refine)
    return _unpermute(num, x64.cpu().numpy())


def _solve_executor(num: NumericFactor, nrhs: int):
    """Solve executor for ``nrhs`` (cached beside the factor executor,
    shared by every factorization of the pattern): the stream executor for
    schedule='mega', else the level executor."""
    key = (nrhs,)
    ex = num._solve_execs.get(key)
    if ex is not None:
        return ex
    kw = dict(dtype=num.pool.dtype, matmul_precision=num.options.precision,
              device=num.pool.device)
    if num.options.schedule == "mega":
        from .numeric.solve_mega import MegaSolveExecutor

        ex = MegaSolveExecutor(num.symb, num.plan, nrhs,
                               smp=_solve_mega_plan(num.symb, num.plan), **kw)
    else:
        from .numeric.solve_scan import ScanSolveExecutor

        ex = ScanSolveExecutor(num.splan, nrhs, **kw)
    num._solve_execs[key] = ex
    return ex


def _user_matvec(num: NumericFactor, x: np.ndarray) -> np.ndarray:
    """A·x in user ordering with the factored values (float64), as a
    scipy sparse product."""
    symb = num.symb
    ap = CscMatrix(symb.n, symb.a_perm.colptr, symb.a_perm.rowind,
                   num.values_perm)
    y = np.empty(np.shape(x))
    y[symb.perm] = ap.to_scipy() @ x[symb.perm]
    return y


def _solve_once(num: NumericFactor, bb: np.ndarray, job: int) -> np.ndarray:
    if job not in (0, 1, 2):
        raise ValueError(f"job must be 0, 1 or 2, got {job}")
    xp = _padded_perm(num, bb)
    if num.mdf is not None:
        xp = num.mdf.solve(num.pool, xp, job).cpu().numpy().astype(
            np.float64)
    elif num.options.mode == "stf":
        from .numeric.solve import solve_bwd_np, solve_fwd_np

        if job in (0, 1):
            xp = solve_fwd_np(num.pool, num.splan, xp)
        if job in (0, 2):
            xp = solve_bwd_np(num.pool, num.splan, xp)
    else:
        ex = _solve_executor(num, bb.shape[1])
        run = (ex.full, ex.fwd, ex.bwd)[job]
        xp = run(num.pool, xp).cpu().numpy().astype(np.float64)
    return _unpermute(num, xp)
