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

    @property
    def mode(self) -> str:
        return self.options.mode


def _torch_dtype(options: Options) -> torch.dtype:
    return torch.float64 if options.dtype == "float64" else torch.float32


def _check_ported(options: Options) -> None:
    """The parts of the option space that are not ported yet raise; they do
    not fall back to the level executors silently."""
    if options.ndevices > 1:
        raise NotImplementedError(
            "not ported yet: Options(ndevices > 1) (multi-device forest)")
    if options.coarse_subtrees:
        raise NotImplementedError(
            "not ported yet: Options(coarse_subtrees=True) (dense leaf "
            "subtrees)")
    defaults = Options()
    for name in ("coarse_span", "coarse_waste"):
        if getattr(options, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"not ported yet: Options({name}=...) (dense leaf "
                "subtrees)")
    for name in ("trace", "timers"):
        if getattr(options, name):
            raise NotImplementedError(
                f"not ported yet: Options({name}=True) (diagnostics)")


def _resolve_device(options: Options) -> torch.device:
    dev = torch.device(options.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Options(device={options.device!r}) asks for CUDA device "
            f"'{dev}' but torch.cuda.is_available() is false; pass "
            "device='cpu' to run on the CPU")
    from .numeric.factor_scan import canonical_device

    return canonical_device(dev)


def _plans(symb: SymbolicFactor, options: Options):
    """Plans for (symb, blocking options) — cached on the symbolic object
    so repeated refactorizations (the reference's akeep-reuse pipeline,
    doc/source/subroutines.rst:37-75) pay the plan build once."""
    key = ("plans", options.nb)
    cache = getattr(symb, "_cache", None)
    if cache is None:
        cache = symb._cache = {}
    if key in cache:
        return cache[key]
    plan = build_block_plan(symb, options.nb)
    fplan = build_factor_plan(symb, plan)
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
    # 'scan' and 'unrolled' share the level executors; 'mega' has its own
    family = "mega" if options.schedule == "mega" else "level"
    return (kind, family, options.nb, options.dtype, options.precision,
            str(dev))


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
           options: Options | None = None) -> NumericFactor:
    """Numeric factorization.  ``a`` defaults to the matrix captured at
    analyse time; passing a new matrix with the same pattern refactorizes
    (the akeep-reuse workflow of the reference)."""
    options = options or symb.options
    _check_ported(options)
    values = (symb.a_perm.values if a is None
              else _permuted_values(symb, a))
    plan, fplan, splan = _plans(symb, options)

    inform = dataclasses.replace(symb.inform)
    inform.num_blocks = plan.nblocks
    inform.num_levels = fplan.nlevels
    inform.num_tasks = fplan.num_tasks

    if options.mode == "stf":
        from .numeric.assemble import assemble_np
        from .numeric.stf import factorize_np

        pool = assemble_np(plan, values, dtype=np.float64)
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
        pool, notpos = ex(pool)
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
    device the pool lies on; otherwise, and in stf mode, the residuals are
    computed on the host.
    """
    b = np.asarray(b)
    symb = num.symb
    n = symb.n
    one_d = b.ndim == 1
    bb = b.reshape(n, -1).astype(np.float64)
    refine = num.options.refine if refine is None else refine
    if job != 0:
        refine = 0

    if job == 0 and refine > 0 and num.options.mode == "batched" \
            and num.options.refine_device:
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
    """A·x in user ordering with the factored values (float64)."""
    symb = num.symb
    ap = CscMatrix(symb.n, symb.a_perm.colptr, symb.a_perm.rowind,
                   num.values_perm)
    xp = x[symb.perm]
    yp = ap.matvec(xp)
    y = np.empty_like(yp)
    y[symb.perm] = yp
    return y


def _solve_once(num: NumericFactor, bb: np.ndarray, job: int) -> np.ndarray:
    if job not in (0, 1, 2):
        raise ValueError(f"job must be 0, 1 or 2, got {job}")
    xp = _padded_perm(num, bb)
    if num.options.mode == "stf":
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
