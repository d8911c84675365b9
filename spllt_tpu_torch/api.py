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

import contextlib
import dataclasses

import numpy as np
import torch

from .analyse.analyse import SymbolicFactor, analyse
from .cache import (DeviceState, executor_classes, forest_run,
                    resolve_device, resolve_devices)
from .errors import NotPositiveDefiniteError
from .inform import Inform
from .numeric.solve_executor import refined
from .options import Options
from .plan.blocking import BlockPlan
from .plan.factor_tasks import FactorPlan
from .plan.solve_tasks import SolvePlan
from .sparse.csc import CscMatrix

__all__ = ["analyse", "factor", "solve", "SymbolicFactor", "NumericFactor",
           "Options"]


@dataclasses.dataclass
class NumericFactor:
    """fkeep analogue: the plans, the factor pool and what depends on its
    values.  Made by :func:`numeric_factor` only."""

    symb: SymbolicFactor
    plan: BlockPlan
    fplan: FactorPlan
    splan: SolvePlan
    pool: object                 # np.ndarray (stf) or torch.Tensor (batched)
    # the values factored, in the analysed order (:attr:`values_perm`);
    # None where only ``_ell_values`` holds them
    _values_perm: np.ndarray | None
    options: Options
    inform: Inform
    # the forest path (Options.ndevices > 1): its ForestExecutor; ``pool``
    # then holds the list of the devices' local pools
    mdf: object | None = None
    # the pattern's state on the pool's device (symb.cache), shared by every
    # factor of the pattern there; None for an stf pool and the forest
    state: DeviceState | None = None
    # values_perm on the pool's device, float64 [nnz(A) + 1]
    # (numeric/spmv.device_values): the assembly's, kept by factor; for a
    # factor made from host arrays, uploaded by its first refined solve
    _ell_values: object | None = None
    # parallel/rhs.solve_rhs_sharded's copies of the pool: device -> pool
    rhs_pools: dict = dataclasses.field(default_factory=dict)
    # A in the analysed order as a scipy matrix, built by the first solve
    # that refines on the host
    _host_matrix: object | None = None

    @property
    def mode(self) -> str:
        return self.options.mode

    @property
    def values_perm(self) -> np.ndarray:
        """The permuted values actually factored.  Where ``factor`` put
        them in order on the device, copied from there (float64) the first
        time it is read."""
        if self._values_perm is None:
            self._values_perm = self._ell_values[:-1].to(
                "cpu", copy=True).numpy()
        return self._values_perm

    @property
    def trace_log(self):
        """TraceLog accumulated under Options(trace=True), else None."""
        return getattr(self.options, "_trace_log", None)

    def padded(self, bb: np.ndarray) -> np.ndarray:
        """``bb`` [n, nrhs] permuted into factor order, with the zero dump
        row appended: [n+1, nrhs] float64."""
        xp = np.zeros((self.symb.n + 1, bb.shape[1]), dtype=np.float64)
        xp[:self.symb.n] = bb[self.symb.perm]
        return xp

    def unpadded(self, xp: np.ndarray) -> np.ndarray:
        """The inverse of :meth:`padded`."""
        out = np.empty((self.symb.n, xp.shape[1]), dtype=np.float64)
        out[self.symb.perm] = xp[:self.symb.n]
        return out

    def residual(self, bb: np.ndarray, x: np.ndarray) -> np.ndarray:
        """b − A x in user ordering with the factored values, in float64
        on the host."""
        a, perm = self.symb.a_perm, self.symb.perm
        if self._host_matrix is None:
            self._host_matrix = CscMatrix(a.n, a.colptr, a.rowind,
                                          self.values_perm).to_scipy()
        ax = np.empty(np.shape(x))
        ax[perm] = self._host_matrix @ x[perm]
        return bb - ax


def numeric_factor(symb: SymbolicFactor, options: Options, pool,
                   values_perm: np.ndarray | None, mdf=None,
                   ell_values=None) -> NumericFactor:
    """The one constructor of :class:`NumericFactor`: the plans of (symb,
    options), ``inform`` with their counts, and the pattern's state on the
    pool's device.  ``values_perm`` may be None where ``ell_values``, the
    factor's device values, holds them."""
    plan, fplan, splan = symb.cache.block_plans(symb, options)
    inform = dataclasses.replace(symb.inform, num_blocks=plan.nblocks,
                                 num_levels=fplan.nlevels,
                                 num_tasks=fplan.num_tasks)
    state = (symb.cache.device(pool.device)
             if isinstance(pool, torch.Tensor) else None)
    if values_perm is not None:
        values_perm = np.asarray(values_perm)
    return NumericFactor(symb=symb, plan=plan, fplan=fplan, splan=splan,
                         pool=pool, _values_perm=values_perm,
                         options=options, inform=inform, mdf=mdf, state=state,
                         _ell_values=ell_values)


def _diag(options: Options, name: str, flops: float = 0.0, sync=None):
    """Phase context for Options.timers/trace (ref timer_mod/trace_mod):
    timers feed the global registry (utils.timers.print_timers /
    timer_csv); trace events accumulate on the options' TraceLog (dump via
    num.trace_log.dump/dump_paje).  Both read the host clock, which the
    phases keep honest: each ends in a host synchronisation, or, like
    ``factor.values``, runs on the host alone; ``sync``, a CUDA device,
    makes the phase end in one (only while timers or tracing are on).  The
    context's value is the dict of the trace event's arguments, which the
    phase may fill in (a dict nobody reads when tracing is off)."""
    if not (options.timers or options.trace):
        return contextlib.nullcontext({})
    return _diag_on(options, name, flops, sync)


@contextlib.contextmanager
def _diag_on(options: Options, name: str, flops: float, sync):
    with contextlib.ExitStack() as stack:
        args = {}
        if options.timers:
            from .utils.timers import timer

            stack.enter_context(timer(name, flops=flops))
        if options.trace:
            tl = getattr(options, "_trace_log", None)
            if tl is None:
                from .utils.tracing import TraceLog

                tl = TraceLog()
                object.__setattr__(options, "_trace_log", tl)
            args = stack.enter_context(tl.event(name))
        yield args
        if sync is not None and torch.device(sync).type == "cuda":
            torch.cuda.synchronize(sync)


def trace_log(obj):
    """The TraceLog accumulated under Options(trace=True) for this
    Options/NumericFactor (None if tracing is off)."""
    opts = obj.options if hasattr(obj, "options") else obj
    return getattr(opts, "_trace_log", None)


def factor(symb: SymbolicFactor, a: CscMatrix | None = None,
           options: Options | None = None, devices=None) -> NumericFactor:
    """Numeric factorization.  ``a`` defaults to the matrix captured at
    analyse time; passing a new matrix with the same pattern refactorizes
    (the akeep-reuse workflow of the reference).  The first such matrix
    builds the pattern's value map (:class:`ValueMap`, in ``symb.cache``);
    every later matrix whose ``colptr`` and ``rowind`` equal that one's by
    value takes its values through the map in one gather, on the pool's
    device on the single-device batched path (its values cross once, in
    the user's order).  Any other pattern takes the full symmetric
    permutation and its check, which raises ``ValueError`` unless the
    permuted pattern is the analysed one.  Either way the values factored
    are the same, bit for bit.
    ``devices``, for the forest path only, replaces the device rule by an
    explicit list of ``options.ndevices`` torch devices (a device may
    repeat: its shards then run one after the other there)."""
    options = options or symb.options
    if devices is not None and (not forest_run(options)
                                or len(devices) != options.ndevices):
        raise ValueError(f"devices takes a list of ndevices="
                         f"{options.ndevices} devices, and only on the "
                         "forest path (mode 'batched', ndevices > 1)")
    with _diag(options, "factor", flops=float(symb.inform.num_flops)):
        return _factor_impl(symb, a, options, devices)


def _factor_impl(symb: SymbolicFactor, a: CscMatrix | None,
                 options: Options, devices=None) -> NumericFactor:
    on_device = options.mode == "batched" and not forest_run(options)
    values = (symb.a_perm.values if a is None
              else _permuted_values(symb, a, options, on_device))
    cache = symb.cache
    plan, fplan, _ = cache.block_plans(symb, options)
    if forest_run(options):
        fx = cache.forest_executor(symb, options,
                                   devices or resolve_devices(options))
        pool, notpos = fx.factor(values)
        if bool(notpos):
            raise NotPositiveDefiniteError()
        return numeric_factor(symb, options, pool, values, mdf=fx)
    if options.mode == "stf":
        from .numeric.assemble import assemble_np
        from .numeric.stf import factorize_np

        pool = assemble_np(plan, values, dtype=np.float64)
        if fplan.dense:
            from .numeric.subtree import subtree_np

            pool = subtree_np(pool, np.asarray(values, np.float64), fplan)
        return numeric_factor(symb, options, factorize_np(pool, fplan),
                              values)
    from .numeric.assemble import assemble_upload_bytes

    dev = resolve_device(options)
    ex = cache.factor_executor(symb, options, dev)
    amap = cache.assembly_map(symb, options, dev)
    with _diag(options, "factor.assemble", sync=dev) as args:
        # the factor's values on the device, kept for its residuals
        ell_values = (amap.gather(a.values) if values is None
                      else amap.values(values))
        pool = amap.scatter(ell_values, ex.dtype)
        args.update(nnz=amap.nnz, path="gather" if values is None else "host",
                    h2d_bytes=assemble_upload_bytes(plan))
    dense_bad = None
    if fplan.dense:
        pool, dense_bad = cache.dense_executor(symb, options, dev)(pool)
    pool, notpos = ex(pool)
    if dense_bad is not None:
        notpos = notpos | dense_bad
    # positive-definiteness flag computed on the device (one scalar
    # crosses; this is also the synchronisation point of the factor)
    if bool(notpos):
        raise NotPositiveDefiniteError()
    return numeric_factor(symb, options, pool, values, ell_values=ell_values)


@dataclasses.dataclass
class ValueMap:
    """Where the analysed order finds each value of a refactorized matrix:
    for a matrix with these ``colptr`` and ``rowind``, ``values[pos]`` is
    ``a.permute(symb.perm).values``, entry for entry.  Built by the first
    ``factor(symb, a)`` with a matrix and kept in ``symb.cache``;
    ``hits`` counts the later factorizations that gathered through it,
    ``fallbacks`` those whose pattern arrays differed from it."""

    n: int
    colptr: np.ndarray           # copies of the user's pattern arrays
    rowind: np.ndarray
    pos: np.ndarray              # int64[nnz(A)]
    hits: int = 0
    fallbacks: int = 0

    def matches(self, a: CscMatrix) -> bool:
        """Whether ``a``'s pattern arrays equal the map's, by value (arrays
        edited in place since the map was built do not match)."""
        return (a.n == self.n and np.array_equal(a.colptr, self.colptr)
                and np.array_equal(a.rowind, self.rowind))

    def gather(self, a: CscMatrix) -> np.ndarray:
        return np.take(np.asarray(a.values), self.pos).astype(np.float64,
                                                              copy=False)


def _permuted_values(symb: SymbolicFactor, a: CscMatrix, options: Options,
                     on_device: bool = False) -> np.ndarray | None:
    """Values of a new matrix with the analysed pattern, in the analysed
    order: one gather through the cached ValueMap when ``a``'s pattern
    arrays equal those it was built from, else the full permutation and
    its pattern check.  Both give the same values, bit for bit.  With
    ``on_device`` the gather is left to the caller, on the device
    (``numeric.assemble.AssemblyMap.gather``): None is returned."""
    vm = symb.cache.value_map
    with _diag(options, "factor.values") as args:
        args["nnz"] = len(a.rowind)
        if vm is not None and vm.matches(a):
            vm.hits += 1
            args["path"] = "gather"
            return None if on_device else vm.gather(a)
        args["path"] = "permute"
        if vm is not None:
            vm.fallbacks += 1
            return _permute_checked(symb, a).values
        # first matrix: permute the entries' positions instead of their
        # values (exact below 2**53 entries) and keep the result
        ap = _permute_checked(symb, dataclasses.replace(
            a, values=np.arange(len(a.rowind), dtype=np.float64)))
        vm = symb.cache.value_map = ValueMap(
            n=a.n, colptr=np.array(a.colptr), rowind=np.array(a.rowind),
            pos=ap.values.astype(np.int64))
        return vm.gather(a)


def _permute_checked(symb: SymbolicFactor, a: CscMatrix) -> CscMatrix:
    """``a`` symmetrically permuted into the analysed order; ValueError
    unless its pattern is then the analysed one."""
    ap = a.permute(symb.perm)
    if (not np.array_equal(ap.colptr, symb.a_perm.colptr)
            or not np.array_equal(ap.rowind, symb.a_perm.rowind)):
        raise ValueError("matrix pattern differs from analysed pattern")
    return ap


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
    one_d = b.ndim == 1
    bb = b.reshape(num.symb.n, -1).astype(np.float64)
    refine = num.options.refine if refine is None else refine
    if job != 0:
        refine = 0
    if refine > 0 and num.options.refine_device and num.state is not None:
        x = _solve_refined_device(num, bb, refine)
    else:
        x = refined(lambda r: _solve_once(num, r, job),
                    lambda x: num.residual(bb, x), bb, refine)
    return x[:, 0] if one_d else x


def _solve_executor(num: NumericFactor):
    """The solve executor of ``num``'s schedule on its pool's device."""
    return num.symb.cache.solve_executor(
        num, executor_classes(num.options.schedule)[1], num.pool.device)


def _solve_refined_device(num: NumericFactor, bb: np.ndarray,
                          refine: int) -> np.ndarray:
    """Refined solve on the pool's device: solves in the pool dtype,
    float64 ELL-SpMV residuals (numeric/spmv.py) and sum.  The ELL pattern
    is uploaded once per pattern and device; the factor's values are on the
    device from its assembly (uploaded here, once, for a factor made from
    host arrays); each residual gathers the ELL values from them on the
    device."""
    symb = num.symb
    with _diag(num.options, "solve.ell", sync=num.pool.device) as args:
        uploaded = num.state.ell is None
        dell = symb.cache.device_ell(symb, num.state)
        h2d = dell.nbytes if uploaded else 0
        rebuilt = num._ell_values is None
        if rebuilt:
            num._ell_values = dell.values(num.values_perm)
            h2d += num._ell_values.nbytes
        args.update(kmax=dell.kmax, rebuilt=rebuilt, h2d_bytes=h2d)
    ex = _solve_executor(num)
    matvec = dell.matvec(num._ell_values)
    n = symb.n
    b64 = torch.as_tensor(num.padded(bb), device=ex.device)

    def residual(x):
        r = torch.zeros_like(b64)                # dump row stays zero
        r[:n] = b64[:n] - matvec(x)
        return r

    x = refined(lambda r: ex.full(num.pool, r).to(torch.float64), residual,
                b64, refine)
    return num.unpadded(x.cpu().numpy())


def _solve_once(num: NumericFactor, bb: np.ndarray, job: int) -> np.ndarray:
    if job not in (0, 1, 2):
        raise ValueError(f"job must be 0, 1 or 2, got {job}")
    xp = num.padded(bb)
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
        ex = _solve_executor(num)
        run = (ex.full, ex.fwd, ex.bwd)[job]
        xp = run(num.pool, xp).cpu().numpy().astype(np.float64)
    return num.unpadded(xp)
