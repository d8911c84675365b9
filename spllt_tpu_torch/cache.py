"""One home for what the port keeps per analysed pattern.

A ``SymbolicFactor`` holds one :class:`PatternCache` (``symb.cache``): the
host plans, the ``api.ValueMap`` and one :class:`DeviceState` per device.
None of it depends on the values, so every factor of the pattern shares it;
what does (the pool, the ELL values, the rhs-sharded pool copies) lives on
the ``NumericFactor`` and dies with it.  Each member is built by one method
here, at its first use, and only this module forms the keys.
:func:`executor_classes` is the one place where ``Options.schedule`` is
decided.
"""

from __future__ import annotations

import dataclasses

import torch

from .numeric.factor_scan import canonical_device
from .plan.blocking import build_block_plan
from .plan.factor_tasks import build_factor_plan
from .plan.solve_mega import build_solve_mega_plan
from .plan.solve_tasks import build_solve_plan

__all__ = ["PatternCache", "DeviceState", "executor_classes", "torch_dtype",
           "resolve_device", "resolve_devices", "forest_run"]


def executor_classes(schedule: str):
    """(factor executor class, solve executor class) of ``schedule``: the
    stream executors (K4, K6) for 'mega', the level executors (K1–K3, K5)
    for 'scan' and its alias 'unrolled'.  Both pairs take float32 and
    float64 at any nb; nothing falls back from one to the other."""
    if schedule == "mega":
        from .numeric.megakernel import MegaFactorExecutor
        from .numeric.solve_mega import MegaSolveExecutor

        return MegaFactorExecutor, MegaSolveExecutor
    from .numeric.factor_scan import ScanFactorExecutor
    from .numeric.solve_scan import ScanSolveExecutor

    return ScanFactorExecutor, ScanSolveExecutor


def torch_dtype(options) -> torch.dtype:
    return torch.float64 if options.dtype == "float64" else torch.float32


def resolve_device(options) -> torch.device:
    """The one device of a batched factor; ``RuntimeError`` when a CUDA
    device is asked for and none is available (never the CPU instead)."""
    dev = torch.device(options.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Options(device={options.device!r}) asks for CUDA device "
            f"'{dev}' but torch.cuda.is_available() is false; pass "
            "device='cpu' to run on the CPU")
    return canonical_device(dev)


def forest_run(options) -> bool:
    return options.mode == "batched" and options.ndevices > 1


def resolve_devices(options) -> list:
    """The devices of a batched factor: [the one device], or those of the
    forest path (:func:`.parallel.device_list`)."""
    if not forest_run(options):
        return [resolve_device(options)]
    from .parallel import device_list

    return device_list(options.torch_device, options.ndevices)


def _coarse_key(options):
    """What the factor plan's coarse layer depends on (None when off).  The
    forest path partitions the flat task stream, so its plans are built
    without the coarse layer, as the reference's are."""
    if not options.coarse_subtrees or options.ndevices > 1:
        return None
    return (options.coarse_span, options.coarse_waste)


def _cached(members: dict, key, build):
    """``members[key]``, made by ``build()`` if it is not there yet."""
    if key not in members:
        members[key] = build()
    return members[key]


@dataclasses.dataclass(eq=False)
class DeviceState:
    """A pattern's state on one device.  Each executor is keyed by what its
    tables depend on: a factor executor by its class ('scan' and 'unrolled'
    share one), nb, dtype, precision and coarse layer; a dense executor by
    nb and coarse layer (both schedules share it); a solve executor by its
    class, nb and pool dtype (one serves every nrhs); a forest executor,
    kept on its first device, by its classes, nb, dtype, precision and
    devices.  ``assembly`` holds a ``numeric.assemble.AssemblyMap`` a nb;
    ``ell`` is the refined solve's ``numeric.spmv.DeviceEll``."""

    device: torch.device
    assembly: dict = dataclasses.field(default_factory=dict)
    factor_executors: dict = dataclasses.field(default_factory=dict)
    dense_executors: dict = dataclasses.field(default_factory=dict)
    solve_executors: dict = dataclasses.field(default_factory=dict)
    forest_executors: dict = dataclasses.field(default_factory=dict)
    ell: object | None = None


class PatternCache:
    """The per-pattern state of one symbolic factor (module docstring)."""

    def __init__(self):
        self.plans = {}   # (nb, coarse) -> (BlockPlan, FactorPlan, SolvePlan)
        self.stream_plans = {}      # nb -> SolveMegaPlan
        self.forest_plans = {}      # (nb, ndevices) -> MultiDeviceFactor
        self.value_map = None       # set by api._permuted_values
        self.devices = {}           # str(device) -> DeviceState

    def block_plans(self, symb, options):
        """(BlockPlan, FactorPlan, SolvePlan) of (symb, options)."""
        key = (options.nb, _coarse_key(options))
        if key not in self.plans:
            plan = build_block_plan(symb, options.nb)
            coarse = None
            if key[1] is not None:
                from .analyse.coarsen import coarse_partition

                coarse = coarse_partition(symb.forest, symb.node_flops,
                                          max_span=options.coarse_span,
                                          waste=options.coarse_waste)
            self.plans[key] = (plan, build_factor_plan(symb, plan,
                                                       coarse=coarse),
                               build_solve_plan(symb, plan))
        return self.plans[key]

    def stream_plan(self, symb, plan):
        """The solve stream plan of (symb, plan)."""
        return _cached(self.stream_plans, plan.nb,
                       lambda: build_solve_mega_plan(symb, plan))

    def forest_plan(self, symb, options):
        """The :class:`.parallel.forest.MultiDeviceFactor` of (symb,
        options) over ``options.ndevices`` devices."""
        from .parallel.forest import build_multidevice_factor

        plan, fplan, splan = self.block_plans(symb, options)
        return _cached(self.forest_plans, (options.nb, options.ndevices),
                       lambda: build_multidevice_factor(
                           symb, plan, fplan, options.ndevices, splan=splan))

    def device(self, dev) -> DeviceState:
        dev = canonical_device(dev)
        return _cached(self.devices, str(dev), lambda: DeviceState(dev))

    def factor_executor(self, symb, options, dev):
        """The factor executor of ``options`` on ``dev``."""
        cls = executor_classes(options.schedule)[0]
        return _cached(
            self.device(dev).factor_executors,
            (cls, options.nb, options.dtype, options.precision,
             _coarse_key(options)),
            lambda: cls(self.block_plans(symb, options)[1],
                        dtype=torch_dtype(options),
                        matmul_precision=options.precision, device=dev))

    def assembly_map(self, symb, options, dev):
        """The ``numeric.assemble.AssemblyMap`` of ``options.nb`` on
        ``dev``, with the value map's positions once there is a value
        map."""
        from .numeric.assemble import AssemblyMap

        plan = self.block_plans(symb, options)[0]
        amap = _cached(self.device(dev).assembly, plan.nb,
                       lambda: AssemblyMap.build(plan, dev))
        if amap.pos is None and self.value_map is not None:
            amap.add_positions(self.value_map.pos)
        return amap

    def dense_executor(self, symb, options, dev):
        """The dense phase's executor (``coarse_subtrees=True``)."""
        from .numeric.subtree import DenseSubtreeExecutor

        fplan = self.block_plans(symb, options)[1]
        return _cached(self.device(dev).dense_executors,
                       (options.nb, _coarse_key(options)),
                       lambda: DenseSubtreeExecutor(fplan, dev))

    def solve_executor(self, num, cls, dev):
        """The solve executor of class ``cls`` for the pattern and pool
        dtype of the factor ``num`` on ``dev``."""
        def build():
            smp = (self.stream_plan(num.symb, num.plan)
                   if cls.uses_stream_plan else None)
            return cls.of_plans(num.symb, num.plan, num.splan, smp,
                                dtype=num.pool.dtype, device=dev)

        return _cached(self.device(dev).solve_executors,
                       (cls, num.plan.nb, num.pool.dtype), build)

    def forest_executor(self, symb, options, devices):
        """The :class:`.parallel.forest.ForestExecutor` of ``options`` on
        ``devices``, and with it the solve stream plan it needs."""
        from .parallel.forest import ForestExecutor

        classes = executor_classes(options.schedule)
        devices = [canonical_device(d) for d in devices]

        def build():
            plan = self.block_plans(symb, options)[0]
            smp = (self.stream_plan(symb, plan)
                   if classes[1].uses_stream_plan else None)
            return ForestExecutor(self.forest_plan(symb, options), devices,
                                  classes, dtype=torch_dtype(options),
                                  matmul_precision=options.precision, smp=smp)

        key = (classes, options.nb, options.dtype, options.precision,
               tuple(map(str, devices)))
        return _cached(self.device(devices[0]).forest_executors, key, build)

    def device_ell(self, symb, state: DeviceState):
        """The pattern's ``numeric.spmv.DeviceEll`` on ``state``'s device."""
        if state.ell is None:
            from .numeric.spmv import DeviceEll, build_ell

            state.ell = DeviceEll.upload(build_ell(symb.a_perm),
                                         len(symb.a_perm.rowind),
                                         state.device)
        return state.ell
