"""User options.

Analogue of ``spllt_options`` (SpLLT:src/spllt_data_mod.F90:260-286) and the
C options struct (SpLLT:include/spllt_iface.h:14-47).  Compile-time CMake
switches of the reference (RUNTIME, ...) become runtime fields here — the
"runtime" choice maps to ``mode``: 'stf' (sequential NumPy oracle, the
reference's STF build) or 'batched' (level-scheduled device program,
replacing OMP/StarPU/PaRSEC).

Every field of ``spllt_tpu.options.Options`` is here, with the same name,
default and validation, so one set of keyword arguments configures either
package; ``device`` is new.  The knobs that steer only the JAX package's
TPU kernels (``pallas_updates``, ``pallas_hmax``, ``solve_group``) are
accepted and have no effect on this card.  ``ndevices`` > 1 runs the
forest path (``parallel/forest.py``) in mode 'batched'.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Options"]


@dataclasses.dataclass
class Options:
    # blocking --------------------------------------------------------------
    # Solve tasks address the SAME nb-tiled pool as the factorization (panel
    # windows are nb rows by construction), so there is no separate solve
    # tile size (the reference's snb).
    nb: int = 256            # factorization tile size (ref default nb=256)
    nemin: int = 32          # supernode amalgamation threshold (ref nemin=32)
    # symbolic --------------------------------------------------------------
    ordering: str = "amd"    # 'amd' | 'nd' | 'nd-grid' | 'rcm' | 'natural'
    grid_shape: tuple | None = None  # for 'nd-grid'
    prune_tree: bool = True  # subtree coarsening (ref prune_tree)
    coarse_subtrees: bool = False  # batched dense leaf-subtree phase
    #   (numeric/subtree.py), before the factor executor
    coarse_span: int = 256   # max dense front size |V|+|B|
    coarse_waste: float = 8.0  # the dense/sparse flop waste bound
    # execution -------------------------------------------------------------
    mode: str = "batched"    # 'batched' (level schedule on ``device``) |
    #   'stf' (float64 NumPy oracle on the host)
    schedule: str = "scan"   # 'scan' | 'unrolled': the level executors (one
    #   Python loop over the plan's levels); 'mega': the stream executors
    #   (the whole factorization, and each solve sweep, as one kernel)
    precision: str = "highest"  # 'highest' | 'high' | 'default': at
    #   'default' the update products of float32 pools (K3, K4's UPD runs,
    #   the level path's syrk bmm) run in one TF32 pass on the tensor
    #   cores; everything else is IEEE arithmetic of the pool dtype, 'high'
    #   included (float32 is as accurate as the TPU's three-pass HIGH, and
    #   a TF32x3 body was no faster on the H100).  Pair 'default' with
    #   refine 6 (bench.py's setting)
    dtype: str = "float32"   # pool dtype: 'float32' | 'float64'
    pallas_updates: str = "auto"  # 'auto' | 'on' | 'off': the JAX
    #   package's fused TPU update kernel; no effect here (the update kernel
    #   always runs)
    pallas_hmax: int = 2048   # its VMEM row budget; no effect here
    refine: int = 2          # iterative-refinement steps in solve (f64 resid)
    refine_device: bool = True  # refine on the pool's device (float64 ELL
    #   SpMV residuals); False computes the residuals on the host
    ndevices: int = 1        # devices of the forest path (mode 'batched')
    solve_group: int | None = None  # the TPU solve kernel's micro-tasks per
    #   grid step; no effect here (the solve stream kernel has no grid steps)
    # diagnostics -----------------------------------------------------------
    trace: bool = False      # event tracing of factor/solve (TraceLog,
    #   read through NumericFactor.trace_log)
    timers: bool = False     # step timers of factor/solve (utils/timers)
    device: str | None = None  # torch device of the pool and executors;
    #   None means "cuda".  factor raises RuntimeError when a CUDA device is
    #   asked for and none is available: it never carries on on the CPU.

    def __post_init__(self):
        if self.nb < 1:
            raise ValueError(f"nb must be >= 1, got {self.nb}")
        if self.nemin < 1:
            raise ValueError(f"nemin must be >= 1, got {self.nemin}")
        if self.mode not in ("batched", "stf"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.schedule not in ("scan", "unrolled", "mega"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.pallas_updates not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown pallas_updates {self.pallas_updates!r}")
        if self.pallas_hmax < 8:
            raise ValueError(f"pallas_hmax must be >= 8, "
                             f"got {self.pallas_hmax}")
        if self.ndevices < 1:
            raise ValueError(f"ndevices must be >= 1, got {self.ndevices}")
        if self.solve_group is not None and self.solve_group < 1:
            raise ValueError(
                f"solve_group must be >= 1, got {self.solve_group}")
        if self.device is not None:
            if not isinstance(self.device, str) or \
                    self.device.split(":")[0] not in ("cpu", "cuda"):
                raise ValueError(
                    f"device must be None, 'cpu', 'cuda' or 'cuda:N', "
                    f"got {self.device!r}")

    @property
    def torch_device(self) -> str:
        """The device string the executors run on ('cuda' when unset)."""
        return "cuda" if self.device is None else self.device
