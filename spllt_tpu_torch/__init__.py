"""spllt_tpu_torch — the PyTorch/CUDA port of the spllt_tpu sparse Cholesky
solver, for NVIDIA Hopper GPUs.

Same three-phase API and the same plans as ``spllt_tpu`` (the JAX package,
which stays in the repository as the reference): host-side symbolic analyse
(ordering, elimination tree, supernode amalgamation, nb-blocking), a
statically level-scheduled batched factorization, and a level-scheduled
forward/backward solve with float64 iterative refinement on the device.
Its six kernels (the level path's potrf, trsm, fused update and left solve,
and the two stream kernels) are hand-written CUDA C++ (``csrc/``), built at
first use; ``Options(ndevices=k)`` spreads the factorization over k devices
(``parallel/``), and ``native/capi.cpp`` is its C interface.  This package
imports torch, numpy and scipy — never jax, and nothing of ``spllt_tpu``.

Public API::

    from spllt_tpu_torch import analyse, factor, solve, Options
    symb = analyse(a, Options(nb=128, nemin=32))       # device: "cuda"
    num  = factor(symb)
    x    = solve(num, b)
"""

from .api import NumericFactor, SymbolicFactor, analyse, factor, solve
from .errors import NotPositiveDefiniteError, SpLLTError
from .inform import Inform
from .options import Options
from .sparse.csc import CscMatrix
from .sparse.generators import (fem3d, make_rhs, poisson2d,
                                poisson3d, random_spd)

__version__ = "0.1.0"

__all__ = [
    "analyse", "factor", "solve", "Options", "Inform",
    "SymbolicFactor", "NumericFactor", "CscMatrix",
    "poisson2d", "poisson3d", "random_spd", "fem3d", "make_rhs",
    "SpLLTError", "NotPositiveDefiniteError",
]
