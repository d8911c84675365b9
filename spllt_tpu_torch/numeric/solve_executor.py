"""What the two solve executors share: their interface and the refinement.

:class:`.solve_scan.ScanSolveExecutor` (the level schedule, K5) and
:class:`.solve_mega.MegaSolveExecutor` (the solve stream, K6) each run a
sweep in place on a work array of their own layout; the forest path
(:mod:`..parallel.forest`) runs the sweeps of several executors on copies of
one work array.  :func:`refined` is the one iterative-refinement loop.
"""

from __future__ import annotations

__all__ = ["SolveExecutor", "refined"]


class SolveExecutor:
    """A solve executor's tables on one device; they serve any nrhs.

    A subclass defines ``load(x)``, a new work array from the padded rhs x
    [n+1, nrhs] (tensor or array, not modified; the dump row n zero), and
    ``sweep(pool, work, forward)``, one sweep on the factor ``pool``
    [nblocks+1, nb, nb] in place on ``work``, which it returns; and the
    constructors ``of_plans(symb, plan, splan, smp, dtype, device)``, from
    a pattern's block and solve plans and, where ``uses_stream_plan``, its
    solve stream plan ``smp``, and ``of_forest(md, smp, devices, dtype)``,
    the ([per-device], top) executors of a forest plan."""

    uses_stream_plan = False

    def begin_backward(self, work) -> None:
        """Make a forward sweep's ``work`` ready for the backward sweep."""

    def unload(self, work):
        """The padded solution [n+1, nrhs] in the pool dtype."""
        return work

    def fwd(self, pool, x):
        """L y = x (job 1); a new [n+1, nrhs] tensor."""
        return self.unload(self.sweep(pool, self.load(x), True))

    def bwd(self, pool, x):
        """Lᵀ z = x (job 2)."""
        return self.unload(self.sweep(pool, self.load(x), False))

    def full(self, pool, x):
        """L y = x; Lᵀ z = y (job 0)."""
        work = self.sweep(pool, self.load(x), True)
        self.begin_backward(work)
        return self.unload(self.sweep(pool, work, False))


def refined(solve, residual, b, refine: int):
    """x = solve(b), then ``refine`` times x += solve(residual(x)), where
    ``residual(x)`` is b − A x; ``x`` (a float64 array or tensor) is updated
    in place, so the loop holds no second solution."""
    x = solve(b)
    for _ in range(refine):
        x += solve(residual(x))
    return x
