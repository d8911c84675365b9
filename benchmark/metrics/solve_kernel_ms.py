"""Device time of the solve stream's kernels per refined solve (ms), from the
traced run's timeline: the kernels whose names contain one of NAMES, K6
(``csrc/mega_solve.cu``), one launch a sweep direction.  The refinement's
float64 product and updates run as PyTorch's own kernels, whose names other
layers share: they count in ``solve_roofline``'s time, not here."""

from benchmark import timeline

NAMES = ("mega_solve_kernel",)


def read(run):
    tl = run.timeline
    if tl is None or not tl.of("solve"):
        return None
    ops = timeline.ops_in(tl, "solve", NAMES)
    if not ops:
        return None
    return 1e3 * timeline.op_seconds(ops) / len(tl.of("solve"))
