"""Device time of the factor stream's kernels per factorization (ms), from
the traced run's timeline.  The kernels are those whose names contain one of
NAMES: K4's cooperative POTRF/TRSM kernel (``csrc/mega_factor.cu``) and the
update kernel of its UPD runs (``csrc/update_compact.cuh``)."""

from benchmark import timeline

NAMES = ("mega_factor_kernel", "update_kernel")


def read(run):
    tl = run.timeline
    if tl is None or not tl.of("factor"):
        return None
    ops = timeline.ops_in(tl, "factor", NAMES)
    if not ops:
        return None
    return 1e3 * timeline.op_seconds(ops) / len(tl.of("factor"))
