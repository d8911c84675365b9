"""Device time of the host-to-device copies per factorization (ms), from the
traced run's timeline: the copies whose profiler names start with PREFIX
inside the ``factor`` spans (the assembly's index and value uploads, and
any other table the call sends to the card), summed and divided by the
factorizations."""

from benchmark import timeline

PREFIX = "Memcpy HtoD"


def read(run):
    tl = run.timeline
    if tl is None or not tl.of("factor"):
        return None
    ops = [op for op in timeline.ops_in(tl, "factor")
           if op[0].startswith(PREFIX)]
    return 1e3 * timeline.op_seconds(ops) / len(tl.of("factor"))
