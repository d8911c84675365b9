"""Device time of the host-to-device copies per refined solve (ms), from the
traced run's timeline: the copies whose profiler names start with PREFIX
inside the ``solve`` spans (the right-hand side, and after each factor the
residual's ELL values and indices), summed and divided by the solves."""

from benchmark import timeline

PREFIX = "Memcpy HtoD"


def read(run):
    tl = run.timeline
    if tl is None or not tl.of("solve"):
        return None
    ops = [op for op in timeline.ops_in(tl, "solve")
           if op[0].startswith(PREFIX)]
    return 1e3 * timeline.op_seconds(ops) / len(tl.of("solve"))
