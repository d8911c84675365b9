"""95th percentile of the wall time of every step of the window (ms).  A
step is factor plus solve where the traffic refactorizes, else one solve."""

import numpy as np


def read(run):
    steps = run.of("step")
    if not steps:
        return None
    return 1e3 * float(np.percentile([t1 - t0 for _, t0, t1 in steps], 95))
