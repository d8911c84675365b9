"""Wall time inside ``solve(num, b_k)`` calls in the window, per call (ms):
the refined solve the user receives, float64 x on the host."""


def read(run):
    spans = run.of("solve")
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for _, t0, t1 in spans) / len(spans)
