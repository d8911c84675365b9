"""Wall time inside ``factor(symb, a_k)`` calls in the window, per call (ms).

The call ends in the program's own ``notpos`` synchronisation, so its host
span holds all of its device work.  None where the window factors nothing.
"""


def read(run):
    spans = run.of("factor")
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for _, t0, t1 in spans) / len(spans)
