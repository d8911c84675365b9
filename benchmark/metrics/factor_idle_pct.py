"""Share of the time inside the ``factor`` spans in which no device operation
runs (%): the host's part of ``api.factor`` (the value permutation, the
uploads, the launches) until spans inside the program split it."""

from benchmark import timeline


def read(run):
    if run.timeline is None:
        return None
    share = timeline.idle_share(run.timeline, "factor")
    return None if share is None else 100.0 * share
