"""Share of the time inside the ``solve`` spans in which no device operation
runs (%): the host's part of ``api.solve`` (permutation, copies, launches)."""

from benchmark import timeline


def read(run):
    if run.timeline is None:
        return None
    share = timeline.idle_share(run.timeline, "solve")
    return None if share is None else 100.0 * share
