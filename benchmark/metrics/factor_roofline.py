"""The factorization's least time on the card (``work.factor_bound_s`` of
the configuration's frozen counts) over the device time of every operation
inside the ``factor`` spans, per factorization (%)."""

from benchmark import timeline, work


def read(run):
    tl = run.timeline
    peaks = work.card_peaks(run.device_name)
    if tl is None or peaks is None or not tl.of("factor"):
        return None
    busy = timeline.op_seconds(timeline.ops_in(tl, "factor"))
    if busy <= 0:
        return None
    bound = work.factor_bound_s(run.config["work"], peaks)
    return 100.0 * bound * len(tl.of("factor")) / busy
