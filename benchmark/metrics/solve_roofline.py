"""The refined solve's least time on the card (``work.solve_bound_s`` of the
configuration's frozen counts, its refinement steps and the traffic's nrhs)
over the device time of every operation inside the ``solve`` spans, per
solve (%)."""

from benchmark import timeline, work


def read(run):
    tl = run.timeline
    peaks = work.card_peaks(run.device_name)
    if tl is None or peaks is None or not tl.of("solve"):
        return None
    busy = timeline.op_seconds(timeline.ops_in(tl, "solve"))
    if busy <= 0:
        return None
    bound = work.solve_bound_s(run.config["work"], peaks,
                               int(run.config["options"]["refine"]),
                               int(run.traffic["nrhs"]))
    return 100.0 * bound * len(tl.of("solve")) / busy
