"""``factor_h2d_ms`` and ``solve_h2d_ms`` on a synthetic timeline: the device
time of the host-to-device copies inside the ``factor`` and ``solve``
spans, per call."""

import pytest

from benchmark import harness, timeline

BENCH = harness.Bench()


def run_of(tl):
    return harness.Run(config=BENCH.config("elasticity3d-64"),
                       traffic=BENCH.traffic("refactor"), setup={},
                       spans=[], window_s=1.0, memory_peak_bytes=0,
                       device_name="NVIDIA H100 80GB HBM3", timeline=tl)


def test_copies_inside_the_spans_per_call():
    """Two steps: each factor holds a pageable and a pinned upload and a
    device-to-host copy; each solve an upload; a copy between the spans and
    a kernel named like a copy count nowhere."""
    spans, ops = [], []
    for base in (0.0, 1.0):
        spans += [("step", base, base + 0.9), ("factor", base, base + 0.5),
                  ("solve", base + 0.5, base + 0.9)]
        ops += [("Memcpy HtoD (Pageable -> Device)", base + 0.01,
                 base + 0.04),
                ("Memcpy HtoD (Pinned -> Device)", base + 0.05, base + 0.06),
                ("Memcpy DtoH (Device -> Pageable)", base + 0.1, base + 0.2),
                ("void copy_kernel_Memcpy HtoD", base + 0.2, base + 0.3),
                ("Memcpy HtoD (Pageable -> Device)", base + 0.6,
                 base + 0.62),
                ("Memcpy HtoD (Pageable -> Device)", base + 0.92,
                 base + 0.95)]
    tl = timeline.Timeline(spans=sorted(spans, key=lambda s: s[1]),
                           ops=sorted(ops, key=lambda o: o[1]))
    assert BENCH.reader("factor_h2d_ms")(run_of(tl)) == pytest.approx(40.0)
    assert BENCH.reader("solve_h2d_ms")(run_of(tl)) == pytest.approx(20.0)


def test_nothing_to_read():
    assert BENCH.reader("factor_h2d_ms")(run_of(None)) is None
    empty = timeline.Timeline(spans=[("step", 0.0, 1.0),
                                     ("solve", 0.0, 1.0)], ops=[])
    assert BENCH.reader("factor_h2d_ms")(run_of(empty)) is None
    assert BENCH.reader("solve_h2d_ms")(run_of(empty)) == 0.0
