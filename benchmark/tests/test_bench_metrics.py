"""The metric arithmetic, on synthetic spans and timelines."""

import json

import numpy as np
import pytest

from benchmark import harness, timeline, work

BENCH = harness.Bench()
CONFIG = BENCH.config("poisson3d-64")
H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return BENCH.reader(name)


def run_of(spans, tl=None, traffic="refactor", device=H100):
    return harness.Run(config=CONFIG, traffic=BENCH.traffic(traffic),
                       setup={"analyse_s": 4.5, "first_factor_s": 9.0,
                              "first_solve_s": 1.0, "setup_s": 20.0},
                       spans=spans, window_s=10.0,
                       memory_peak_bytes=3 * 2 ** 30, device_name=device,
                       timeline=tl)


def steps(durations):
    out, t = [], 0.0
    for d in durations:
        out.append(("step", t, t + d))
        t += d + 0.001
    return out


def test_p95_is_over_every_step():
    d = [0.1] * 95 + [1.0] * 5
    rng = np.random.default_rng(0)
    d = list(rng.permutation(d))
    got = reader("step_p95_ms")(run_of(steps(d)))
    assert got == pytest.approx(1e3 * np.percentile(d, 95))
    assert reader("step_p95_ms")(run_of([])) is None


def test_call_means_and_setup():
    spans = [("factor", 0.0, 0.2), ("solve", 0.2, 0.25),
             ("factor", 1.0, 1.4), ("solve", 1.4, 1.47)]
    r = run_of(spans)
    assert reader("factor_ms")(r) == pytest.approx(300.0)
    assert reader("solve_ms")(r) == pytest.approx(60.0)
    assert reader("factor_ms")(run_of(spans[1::2])) is None
    assert reader("peak_mem_gib")(r) == pytest.approx(3.0)
    assert reader("setup_s")(r) == 20.0
    assert reader("analyse_s")(r) == 4.5
    assert reader("first_factor_s")(r) == 9.0


def synthetic():
    """Two steps 200 ms apart: factor 0–100 ms with kernels at 20–50 (K4)
    and 60–80 (an assembly kernel), solve 100–140 ms with K6 at 110–130."""
    spans, ops = [], []
    for base in (0.0, 0.2):
        spans += [("step", base, base + 0.14),
                  ("factor", base, base + 0.1),
                  ("solve", base + 0.1, base + 0.14)]
        ops += [("void mega_factor_kernel<float, true>(float*)",
                 base + 0.02, base + 0.05),
                ("void at::native::index_put_kernel", base + 0.06,
                 base + 0.08),
                ("void mega_solve_kernel<float>(float const*)",
                 base + 0.11, base + 0.13)]
    return timeline.Timeline(spans=sorted(spans, key=lambda s: s[1]),
                             ops=ops)


def test_kernel_time_idle_share_and_window():
    tl = synthetic()
    r = run_of([], tl)
    assert reader("factor_kernel_ms")(r) == pytest.approx(30.0)
    assert reader("solve_kernel_ms")(r) == pytest.approx(20.0)
    assert reader("factor_idle_pct")(r) == pytest.approx(50.0)
    assert reader("solve_idle_pct")(r) == pytest.approx(50.0)
    assert timeline.window(tl) == (0.0, pytest.approx(0.34))
    assert timeline.busy_seconds(tl) == pytest.approx(0.14)
    top = timeline.top_ops(tl)
    assert top[0][0].startswith("void mega_factor") and top[0][1] == \
        pytest.approx(0.06)
    gaps = timeline.idle_gaps(tl)
    # each stretch is named by the span its midpoint lies in
    assert gaps[0][0] == "between" and gaps[0][1] == pytest.approx(0.09)
    assert sorted(g[0] for g in gaps) == sorted(
        ["factor.start", "factor.mid", "factor.end", "between",
         "factor.mid", "factor.end", "solve.end"])
    assert sum(g[1] for g in gaps) == pytest.approx(0.34 - 0.14)


def test_rooflines_read_the_frozen_counts():
    tl = synthetic()
    r = run_of([], tl)
    peaks = work.card_peaks(H100)
    w = CONFIG["work"]
    bound = max(w["flops"] / 67e12, 4 * (w["nnz_l"] + w["nnz_a"]) / 3.35e12)
    # device time inside the factor spans: 50 ms a factorization
    assert reader("factor_roofline")(r) == pytest.approx(
        100 * bound / 0.05)
    sbytes = (2 * 3 * 4 * w["nnz_l"] + 2 * 12 * w["nnz_a_full"]
              + 3 * 2 * 2 * 4 * w["n"] + 2 * 4 * 8 * w["n"])
    assert work.solve_bytes(w, 2, 1) == sbytes
    assert reader("solve_roofline")(r) == pytest.approx(
        100 * sbytes / 3.35e12 / 0.02)
    assert work.solve_bound_s(w, peaks, 2, 4) > work.solve_bound_s(
        w, peaks, 2, 1)
    # no card in the table, or no timeline: nothing to read
    assert reader("factor_roofline")(run_of([], tl, device="cpu")) is None
    for name in ("factor_roofline", "solve_roofline",
                 "factor_kernel_ms", "solve_idle_pct"):
        assert reader(name)(run_of([])) is None


def test_chrome_trace_is_read(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.step",
         "ts": 1000.0, "dur": 500.0},
        {"ph": "X", "cat": "user_annotation", "name": "bench.factor",
         "ts": 1000.0, "dur": 300.0},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 1000.0,
         "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1100.0, "dur": 50.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1200.0,
         "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1000.0,
         "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tl = timeline.from_chrome_trace(str(path))
    assert [s[0] for s in tl.spans] == ["step", "factor"]
    assert [o[0] for o in tl.ops] == ["k", "Memcpy HtoD"]
    assert tl.ops[0][1] == pytest.approx(1.1e-3)
    assert timeline.op_seconds(timeline.ops_in(tl, "factor")) == \
        pytest.approx(60e-6)
