"""``correct``: a sound run passes; the control and each fault the cells can
have fail.  The runs skip the harness's look for a card and drive the rest
of a run, the window included, at a size a test holds (Poisson 16³, nb 32),
on the CPU and, where there is one, on the card."""

import time
import types

import numpy as np
import pytest

import spllt_tpu_torch as st

from benchmark import harness

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda":
        return request.getfixturevalue("cuda_device")
    return request.param


def run(bench, cell, device, seed=7, **kw):
    return harness.run_cell(bench, cell, seed, 0.05, False,
                            time.perf_counter(), device=device, **kw)


@pytest.mark.parametrize("cell", ["p3d16.refactor", "p3d16.resolve"])
def test_a_sound_run_is_correct(small_bench, device, cell):
    out = run(small_bench, cell, device)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    c = out["checks"]["bwd_err"]
    assert c["value"] <= 1e-14 < c["limit"]


@pytest.mark.parametrize("cell", ["p3d16.refactor", "p3d16.resolve"])
def test_the_control_is_not_correct(small_bench, device, cell):
    """The configuration's control: TF32 update products (precision
    'default') under the same two refinement steps."""
    control = small_bench.config("poisson3d-16")["control"]
    assert control == {"precision": "default"}
    out = run(small_bench, cell, device, overrides=control)
    assert not out["correct"]
    assert out["checks"]["bwd_err"]["value"] > \
        out["checks"]["bwd_err"]["limit"]


def stale_factor(monkeypatch):
    """factor returns its first result on every later call."""
    real, first = st.factor, []

    def factor(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    monkeypatch.setattr(st, "factor", factor)


def stale_solution(monkeypatch):
    """solve returns its first answer on every later call."""
    real, first = st.solve, []

    def solve(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0].copy()
    monkeypatch.setattr(st, "solve", solve)


def half_batch(monkeypatch):
    """solve answers the first half of the right-hand sides only."""
    real = st.solve

    def solve(num, b, *a, **k):
        x = np.array(real(num, b, *a, **k))
        x[:, x.shape[1] // 2:] = 0.0
        return x
    monkeypatch.setattr(st, "solve", solve)


def altered_answer(monkeypatch):
    """one entry of each answer moved by a millionth of the largest."""
    real = st.solve

    def solve(*a, **k):
        x = np.array(real(*a, **k))
        x.reshape(len(x), -1)[len(x) // 2, 0] += 1e-6 * np.abs(x).max()
        return x
    monkeypatch.setattr(st, "solve", solve)


@pytest.mark.parametrize("cell,fault", [
    ("p3d16.refactor", stale_factor),
    ("p3d16.refactor", altered_answer),
    ("p3d16.resolve", stale_solution),
    ("p3d16.resolve", half_batch),
    ("p3d16.resolve", altered_answer),
])
def test_each_fault_is_not_correct(small_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    # a clock that moves 10 ms a reading: the window holds several steps,
    # so that a stale one is among those the check draws, however slow the
    # machine
    ticks = iter(range(10 ** 9))
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: 0.01 * next(ticks)))
    out = harness.run_cell(small_bench, cell, 11, 0.3, False, 0.0,
                           device="cpu")
    assert out["attempted"] >= 3
    assert not out["correct"], out["checks"]
