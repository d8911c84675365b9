"""The elasticity configuration: its generator's pattern and values at a
size a test holds (m = 3, 4), and ``correct`` on a small cell of it (m = 4,
nb 16) on the CPU: a sound run passes and a perturbed answer fails, as
``test_bench_correct.py`` has them for Poisson; the control's factor is
less precise."""

import json
import os
import time

import numpy as np
import pytest
import scipy.sparse as sp

import spllt_tpu_torch as st

from benchmark import harness, inputs

from conftest import ROOT, small_copy

BENCH = harness.Bench()
MAKE = BENCH.generator("elasticity3d")


def full(m, values=None):
    """The symmetric matrix of the generator at ``m`` (3 dofs a node) as a
    dense array, and its lower CSC."""
    n, colptr, rowind, vals = MAKE({"m": m, "dofs": 3})
    if values is not None:
        vals = values
    low = sp.csc_matrix((vals, rowind, colptr), shape=(n, n))
    return (low + sp.tril(low, -1).T).toarray(), (n, colptr, rowind, vals)


def test_pattern_at_m4():
    """81 nonzeros in every interior row, full 3 × 3 node blocks, sorted
    lower CSC, a symmetric pattern."""
    m = 4
    a, (n, colptr, rowind, _) = full(m)
    assert n == 3 * m ** 3 and colptr[0] == 0 and colptr[-1] == len(rowind)
    cols = np.repeat(np.arange(n), np.diff(colptr))
    assert (rowind >= cols).all()
    for c in range(n):
        assert (np.diff(rowind[colptr[c]:colptr[c + 1]]) > 0).all()
    nz = a != 0
    assert (nz == nz.T).all()
    blocks = nz.reshape(m ** 3, 3, m ** 3, 3)
    per_block = blocks.sum(axis=(1, 3))
    assert set(np.unique(per_block)) == {0, 9}
    g = np.arange(m ** 3)
    ijk = np.stack([g // (m * m), (g // m) % m, g % m], 1)
    coupled = (np.abs(ijk[:, None] - ijk[None]) <= 1).all(-1)
    assert ((per_block == 9) == coupled).all()
    inner = ((ijk > 0) & (ijk < m - 1)).all(1)
    rows = nz.sum(1).reshape(m ** 3, 3)
    assert (rows[inner] == 81).all() and (rows[~inner] < 81).all()


def test_margin_zero_inside_positive_on_the_boundary():
    m = 4
    a, _ = full(m)
    margin = np.diag(a) - (np.abs(a).sum(1) - np.abs(np.diag(a)))
    g = np.arange(m ** 3).repeat(3)
    ijk = np.stack([g // (m * m), (g // m) % m, g % m], 1)
    inner = ((ijk > 0) & (ijk < m - 1)).all(1)
    assert (margin[inner] == 0).all() and (margin[~inner] > 0).all()
    assert np.diag(a).max() == 80.0 and set(np.unique(a)) == {-1.0, 0, 80.0}


def test_refactor_value_sets_are_spd():
    """The refactor traffic's value sets at m = 3: a Cholesky of each."""
    matrix = MAKE({"m": 3, "dofs": 3})
    data = inputs.make_inputs(matrix, BENCH.traffic("refactor"), 2 ** 33 + 5)
    assert len(data.value_sets) == 4
    for v in data.value_sets:
        a, _ = full(3, v)
        np.linalg.cholesky(a)
        assert not np.array_equal(v, matrix[3])


def elasticity_copy(dest: str, m: int = 4, nb: int = 16) -> str:
    """:func:`conftest.small_copy` with one more configuration,
    ``elasticity3d-<m>``, made from ``elasticity3d-64``'s file at a size a
    test holds, and its cell ``elas3d<m>.refactor``, listed wherever
    ``elas3d64.refactor`` is."""
    small_copy(dest)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "elasticity3d-64.json")) as f:
        config = json.load(f)
    name, cell = f"elasticity3d-{m}", f"elas3d{m}.refactor"
    config.update(name=name, matrix={"m": m, "dofs": 3})
    config["options"].update(grid_shape=[m, m, m, 3], nb=nb)
    config["work"] = {}
    rel = f"benchmark/configs/{name}.json"
    with open(os.path.join(dest, rel), "w") as f:
        json.dump(config, f)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": name, "source": "test", "file": rel,
                            "reduced": [], "why": "test size"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "refactor", "chips": 1,
                              "why": "test size"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "elas3d64.refactor" in metric.get("workloads", []):
            metric["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
    return dest


@pytest.fixture(scope="module")
def elas_bench(tmp_path_factory):
    dest = elasticity_copy(str(tmp_path_factory.mktemp("elas")))
    return harness.Bench(root=dest, bench_dir=os.path.join(dest, "benchmark"))


def run(bench, **kw):
    return harness.run_cell(bench, "elas3d4.refactor", 2 ** 32 + 3, 0.05,
                            False, time.perf_counter(), device="cpu", **kw)


def test_a_sound_run_is_correct(elas_bench):
    out = run(elas_bench)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    c = out["checks"]["bwd_err"]
    assert c["value"] <= 1e-15 < c["limit"] == 2e-14
    assert {"factor_ms", "solve_ms", "setup_s"} <= set(out["metrics"])


def test_the_control_lowers_the_factor_precision(elas_bench):
    """The configuration's control: TF32 update products (precision
    'default').  At m = 4 (κ ≈ 4) its two refinement steps still reach
    float64 accuracy, so this cell cannot show it not correct; the card's
    ``control.py --control`` run at 64³ does.  Here, without refinement,
    the control's factor leaves a backward error well above the
    program's."""
    control = elas_bench.config("elasticity3d-4")["control"]
    assert control == {"precision": "default"}
    prog = run(elas_bench, overrides={"refine": 0})
    ctl = run(elas_bench, overrides={**control, "refine": 0})
    assert ctl["checks"]["bwd_err"]["value"] > \
        4 * prog["checks"]["bwd_err"]["value"]


def test_a_perturbed_answer_is_not_correct(elas_bench, monkeypatch):
    """One entry of each answer moved by a millionth of the largest."""
    real = st.solve

    def solve(*a, **k):
        x = np.array(real(*a, **k))
        x.reshape(len(x), -1)[len(x) // 2, 0] += 1e-6 * np.abs(x).max()
        return x
    monkeypatch.setattr(st, "solve", solve)
    out = run(elas_bench)
    assert not out["correct"], out["checks"]
