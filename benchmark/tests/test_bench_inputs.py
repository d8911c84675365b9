"""The inputs: the frozen generator, and the seeded value sets and
right-hand sides of the traffic generator."""

import numpy as np
import pytest

from benchmark import harness, inputs

BENCH = harness.Bench()
POISSON = BENCH.generator("poisson3d")


@pytest.mark.parametrize("m", [1, 2, 3, 7])
def test_frozen_generator_equals_the_programs_today(m):
    import spllt_tpu_torch as st

    n, colptr, rowind, values = POISSON({"m": m})
    a = st.poisson3d(m)
    assert n == a.n
    assert np.array_equal(colptr, a.colptr)
    assert np.array_equal(rowind, a.rowind)
    assert np.array_equal(values, a.values)


def dense(n, colptr, rowind, v):
    a = np.zeros((n, n))
    cols = np.repeat(np.arange(n), np.diff(colptr))
    a[rowind, cols] = v
    return a + np.tril(a, -1).T


@pytest.mark.parametrize("traffic", ["refactor", "resolve"])
def test_inputs_repeat_for_a_seed_and_differ_for_another(traffic):
    mat = POISSON({"m": 5})
    t = BENCH.traffic(traffic)
    big = 2 ** 31 + 12345
    one, again = inputs.make_inputs(mat, t, big), inputs.make_inputs(mat, t,
                                                                     big)
    other = inputs.make_inputs(mat, t, big + 1)
    assert len(one.value_sets) == t["value_sets"]
    assert len(one.rhs_sets) == t["rhs_sets"]
    for a, b, c in zip(one.value_sets + one.rhs_sets,
                       again.value_sets + again.rhs_sets,
                       other.value_sets + other.rhs_sets):
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)
    shape = (mat[0],) if t["nrhs"] == 1 else (mat[0], t["nrhs"])
    assert all(b.shape == shape for b in one.rhs_sets)
    assert not np.array_equal(one.value_sets[0], mat[3])


@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 + 1])
def test_every_value_set_is_spd_and_strictly_dominant(seed):
    n, colptr, rowind, values = mat = POISSON({"m": 5})
    t = BENCH.traffic("refactor")
    for v in inputs.make_inputs(mat, t, seed).value_sets:
        a = dense(n, colptr, rowind, v)
        off = np.abs(a).sum(1) - np.abs(np.diag(a))
        assert np.all(np.diag(a) > off)
        assert np.linalg.eigvalsh(a).min() > 0
        np.linalg.cholesky(a)
        # off-diagonals scaled by a factor in [1, 1 + s)
        ratio = v[values < 0] / values[values < 0]
        assert ratio.min() >= 1.0 and ratio.max() < 1 + t["offdiag_scale"]
