"""spllt_tpu_torch's matrix files and checkpoints held against spllt_tpu: the
MatrixMarket and Rutherford-Boeing readers and writers both ways (the same
bytes written, the same matrix read), symbolic ``.npz`` files that load in
either package, an ``stf`` factor saved by the port that the reference
solves to the same x, and batched checkpoints that reload bit for bit."""

import gzip

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.sparse import io as io_j
from spllt_tpu.utils import persist as persist_j
from spllt_tpu_torch.sparse import io as io_t
from spllt_tpu_torch.utils import persist as persist_t

from test_torch_host import assert_same

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

MATRICES = {"fem3d": lambda g: g.fem3d(4, dofs=2, seed=3),
            "poisson2d": lambda g: g.poisson2d(9),
            "random": lambda g: g.random_spd(50, 0.08, seed=7)}
WRITERS = {"mm": ("write_matrix_market", "read_matrix_market", ".mtx"),
           "rb": ("write_rutherford_boeing", "read_rutherford_boeing",
                  ".rb")}


def same_matrix(x, y):
    assert x.n == y.n
    for k in ("colptr", "rowind", "values"):
        assert np.array_equal(getattr(x, k), getattr(y, k)), k


@pytest.mark.parametrize("fmt", list(WRITERS))
@pytest.mark.parametrize("name", list(MATRICES))
def test_writers_and_readers_both_ways(tmp_path, name, fmt):
    """Both writers write the same bytes; each package's reader reads either
    file (plain and gzip) back to the matrix, exactly."""
    write, read, ext = WRITERS[fmt]
    a = MATRICES[name](st)
    same_matrix(a, MATRICES[name](sj))
    pj, pt = tmp_path / f"j{ext}", tmp_path / f"t{ext}"
    getattr(io_j, write)(str(pj), a)
    getattr(io_t, write)(str(pt), a)
    assert pj.read_bytes() == pt.read_bytes()
    pz = tmp_path / f"t{ext}.gz"
    pz.write_bytes(gzip.compress(pt.read_bytes()))
    for path in (pj, pt, pz):
        got_t = getattr(io_t, read)(str(path), force_posdef=False)
        got_j = getattr(io_j, read)(str(path), force_posdef=False)
        same_matrix(got_t, a)
        same_matrix(got_j, a)
        same_matrix(io_t.read_matrix(str(path), fmt="mm" if fmt == "mm"
                                     else None), io_j.read_matrix(
            str(path), fmt="mm" if fmt == "mm" else None))


def test_pattern_only_file_gets_the_same_values(tmp_path):
    """A pattern-only MatrixMarket file: both readers fill the same random
    diagonally dominant values."""
    p = tmp_path / "p.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                 "4 4 7\n1 1\n2 2\n3 3\n4 4\n2 1\n3 2\n4 3\n")
    same_matrix(io_t.read_matrix_market(str(p)),
                io_j.read_matrix_market(str(p)))
    with pytest.raises(ValueError):
        bad = tmp_path / "g.mtx"
        bad.write_text("%%MatrixMarket matrix coordinate real general\n"
                       "1 1 1\n1 1 1.0\n")
        io_t.read_matrix_market(str(bad))


def analysed(pkg, mode="stf", **kw):
    a = pkg.poisson2d(10)
    return a, pkg.analyse(a, pkg.Options(ordering="nd-grid",
                                         grid_shape=(10, 10), nb=8,
                                         nemin=4, mode=mode, **kw))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_symbolic_npz_loads_in_both_packages(tmp_path, direction):
    """A symbolic checkpoint written by either package loads in the other
    with every field and option equal (the port's options take the device
    asked for)."""
    _, symb_j = analysed(sj)
    _, symb_t = analysed(st, device="cpu")
    p = str(tmp_path / "symb.npz")
    if direction == "reference_to_port":
        persist_j.save_symbolic(p, symb_j)
        got, want = persist_t.load_symbolic(p, device="cpu"), symb_t
        assert got.options.device == "cpu"
    else:
        persist_t.save_symbolic(p, symb_t)
        got, want = persist_j.load_symbolic(p), symb_j
    assert_same(got, want, "symb")
    for k in persist_t._OPT_FIELDS:
        assert getattr(got.options, k) == getattr(want.options, k), k
    assert persist_t._OPT_FIELDS == persist_j._OPT_FIELDS


def test_port_stf_factor_solves_in_reference(tmp_path):
    """An stf factor saved by the port, loaded and solved by the reference:
    the same x as the port's own solve of it."""
    a, symb = analysed(st, device="cpu")
    num = st.factor(symb)
    p = str(tmp_path / "fact.npz")
    persist_t.save_factor(p, num)
    xt, b = st.make_rhs(a, nrhs=2)
    num_j = persist_j.load_factor(p)
    assert isinstance(num_j.pool, np.ndarray)
    x_j = sj.solve(num_j, b)
    x_t = st.solve(persist_t.load_factor(p, device="cpu"), b)
    np.testing.assert_array_equal(x_t, st.solve(num, b))
    np.testing.assert_allclose(x_j, x_t, rtol=0, atol=1e-14)
    assert np.linalg.norm(a.matvec(x_t) - b) / np.linalg.norm(b) < 1e-13


@pytest.mark.parametrize("schedule,dtype", [("scan", "float32"),
                                            ("mega", "float64")])
def test_batched_checkpoint_reloads_bit_for_bit(tmp_path, schedule, dtype):
    """save_factor → load_factor onto the device asked for: the pool in its
    own dtype, the symbolic object's per-device state shared as factor
    shares it, the solve bit for bit the original factor's; a refactorize
    of load_symbolic's object equals the original factor bit for bit."""
    a, symb = analysed(st, mode="batched", schedule=schedule, dtype=dtype,
                       device="cpu")
    num = st.factor(symb)
    p = str(tmp_path / "fact.npz")
    persist_t.save_factor(p, num)
    num2 = persist_t.load_factor(p, device="cpu")
    assert num2.pool.dtype == num.pool.dtype and num2.pool.device.type == \
        "cpu"
    assert torch.equal(num2.pool, num.pool)
    xt, b = st.make_rhs(a, nrhs=3)
    np.testing.assert_array_equal(st.solve(num2, b), st.solve(num, b))
    assert num2.state is num2.symb.cache.device("cpu")
    assert len(num2.state.solve_executors) == 1
    assert st.factor(num2.symb).state is num2.state
    symb2 = persist_t.load_symbolic(p + ".symb.npz", device="cpu")
    assert torch.equal(st.factor(symb2).pool, num.pool)


def test_loaders_default_to_the_card(tmp_path):
    """Without ``device`` the loaders ask for the card: a batched checkpoint
    does not load onto the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, symb = analysed(st, mode="batched", device="cpu")
    p = str(tmp_path / "fact.npz")
    persist_t.save_factor(p, st.factor(symb))
    assert persist_t.load_symbolic(p + ".symb.npz").options.device is None
    with pytest.raises(RuntimeError, match="cuda"):
        persist_t.load_factor(p)


def test_factor_convert_and_load_share_the_device_state(tmp_path):
    """``factor``, ``numeric_from_numpy`` and ``load_factor`` build their
    factors through one constructor: the same ``inform``, and the pattern's
    per-device state (executors, the refined solve's ELL) shared with every
    other factor of the same symbolic object, so a solve of any of them
    builds nothing twice and returns the same bits."""
    from spllt_tpu_torch.convert import numeric_from_numpy, numeric_to_numpy

    a, symb = analysed(st, mode="batched", schedule="mega",
                       dtype="float32", device="cpu")
    num = st.factor(symb)
    xt, b = st.make_rhs(a, nrhs=2)
    x = st.solve(num, b)
    state = num.state
    assert state is symb.cache.device("cpu") and state.ell is not None
    solvers = dict(state.solve_executors)
    num_c = numeric_from_numpy(symb, *numeric_to_numpy(num))
    assert num_c.state is state and num_c.inform == num.inform
    np.testing.assert_array_equal(st.solve(num_c, b), x)
    assert state.solve_executors == solvers
    p = str(tmp_path / "fact.npz")
    persist_t.save_factor(p, num)
    num_l = persist_t.load_factor(p, device="cpu")
    assert num_l.inform == num.inform
    np.testing.assert_array_equal(st.solve(num_l, b), x)
    again = st.factor(num_l.symb)
    assert again.state is num_l.state is num_l.symb.cache.device("cpu")
    solvers, ell = dict(num_l.state.solve_executors), num_l.state.ell
    np.testing.assert_array_equal(st.solve(again, b), x)
    assert num_l.state.solve_executors == solvers and len(solvers) == 1
    assert num_l.state.ell is ell
