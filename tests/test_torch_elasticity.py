"""The structural-mechanics pattern on the port's main path, on the CPU:
3-D linear elasticity on trilinear hexahedra over an m × m × m node grid,
3 dofs a node (81 nonzeros in an interior row), through ``analyse``,
``factor`` and ``solve`` with ``schedule='mega'`` and the geometric
ordering over ``grid_shape=(m, m, m, 3)``; the assembly and ELL phases of
``Options(trace=True)``; the stream tables at pool offsets past 2**31
elements, on index arithmetic alone."""

import dataclasses

import numpy as np
import pytest
import torch

import spllt_tpu_torch as st
from spllt_tpu_torch.analyse.ordering import nd_grid_ordering
from spllt_tpu_torch.numeric import megakernel, solve_mega

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

DOFS = 3
SIZES = [3, 4]


def elasticity(m: int, dofs: int = DOFS):
    """Dense symmetric matrix and lower CSC (n, colptr, rowind, values) of
    the pattern: node (i, j, k) is g = i·m² + j·m + k, its dof d is row
    dofs·g + d; nodes with |Δi|, |Δj|, |Δk| ≤ 1 are coupled in a full
    dofs × dofs block of −1; the diagonal is 27·dofs − 1, the off-diagonal
    count of an interior row."""
    nn = m ** 3
    ijk = np.stack(np.unravel_index(np.arange(nn), (m, m, m)), 1)
    coupled = (np.abs(ijk[:, None] - ijk[None]) <= 1).all(-1)
    a = -np.kron(coupled.astype(np.float64), np.ones((dofs, dofs)))
    np.fill_diagonal(a, 27.0 * dofs - 1.0)
    cols, rows = np.nonzero(np.tril(a).T)      # column by column, rows sorted
    colptr = np.searchsorted(cols, np.arange(nn * dofs + 1))
    return a, (nn * dofs, colptr, rows, a[rows, cols])


def options(m: int, **kw):
    base = dict(device="cpu", ordering="nd-grid", grid_shape=(m, m, m, DOFS),
                nb=16, nemin=8, schedule="mega", dtype="float32", refine=2)
    return st.Options(**{**base, **kw})


def rhs(n: int, seed: int = 0):
    return np.random.default_rng(seed).standard_normal(n)


def bwd_err(a, x, b):
    return np.linalg.norm(a @ x - b) / np.linalg.norm(b)


def test_helper_pattern():
    """81 nonzeros in every interior row, fewer on the boundary, and
    diagonal dominance with margin 0 inside."""
    m = 4
    a, (n, colptr, rowind, values) = elasticity(m)
    count = (a != 0).sum(1).reshape(-1, DOFS)
    g = np.arange(m ** 3)
    ijk = np.stack([g // (m * m), (g // m) % m, g % m], 1)
    inner = ((ijk > 0) & (ijk < m - 1)).all(1)
    assert (count[inner] == 81).all() and (count[~inner] < 81).all()
    margin = 2 * np.diag(a) - np.abs(a).sum(1)
    assert (margin.reshape(-1, DOFS)[inner] == 0).all()
    assert (margin.reshape(-1, DOFS)[~inner] > 0).all()
    assert colptr[-1] == len(rowind) == (np.count_nonzero(a) + n) // 2


@pytest.mark.parametrize("m", SIZES)
def test_float32_pool_refines_to_float64(m):
    """The main path: float32 pool, stream executors, two steps of float64
    refinement on the card's residual path (here its CPU twin)."""
    a, (n, colptr, rowind, values) = elasticity(m)
    symb = st.analyse(st.CscMatrix(n, colptr, rowind, values), options(m))
    num = st.factor(symb)
    assert num.pool.dtype == torch.float32
    b = rhs(n)
    assert bwd_err(a, st.solve(num, b), b) <= 1e-12


@pytest.mark.parametrize("m", SIZES)
def test_float64_pool_against_dense_cholesky(m):
    """x from a float64 pool, unrefined, against a dense float64 Cholesky of
    the same matrix in plain torch.  Both solves are backward stable and
    the matrix is well conditioned at these sizes (κ < 10), so their
    answers differ by a few n·κ·2⁻⁵³ at most: 1e-12 of ‖x‖ leaves room."""
    a, (n, colptr, rowind, values) = elasticity(m)
    symb = st.analyse(st.CscMatrix(n, colptr, rowind, values),
                      options(m, dtype="float64", refine=0))
    b = rhs(n, 1)
    x = st.solve(st.factor(symb), b)
    at = torch.as_tensor(a)
    ref = torch.cholesky_solve(torch.as_tensor(b)[:, None],
                               torch.linalg.cholesky(at))[:, 0].numpy()
    assert np.linalg.norm(x - ref) <= 1e-12 * np.linalg.norm(ref)


def test_refactorization_through_the_value_map():
    """A second value set on the same pattern (new arrays) gathers through
    the value map, factors and solves to float64 accuracy."""
    m = 4
    a, (n, colptr, rowind, values) = elasticity(m)
    symb = st.analyse(st.CscMatrix(n, colptr, rowind, values), options(m))
    rng = np.random.default_rng(5)
    diag = rowind == np.repeat(np.arange(n), np.diff(colptr))
    for k in range(2):
        v = values * (1.0 + 0.25 * rng.random(len(values)))
        v[diag] = values[diag] * (1.0 + 0.5 * rng.random(n))
        ak = st.CscMatrix(n, colptr.copy(), rowind.copy(), v)
        num = st.factor(symb, ak)
        assert np.array_equal(num.values_perm, ak.permute(symb.perm).values)
        b = rhs(n, k)
        assert bwd_err(ak.to_scipy(), st.solve(num, b), b) <= 1e-12
    vm = symb.cache.value_map
    assert (vm.hits, vm.fallbacks) == (1, 0)


def test_trace_records_the_assembly_and_the_ell():
    """``factor.assemble`` (entries scattered, where their values were put
    in order, bytes uploaded: the float64 values alone), ``solve.ell`` (the
    residual's ELL width; the pattern's int32 ``idx`` and ``src`` uploaded
    once; the factor's values already on the device from its assembly) and
    ``factor.values`` (entries gathered) on the TraceLog; nothing with
    tracing off."""
    m = 4
    _, (n, colptr, rowind, values) = elasticity(m)
    a = st.CscMatrix(n, colptr, rowind, values)
    symb = st.analyse(a, options(m, trace=True))
    num = st.factor(symb, a)
    b = rhs(n)
    st.solve(num, b)
    st.solve(num, b)
    ev = {}
    for e in num.trace_log.events:
        ev.setdefault(e["name"], []).append(e["args"])
    nnz = len(rowind)
    assert ev["factor.values"] == [{"nnz": nnz, "path": "permute"}]
    assert ev["factor.assemble"] == [{"nnz": nnz, "path": "host",
                                      "h2d_bytes": 8 * nnz}]
    assert ev["solve.ell"] == [
        {"kmax": 81, "rebuilt": False, "h2d_bytes": (4 + 4) * n * 81},
        {"kmax": 81, "rebuilt": False, "h2d_bytes": 0}]
    names = [e["name"] for e in num.trace_log.events]
    assert names == ["factor.values", "factor.assemble", "factor",
                     "solve.ell", "solve(job=0)", "solve.ell",
                     "solve(job=0)"]
    plain = st.factor(symb, a, options=dataclasses.replace(symb.options,
                                                           trace=False))
    st.solve(plain, b)
    assert plain.trace_log is None


def test_grid_ordering_keeps_node_dofs_together():
    """``nd_grid_ordering((m, m, m, 3))`` visits the nodes in the order of
    the node grid's own ordering, and splits a node's dofs only inside a
    block of pairwise coupled nodes (a clique, whose elimination order does
    not change the fill); every separator keeps each node's dofs
    together."""
    m = 6
    perm = nd_grid_ordering((m, m, m, DOFS))
    node = perm // DOFS
    first = np.sort(np.unique(node, return_index=True)[1])
    assert np.array_equal(node[first], nd_grid_ordering((m, m, m)))
    pos = np.empty(len(perm), np.int64)
    pos[perm] = np.arange(len(perm))
    pos = pos.reshape(-1, DOFS)
    lo, hi = pos.min(1), pos.max(1)
    split = np.flatnonzero(hi - lo > DOFS - 1)
    assert 0 < len(split) < m ** 3
    for g in split:
        grp = np.unique(node[lo[g]:hi[g] + 1])
        ijk = np.stack([grp // (m * m), (grp // m) % m, grp % m], 1)
        assert (np.abs(ijk[:, None] - ijk[None]) <= 1).all()


def test_stream_row_bases_past_2_31_pool_elements():
    """The stream tables at the elasticity 64³ pool's size (20,894,080 rows
    of 128, 2.67e9 elements): each holds the row base in int32, and the
    element offset row × nb, which int32 cannot hold, is what the kernels
    form in 64 bits; a pool of more than 2**31 rows is refused."""
    nb, rows = 128, 20_894_080
    last = rows - nb
    assert last * nb > 2 ** 31
    ident = {"srcn": np.zeros(1, np.int64), "aux": np.full(1, nb)}
    runs = [(megakernel.KIND_POTRF, dict(ident, wr=[last], wc=[last],
                                         dst=[last]), None, None),
            (megakernel.KIND_TRSM, dict(ident, wr=[last - nb], wc=[last],
                                        dst=[last]), None, None)]
    fs = megakernel.assemble_stream(runs, nb, rows)
    assert fs["dst"].dtype == np.int32 and fs["wr"].dtype == np.int32
    assert fs["dst"].tolist() == [last, last]
    assert (fs["dst"].astype(np.int64) * nb).tolist() == [last * nb] * 2
    with np.errstate(over="ignore"):
        assert int(fs["dst"][0] * np.int32(nb)) != last * nb
    with pytest.raises(ValueError, match="2\\*\\*31"):
        megakernel.assemble_stream(runs, nb, 2 ** 31 + nb)

    work = rows + 3 * nb
    sol = {"kind": solve_mega.KIND_SOL, "wA": [last], "wS": [rows],
           "dst": [rows + nb], "aux": [nb]}
    ss = solve_mega.solve_stream([sol], nb, rows, work)
    assert ss["wA"].dtype == np.int32 and ss["wA"].tolist() == [last]
    assert int(ss["wA"][0]) * nb == last * nb
    with pytest.raises(ValueError, match="2\\*\\*31"):
        solve_mega.solve_stream([sol], nb, rows, 2 ** 31 + nb)
