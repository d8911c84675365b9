"""A factor's values cross to the device once: the pattern's assembly map
(``numeric.assemble.AssemblyMap`` in ``DeviceState.assembly``) puts a
refactorized matrix's values in the analysed order on the device and
scatters them into the pool through one cached flat index, and the factor
keeps those values for its residuals.  On the CPU, held bit for bit
against ``assemble_np`` and ``assemble_torch``; the card test compares
sha256 digests on the card."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import spllt_tpu_torch as st
from spllt_tpu_torch.numeric import assemble, spmv
from spllt_tpu_torch.numeric.assemble import (AssemblyMap, assemble_np,
                                              assemble_torch)

from test_torch_elasticity import elasticity

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

M = 12


def new_values(a, seed):
    """A new matrix on ``a``'s pattern (copies of its arrays), still SPD."""
    rng = np.random.default_rng(seed)
    diag = a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr))
    v = a.values * (1.0 + 0.25 * rng.random(len(a.values)))
    v[diag] = a.values[diag] * (1.0 + 0.5 * rng.random(a.n))
    return st.CscMatrix(a.n, a.colptr.copy(), a.rowind.copy(), v)


def reversed_rows(a):
    """The same matrix with each column's rows in reverse: other pattern
    arrays, which the value map does not match, but the same permuted
    pattern."""
    rowind, values = a.rowind.copy(), a.values.copy()
    for j in range(a.n):
        s, e = a.colptr[j], a.colptr[j + 1]
        rowind[s:e], values[s:e] = a.rowind[s:e][::-1], a.values[s:e][::-1]
    return st.CscMatrix(a.n, a.colptr.copy(), rowind, values)


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.reshape(-1).view(np.uint8)


def scattered(monkeypatch):
    """The pools ``AssemblyMap.scatter`` returns, cloned as they leave it
    (before any factor executor runs on them)."""
    pools = []
    scatter = AssemblyMap.scatter

    def spy(self, values, dtype):
        pool = scatter(self, values, dtype)
        pools.append(pool.clone())
        return pool

    monkeypatch.setattr(AssemblyMap, "scatter", spy)
    return pools


def analysed(a, **kw):
    o = st.Options(device="cpu", ordering="nd-grid", grid_shape=(M, M),
                   nb=8, nemin=4, refine=2, **kw)
    return st.analyse(a, o)


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("schedule", ["mega", "scan"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_every_path_assembles_the_pool_of_today(monkeypatch, dtype, schedule,
                                                coarse):
    """``a=None``, the first matrix (builds the value map), a matrix whose
    arrays are copies (ordered on the device), one whose arrays differ but
    permute to the analysed pattern, and the gather again: each assembled
    pool equals ``assemble_np``'s and ``assemble_torch``'s bit for bit,
    ``values_perm`` the permutation's, and the factored pool a fresh
    analysis's."""
    a = st.poisson2d(M)
    symb = analysed(a, dtype=dtype, schedule=schedule,
                    coarse_subtrees=coarse)
    pools = scattered(monkeypatch)
    mats = [new_values(a, k) for k in range(1, 5)]
    given = [None, mats[0], mats[1], reversed_rows(mats[2]), mats[3]]
    tdt = torch.float64 if dtype == "float64" else torch.float32
    for k, ak in enumerate(given):
        num = st.factor(symb, ak)
        pool = pools[-1]
        ref = (symb.a_perm if ak is None else ak.permute(symb.perm)).values
        assert np.array_equal(bits(num.values_perm), bits(ref))
        assert np.array_equal(bits(pool), bits(assemble_np(
            num.plan, ref, dtype=np.dtype(dtype))))
        assert np.array_equal(bits(pool), bits(assemble_torch(
            num.plan, ref, tdt, "cpu")))
        if ak is not None:
            fresh = st.factor(st.analyse(mats[k - 1], symb.options))
            assert torch.equal(num.pool, fresh.pool)
    amap = symb.cache.device("cpu").assembly[8]
    assert (amap.gathers, amap.host_orders, amap.builds) == (2, 3, 2)
    assert amap.unique


def test_values_perm_is_taken_at_factor_time():
    """The caller edits ``a.values`` in place after ``factor``: the factor's
    ``values_perm`` and pool stay those of the values it factored."""
    a = st.poisson2d(M)
    symb = analysed(a, schedule="mega", dtype="float32")
    st.factor(symb, new_values(a, 1))
    ak = new_values(a, 2)
    ref = ak.permute(symb.perm).values
    num = st.factor(symb, ak)
    assert symb.cache.device("cpu").assembly[8].gathers == 1
    pool = num.pool.clone()
    ak.values *= 2.0
    assert np.array_equal(bits(num.values_perm), bits(ref))
    assert torch.equal(num.pool, pool)
    # what crossed once is what the residuals use
    assert np.array_equal(bits(num._ell_values[:-1]), bits(ref))
    num.values_perm[:] = 0
    assert np.array_equal(bits(num._ell_values[:-1]), bits(ref))


@pytest.mark.parametrize("first", ["matrix", "none"])
def test_counters_and_trace(first):
    """``builds`` (``dst`` at the pattern's first factor, ``pos`` once there
    is a value map), ``host_orders``, ``gathers`` (every factor after the
    value map's first), ``DeviceEll.uploads`` 0; ``factor.assemble`` gives
    the path and 8 bytes an entry, ``solve.ell`` uploads the ELL pattern at
    the first solve and nothing after."""
    a = st.poisson2d(M)
    symb = analysed(a, schedule="mega", dtype="float32", trace=True)
    nnz = len(symb.a_perm.rowind)
    b = np.random.default_rng(0).standard_normal(a.n)
    num = st.factor(symb, None if first == "none" else new_values(a, 1))
    amap = symb.cache.device("cpu").assembly[8]
    assert (amap.gathers, amap.host_orders) == (0, 1)
    assert amap.builds == (1 if first == "none" else 2)
    assert (amap.pos is None) == (first == "none")
    x = st.solve(num, b)
    for k in range(3):
        num = st.factor(symb, new_values(a, 2 + k))
        x = st.solve(num, b)
    assert np.linalg.norm(new_values(a, 4).matvec(x) - b) <= (
        1e-13 * np.linalg.norm(b))
    gathers = 2 if first == "none" else 3
    assert (amap.gathers, amap.host_orders, amap.builds) == (
        gathers, 4 - gathers, 2)
    assert amap.pos.nbytes + amap.dst.nbytes == 8 * nnz     # both int32
    dell = symb.cache.device("cpu").ell
    assert (dell.uploads, dell.gathers) == (0, 4)
    ev = {}
    for e in num.trace_log.events:
        ev.setdefault(e["name"], []).append(e["args"])
    host = {"nnz": nnz, "path": "host", "h2d_bytes": 8 * nnz}
    gather = dict(host, path="gather")
    assert ev["factor.assemble"] == [host] * (4 - gathers) + [gather] * gathers
    first_solve = {"kmax": dell.kmax, "rebuilt": False,
                   "h2d_bytes": dell.nbytes}
    again = dict(first_solve, h2d_bytes=0)
    assert ev["solve.ell"] == [first_solve] + [again] * 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_duplicate_targets_sum_as_add_at(dtype):
    """A plan whose entries share targets (each entry twice, and once more
    for a third of them): the map sees it, and the scatter sums them in
    ``np.add.at``'s order, bit for bit; without duplicates, the map takes
    ``index_add_``."""
    a = st.poisson2d(M)
    symb = analysed(a)
    plan = symb.cache.block_plans(symb, symb.options)[0]
    assert AssemblyMap.build(plan, "cpu").unique
    extra = np.arange(0, len(plan.asm_rowflat), 3)
    dup = dataclasses.replace(
        plan, asm_rowflat=np.concatenate([plan.asm_rowflat] * 2
                                         + [plan.asm_rowflat[extra]]),
        asm_col=np.concatenate([plan.asm_col] * 2 + [plan.asm_col[extra]]))
    values = np.random.default_rng(7).standard_normal(len(dup.asm_col))
    amap = AssemblyMap.build(dup, "cpu")
    assert not amap.unique
    pool = amap.scatter(amap.values(values), {
        np.float32: torch.float32, np.float64: torch.float64}[dtype])
    assert np.array_equal(bits(pool), bits(assemble_np(dup, values, dtype)))


@pytest.mark.parametrize("limit, widths", [
    ("nnz", (torch.int64, torch.int64)), ("nnz+1", (torch.int32, torch.int64)),
    ("numel", (torch.int32, torch.int64)),
    ("numel+1", (torch.int32, torch.int32))])
def test_index_widths_at_the_limit(monkeypatch, limit, widths):
    """``pos`` is int64 once nnz(A) reaches ``SRC_INT32_LIMIT`` (forced
    down here), ``dst`` once the pool's element count does; the pool and
    the values are the same bits either way."""
    a = st.poisson2d(M)
    symb = analysed(a, schedule="mega", dtype="float32")
    plan = symb.cache.block_plans(symb, symb.options)[0]
    nnz, numel = len(plan.asm_col), (plan.nblocks + 1) * plan.nb ** 2
    base = {"nnz": nnz, "numel": numel}[limit.split("+")[0]]
    monkeypatch.setattr(spmv, "SRC_INT32_LIMIT", base + ("+" in limit))
    st.factor(symb, new_values(a, 1))
    ak = new_values(a, 2)
    num = st.factor(symb, ak)
    amap = symb.cache.device("cpu").assembly[8]
    assert (amap.pos.dtype, amap.dst.dtype) == widths
    assert amap.gathers == 1
    assert amap.pos.nbytes + amap.dst.nbytes == (
        widths[0].itemsize + widths[1].itemsize) * nnz
    ref = ak.permute(symb.perm).values
    assert np.array_equal(bits(num.values_perm), bits(ref))
    fresh = st.factor(st.analyse(ak, symb.options))
    assert torch.equal(num.pool, fresh.pool)


def test_gather_refuses_values_of_another_length():
    """A matrix whose values do not match its pattern arrays' length is
    refused on the host, before anything is indexed on the device."""
    a = st.poisson2d(M)
    symb = analysed(a, schedule="mega", dtype="float32")
    st.factor(symb, new_values(a, 1))
    ak = new_values(a, 2)
    ak.values = ak.values[:-1]
    with pytest.raises(ValueError, match="values"):
        st.factor(symb, ak)


def elasticity_csc(m: int, dofs: int = 3) -> st.CscMatrix:
    """``test_torch_elasticity.elasticity``'s matrix built sparse: nodes
    with |Δi|, |Δj|, |Δk| ≤ 1 coupled in full dofs × dofs blocks of −1,
    the diagonal 27·dofs − 1."""
    g = np.arange(m ** 3).reshape(m, m, m)
    hi, lo = [g.ravel()], [g.ravel()]
    for d in np.ndindex(3, 3, 3):
        d = tuple(x - 1 for x in d)
        if d > (0, 0, 0):
            a = g[tuple(slice(max(0, -x), m - max(0, x)) for x in d)]
            b = g[tuple(slice(max(0, x), m + min(0, x)) for x in d)]
            hi.append(b.ravel())
            lo.append(a.ravel())
    hi, lo = np.concatenate(hi), np.concatenate(lo)
    e = np.arange(dofs)
    r = (hi[:, None, None] * dofs + e[:, None]).repeat(dofs, 2).ravel()
    c = (lo[:, None, None] * dofs + e[None, :]).repeat(dofs, 1).ravel()
    keep = r >= c
    r, c = r[keep], c[keep]
    return st.CscMatrix.from_coo(m ** 3 * dofs, r, c,
                                 np.where(r == c, 27.0 * dofs - 1.0, -1.0))


def test_sparse_elasticity_is_the_dense_helper():
    """The card test's sparse elasticity matrix is the CPU tests' one."""
    _, (n, colptr, rowind, values) = elasticity(4)
    a = elasticity_csc(4)
    assert a.n == n
    for x, y in ((a.colptr, colptr), (a.rowind, rowind), (a.values, values)):
        assert np.array_equal(x, y)


def digest(x) -> str:
    x = x.detach().cpu().contiguous() if isinstance(x, torch.Tensor) else x
    return hashlib.sha256(bits(x).tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["poisson3d-32", "elasticity-16"])
@pytest.mark.parametrize("wide", [False, True])
def test_card_assembly_equals_assemble_torch(monkeypatch, pattern, wide):
    """On the card: the pools the assembly map scatters (the first factor,
    ordered on the host, and a refactorization, ordered on the card) and
    ``values_perm`` have the sha256 digests of ``assemble_torch``'s pool
    and the permutation's values, with int32 indices and with int64 ones
    (``SRC_INT32_LIMIT`` forced to 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the factor executors have no "
                    "CPU twin on the card path")
    if pattern == "poisson3d-32":
        a, grid = st.poisson3d(32), (32, 32, 32)
    else:
        a, grid = elasticity_csc(16), (16, 16, 16, 3)
    if wide:
        monkeypatch.setattr(spmv, "SRC_INT32_LIMIT", 1)
    symb = st.analyse(a, st.Options(ordering="nd-grid", grid_shape=grid,
                                    nb=128, nemin=192))
    pools = scattered(monkeypatch)
    mats = [new_values(a, 1), new_values(a, 2)]
    for ak in mats:
        num = st.factor(symb, ak)
        ref = ak.permute(symb.perm).values
        assert digest(num.values_perm) == digest(ref)
        assert digest(pools[-1]) == digest(assemble_torch(
            num.plan, ref, torch.float32, "cuda"))
    amap = symb.cache.device("cuda").assembly[128]
    assert (amap.gathers, amap.host_orders) == (1, 1)
    width = torch.int64 if wide else torch.int32
    assert amap.pos.dtype == amap.dst.dtype == width
    assert symb.cache.device("cuda").ell is None
    st.solve(num, np.ones(a.n))
    assert symb.cache.device("cuda").ell.uploads == 0
    assert assemble.assemble_upload_bytes(num.plan) == 8 * len(ref)
