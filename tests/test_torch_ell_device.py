"""The refined solve's ELL matrix formed on the device, on the CPU: the
pattern's ``DeviceEll`` (``idx``, ``src``) uploaded once per pattern and
device, each factor's values once, the ELL values gathered from them for
each solve; all of it held bit for bit against the host-built
``build_ell`` / ``ell_vals`` and the executor fed with them."""

import dataclasses

import numpy as np
import pytest
import torch

import spllt_tpu_torch as st
from spllt_tpu_torch.api import _solve_executor
from spllt_tpu_torch.numeric import spmv
from spllt_tpu_torch.numeric.solve_executor import refined
from spllt_tpu_torch.sparse.generators import poisson3d

from test_torch_elasticity import elasticity

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)


def _poisson8():
    return poisson3d(8), dict(grid_shape=(8, 8, 8))


def _elasticity4():
    _, (n, colptr, rowind, values) = elasticity(4)
    return (st.CscMatrix(n, colptr, rowind, values),
            dict(grid_shape=(4, 4, 4, 3)))


PATTERNS = {"p3d8": _poisson8, "elas4": _elasticity4}


@pytest.fixture(scope="module", params=list(PATTERNS))
def pattern(request):
    a, kw = PATTERNS[request.param]()
    o = st.Options(device="cpu", ordering="nd-grid", nb=16, nemin=8,
                   schedule="mega", dtype="float32", refine=2, **kw)
    return a, st.analyse(a, o)


def new_values(a, seed):
    """The values of a new matrix on ``a``'s pattern, still SPD."""
    rng = np.random.default_rng(seed)
    diag = a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr))
    v = a.values * (1.0 + 0.25 * rng.random(len(a.values)))
    v[diag] = a.values[diag] * (1.0 + 0.5 * rng.random(a.n))
    return st.CscMatrix(a.n, a.colptr.copy(), a.rowind.copy(), v)


def bits(t):
    return np.asarray(t, dtype=np.float64).view(np.int64)


def host_ell(symb, values):
    """The host-built ELL values and int64 indices as tensors."""
    ell = spmv.build_ell(symb.a_perm)
    return (torch.as_tensor(spmv.ell_vals(ell, values)),
            torch.as_tensor(ell.idx.astype(np.int64)))


def host_refined(num, b, refine=2):
    """The refined solve on the host-built ELL: ``spmv`` of ``ell_vals``
    and the int64 indices, fed to the same executor and loop."""
    vals, idx = host_ell(num.symb, num.values_perm)
    n = num.symb.n
    b64 = torch.as_tensor(num.padded(np.asarray(b, np.float64).reshape(n,
                                                                       -1)))
    ex = _solve_executor(num)

    def residual(x):
        r = torch.zeros_like(b64)
        r[:n] = b64[:n] - spmv.spmv(vals, idx, x)
        return r

    x = refined(lambda r: ex.full(num.pool, r).to(torch.float64), residual,
                b64, refine)
    return num.unpadded(x.numpy()).reshape(np.shape(b))


def rhs_padded(n, nrhs, seed):
    """A permuted right-hand side as the executors take it: [n + 1, nrhs]
    float64, the dump row zero."""
    x = np.random.default_rng(seed).standard_normal((n + 1, nrhs))
    x[-1] = 0
    return torch.as_tensor(x)


@pytest.mark.parametrize("nrhs", [1, 4])
def test_gather_equals_the_host_ell(pattern, nrhs):
    """The gather through ``src`` gives ``ell_vals``'s values bit for bit,
    pads included; ``idx`` is ``build_ell``'s (int32, ``src`` too); the
    residual operator equals ``spmv`` of the host-built ELL values and
    int64 indices bit for bit."""
    a, symb = pattern
    num = st.factor(symb, new_values(a, 1))
    ell = spmv.build_ell(symb.a_perm)
    nnz = len(symb.a_perm.rowind)
    dell = spmv.DeviceEll.upload(ell, nnz, torch.device("cpu"))
    assert dell.idx.dtype == dell.src.dtype == torch.int32
    assert dell.kmax == ell.kmax and dell.nnz == nnz
    assert np.array_equal(dell.idx.long().numpy(), ell.idx.astype(np.int64))
    values = dell.values(num.values_perm)
    vals = values[dell.src.long()]
    ref = spmv.ell_vals(ell, num.values_perm)
    assert np.array_equal(bits(vals), bits(ref))
    assert (ref[ell.src < 0] == 0).all() and (ell.src < 0).any()
    x = rhs_padded(a.n, nrhs, nrhs)
    y = dell.matvec(values)(x)
    assert y.dtype == torch.float64 and y.shape == (a.n, nrhs)
    assert np.array_equal(bits(y), bits(spmv.spmv(
        *host_ell(symb, num.values_perm), x)))


@pytest.mark.parametrize("over", [0, 1])
def test_src_widens_to_int64_at_the_limit(pattern, monkeypatch, over):
    """``src`` is int64 once nnz(A) + 1 reaches ``SRC_INT32_LIMIT`` (forced
    down to it here), int32 one below; the product is the same either
    way."""
    a, symb = pattern
    nnz = len(symb.a_perm.rowind)
    monkeypatch.setattr(spmv, "SRC_INT32_LIMIT", nnz + 1 + over)
    ell = spmv.build_ell(symb.a_perm)
    dell = spmv.DeviceEll.upload(ell, nnz, torch.device("cpu"))
    assert dell.src.dtype == (torch.int32 if over else torch.int64)
    assert dell.nbytes == (4 + dell.src.element_size()) * a.n * ell.kmax
    x = rhs_padded(a.n, 2, 0)
    y = dell.matvec(dell.values(symb.a_perm.values))(x)
    assert np.array_equal(bits(y), bits(spmv.spmv(
        *host_ell(symb, symb.a_perm.values), x)))


@pytest.mark.parametrize("nrhs", [1, 3])
def test_refined_x_equals_the_host_built_ell(pattern, nrhs):
    """``solve`` returns, bit for bit, what the executor returns when fed
    today's host-built ELL values and int64 indices."""
    a, symb = pattern
    ak = new_values(a, 2)
    num = st.factor(symb, ak)
    rng = np.random.default_rng(nrhs)
    b = rng.standard_normal(a.n if nrhs == 1 else (a.n, nrhs))
    x = st.solve(num, b)
    assert np.array_equal(bits(x), bits(host_refined(num, b)))
    assert np.linalg.norm(ak.matvec(x) - b) <= 1e-13 * np.linalg.norm(b)


def test_refactor_loop_uploads_values_once_a_factor(pattern, monkeypatch):
    """After a pattern's first refined solve the host builds no ELL: a
    refactor loop runs with ``build_ell`` and ``ell_vals`` raising; each
    factor's values crossed with its assembly, so no solve uploads values
    (``DeviceEll.uploads`` stays 0) and only the pattern's first solve
    uploads the ELL pattern; ``gathers`` counts the solves; ``solve.ell``
    reports the bytes that crossed."""
    a, symb0 = pattern
    symb = st.analyse(a, dataclasses.replace(symb0.options, trace=True))
    b = np.random.default_rng(0).standard_normal(a.n)
    st.solve(st.factor(symb, new_values(a, 3)), b)
    dell = symb.cache.device("cpu").ell
    assert (dell.uploads, dell.gathers) == (0, 1)

    def refuse(*args):
        raise AssertionError("host ELL built on the refactor path")

    monkeypatch.setattr(spmv, "build_ell", refuse)
    monkeypatch.setattr(spmv, "ell_vals", refuse)
    for k in range(3):
        num = st.factor(symb, new_values(a, 4 + k))
        x1 = st.solve(num, b)
        held = num._ell_values
        x2 = st.solve(num, b)
        assert num._ell_values is held
        assert np.array_equal(bits(x1), bits(x2))
    assert (dell.uploads, dell.gathers) == (0, 7)
    ell = [e["args"] for e in num.trace_log.events
           if e["name"] == "solve.ell"]
    first = {"kmax": dell.kmax, "rebuilt": False,
             "h2d_bytes": 8 * a.n * dell.kmax}
    none = {"kmax": dell.kmax, "rebuilt": False, "h2d_bytes": 0}
    assert ell == [first] + [none, none] * 3


def test_two_live_factors_solve_against_their_own_values(pattern):
    """Two factors of one pattern alive at once, solved in turns: each
    solves against its own values (bit for bit its host-built refined
    solve), and neither uploads its values again."""
    a, symb = pattern
    nums = [st.factor(symb, new_values(a, 10 + k)) for k in range(2)]
    b = np.random.default_rng(1).standard_normal(a.n)
    xs = [st.solve(nums[0], b)]
    dell = symb.cache.device("cpu").ell
    counts = dell.uploads, dell.gathers
    xs += [st.solve(num, b) for num in nums[1:] + nums]
    assert (dell.uploads - counts[0], dell.gathers - counts[1]) == (0, 3)
    assert nums[0]._ell_values is not nums[1]._ell_values
    for k, num in enumerate(nums):
        ref = host_refined(num, b)
        assert np.array_equal(bits(xs[k]), bits(ref))
        assert np.array_equal(bits(xs[k + 2]), bits(ref))
        assert torch.equal(num._ell_values[:-1],
                           torch.as_tensor(num.values_perm))
    assert not np.array_equal(xs[0], xs[1])


def test_resident_bytes_within_one_factor_of_the_host_ell(pattern):
    """What the residual keeps on the device for one factor, its values
    and the pattern's ``DeviceEll``, is no more than the 16 bytes a slot
    (float64 values and int64 indices) that one factor held before."""
    a, symb = pattern
    num = st.factor(symb, new_values(a, 20))
    st.solve(num, np.ones(a.n))
    dell = symb.cache.device("cpu").ell
    held = num._ell_values.nbytes
    assert held == 8 * (len(symb.a_perm.rowind) + 1)
    assert held + dell.nbytes <= 16 * a.n * dell.kmax
