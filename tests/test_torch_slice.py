"""The ported slice as a whole: spllt_tpu_torch against spllt_tpu through
the public API of both packages, on the same matrices and right-hand sides
(made from NumPy seeds), on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu_torch.convert import numeric_from_numpy, numeric_to_numpy

CASES = {
    "p2d12_nb8": (lambda m: m.poisson2d(12),
                  dict(nb=8, nemin=4, ordering="nd")),
    "p3d5_nb16": (lambda m: m.poisson3d(5),
                  dict(nb=16, nemin=8, ordering="amd")),
}
BWD_ERR = 1e-13


def bwd_err(a, x, b):
    return np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)


def rhs(a, nrhs, seed=0):
    b = np.random.default_rng(seed).standard_normal((a.n, nrhs))
    return b[:, 0] if nrhs == 1 else b


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Per matrix: the reference's f64 oracle factor and the port's f64 and
    f32 level-executor factors."""
    gen, kw = CASES[request.param]
    aj, at = gen(sj), gen(st)
    assert np.array_equal(aj.values, at.values)
    num_j = sj.factor(sj.analyse(aj, sj.Options(mode="stf", **kw)))
    symb_t = st.analyse(at, st.Options(device="cpu", dtype="float64", **kw))
    num_t64 = st.factor(symb_t)
    num_t32 = st.factor(symb_t, options=dataclasses.replace(
        symb_t.options, dtype="float32"))
    return dict(name=request.param, kw=kw, aj=aj, at=at, num_j=num_j,
                symb_t=symb_t, num_t64=num_t64, num_t32=num_t32)


def test_factor_pool_f64_equals_oracle(case):
    """Port f64 level executor vs spllt_tpu's stf f64 oracle: 1e-10."""
    pool_t = case["num_t64"].pool
    assert isinstance(pool_t, torch.Tensor) and pool_t.dtype == torch.float64
    assert pool_t.shape == case["num_j"].pool.shape
    np.testing.assert_allclose(pool_t.numpy(), case["num_j"].pool, rtol=0,
                               atol=1e-10)
    assert not pool_t[-1].any()            # trailing block stays zero
    # the port's own stf mode is the same oracle, bit for bit
    num_s = st.factor(case["symb_t"], options=dataclasses.replace(
        case["symb_t"].options, mode="stf"))
    assert np.array_equal(num_s.pool, case["num_j"].pool)


def test_factor_pool_f32_vs_reference_scan(case):
    """Port f32 vs spllt_tpu f32 scan executor (pallas_updates='off'):
    1e-4 relative to the largest entry."""
    num_j32 = sj.factor(sj.analyse(case["aj"], sj.Options(
        mode="batched", schedule="scan", dtype="float32",
        pallas_updates="off", **case["kw"])))
    ref = np.asarray(num_j32.pool)
    got = case["num_t32"].pool.numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    # carry the reference's f32 pool across and solve with the port
    b = rhs(case["at"], 3)
    num_c = numeric_from_numpy(case["symb_t"], ref, num_j32.values_perm,
                               case["num_t32"].options)
    x = st.solve(num_c, b)
    assert bwd_err(case["at"], x, b) <= BWD_ERR
    np.testing.assert_allclose(x, st.solve(case["num_t32"], b), rtol=0,
                               atol=1e-12 * np.abs(x).max())


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("job", [0, 1, 2])
def test_solve_jobs_match_reference(case, job, nrhs):
    """Unrefined solves of the port (f64) vs spllt_tpu's oracle: 1e-10;
    shapes [n] and [n, nrhs] are kept."""
    b = rhs(case["at"], nrhs, seed=job)
    ref = sj.solve(case["num_j"], b, job=job, refine=0)
    got = st.solve(case["num_t64"], b, job=job, refine=0)
    assert got.shape == b.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(ref).max()))


def test_jobs_1_then_2_equal_job_0(case):
    b = rhs(case["at"], 3, seed=5)
    num = case["num_t32"]
    x0 = st.solve(num, b, refine=0)
    x12 = st.solve(num, st.solve(num, b, job=1), job=2)
    # f32 factor; job 1's output passes through float64 → float32 once more
    np.testing.assert_allclose(x12, x0, rtol=0,
                               atol=1e-5 * np.abs(x0).max())


@pytest.mark.parametrize("nrhs", [1, 3])
def test_refined_solve_backward_error(case, nrhs):
    """f32 factor + 2 refinement steps on the device path: ≤ 1e-13; the f32
    solve alone is not that good, so refinement is what gets there."""
    b = rhs(case["at"], nrhs, seed=7)
    x = st.solve(case["num_t32"], b)                  # refine=2 default
    assert x.shape == b.shape
    assert bwd_err(case["at"], x, b) <= BWD_ERR
    assert bwd_err(case["at"], st.solve(case["num_t32"], b, refine=0),
                   b) > BWD_ERR
    ref = sj.solve(case["num_j"], b)
    np.testing.assert_allclose(x, ref, rtol=0,
                               atol=1e-11 * np.abs(ref).max())


def test_refined_solve_on_host(case):
    """Options(refine_device=False) computes the residuals on the host and
    reaches the same solution as the device loop."""
    num = case["num_t32"]
    host = dataclasses.replace(num, options=dataclasses.replace(
        num.options, refine_device=False))
    b = rhs(case["at"], 3, seed=11)
    x = st.solve(host, b)
    assert bwd_err(case["at"], x, b) <= BWD_ERR
    np.testing.assert_allclose(x, st.solve(num, b), rtol=0,
                               atol=1e-11 * np.abs(x).max())


def test_pinned_precision_restores_the_global_setting():
    """The level executors pin IEEE float32 products for the block and put
    the process-wide cuBLAS TF32 flag back afterwards, also on error."""
    from spllt_tpu_torch.numeric.factor_scan import pinned_precision

    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        for p in ("highest", "high", "default"):
            with pinned_precision(p):
                assert not mm.allow_tf32
            assert mm.allow_tf32
        with pytest.raises(KeyError):
            with pinned_precision("highest"):
                raise KeyError("inside")
        assert mm.allow_tf32
        with pytest.raises(ValueError):
            with pinned_precision("tf32"):
                pass
        # both executors run under it and leave the flag as it was
        a = st.poisson2d(6)
        num = st.factor(st.analyse(a, st.Options(nb=8, device="cpu")))
        st.solve(num, np.ones(a.n), refine=0)
        assert mm.allow_tf32
    finally:
        mm.allow_tf32 = prev


@pytest.mark.cuda
def test_cuda_scan_factor_ignores_global_tf32():
    """With TF32 switched on for the whole process, the level executor's
    float32 factor of poisson3d(32) under precision='highest' matches the
    one computed with TF32 off to 1e-5 of its largest entry (TF32 products
    would be off by about 1e-3), and the global flag is left on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    a = st.poisson3d(32)
    symb = st.analyse(a, st.Options(ordering="nd-grid",
                                    grid_shape=(32, 32, 32), nb=128,
                                    nemin=192))
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = False
        ref = st.factor(symb).pool
        mm.allow_tf32 = True
        got = st.factor(symb).pool
        assert mm.allow_tf32
    finally:
        mm.allow_tf32 = prev
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_refactorize_reuses_cached_plans_and_executors(case):
    symb, a = case["symb_t"], case["at"]
    num = case["num_t32"]
    cache_ids = {k: id(v) for k, v in symb._cache.items()}
    rng = np.random.default_rng(3)
    diag = a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr))
    vals = a.values * (1.0 + 0.2 * rng.random(a.values.shape))
    vals[diag] = a.values[diag] * 1.5
    a2 = st.CscMatrix(a.n, a.colptr, a.rowind, vals)
    num2 = st.factor(symb, a2, options=num.options)
    assert {k: id(v) for k, v in symb._cache.items()} == cache_ids
    assert num2.plan is num.plan and num2.fplan is num.fplan
    assert num2.splan is num.splan
    assert num2._solve_execs is num._solve_execs
    b = rhs(a, 3, seed=9)
    ex_before = dict(num._solve_execs)
    assert bwd_err(a2, st.solve(num2, b), b) <= BWD_ERR
    for k, ex in ex_before.items():
        assert num2._solve_execs[k] is ex
    # the reference on the same new values agrees
    xj = sj.solve(sj.factor(case["num_j"].symb,
                            sj.CscMatrix(a.n, a.colptr, a.rowind, vals)), b)
    np.testing.assert_allclose(st.solve(num2, b), xj, rtol=0,
                               atol=1e-11 * np.abs(xj).max())


def test_pattern_mismatch_raises_value_error(case):
    """Same n, another pattern (a 1-D Laplacian): ValueError from both."""
    n = case["at"].n
    with pytest.raises(ValueError, match="pattern"):
        st.factor(case["symb_t"], st.sparse.generators._grid_laplacian((n,)))
    with pytest.raises(ValueError, match="pattern"):
        sj.factor(case["num_j"].symb,
                  sj.sparse.generators._grid_laplacian((n,)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_indefinite_raises_from_both(case, dtype):
    a = case["at"]
    vals = a.values.copy()
    diag = np.flatnonzero(
        a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr)))
    vals[diag[a.n // 2]] = -1.0
    with pytest.raises(st.NotPositiveDefiniteError):
        st.factor(case["symb_t"],
                  st.CscMatrix(a.n, a.colptr, a.rowind, vals),
                  options=dataclasses.replace(case["symb_t"].options,
                                              dtype=dtype))
    with pytest.raises(sj.NotPositiveDefiniteError):
        sj.factor(case["num_j"].symb,
                  sj.CscMatrix(a.n, a.colptr, a.rowind, vals))


def test_convert_round_trip(case):
    """The factor is the state carried across: reference → port and port →
    reference, both through NumPy arrays only; same x either way (1e-12)."""
    a, b = case["at"], rhs(case["at"], 3, seed=11)
    num_j, num_t = case["num_j"], case["num_t64"]
    x_ref = sj.solve(num_j, b, refine=0)
    # spllt_tpu → spllt_tpu_torch (f64 oracle pool into the level executor)
    num_c = numeric_from_numpy(case["symb_t"], np.asarray(num_j.pool),
                               num_j.values_perm, num_t.options)
    assert isinstance(num_c.pool, torch.Tensor)
    x_c = st.solve(num_c, b, refine=0)
    np.testing.assert_allclose(x_c, x_ref, rtol=0,
                               atol=1e-12 * np.abs(x_ref).max())
    assert bwd_err(a, st.solve(num_c, b), b) <= BWD_ERR
    # spllt_tpu_torch → spllt_tpu
    pool_np, vals = numeric_to_numpy(num_t)
    assert isinstance(pool_np, np.ndarray) and pool_np.dtype == np.float64
    assert np.array_equal(vals, num_j.values_perm)
    num_back = dataclasses.replace(num_j, pool=pool_np, values_perm=vals)
    x_back = sj.solve(num_back, b, refine=0)
    np.testing.assert_allclose(x_back, x_ref, rtol=0,
                               atol=1e-12 * np.abs(x_ref).max())
    np.testing.assert_allclose(x_back, x_c, rtol=0,
                               atol=1e-12 * np.abs(x_ref).max())
    # a pool of the wrong shape is refused
    with pytest.raises(ValueError):
        numeric_from_numpy(case["symb_t"], pool_np[:-1], vals)
