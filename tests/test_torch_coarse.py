"""spllt_tpu_torch's dense coarse-subtree phase (Options(coarse_subtrees=True))
held against spllt_tpu: the coarse partition, the dense-phase tables and the
NumPy oracle field by field, the device executor against the oracle, the
coarsened factorization against the plain one under every mode and
schedule, the not-positive-definite guard, the cache keys, and the trace /
timers options.  All on the CPU, where the potrf kernel's wrapper takes its
plain version; the matrices are those of tests/test_coarse_subtrees.py."""

import dataclasses

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.analyse.coarsen import coarse_partition as partition_j
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.numeric.subtree import subtree_np as subtree_np_j
from spllt_tpu_torch.analyse.coarsen import coarse_partition as partition_t
from spllt_tpu_torch.numeric.assemble import assemble_np, assemble_torch
from spllt_tpu_torch.numeric.subtree import DenseSubtreeExecutor, subtree_np
from spllt_tpu_torch.utils import timers

from test_torch_host import assert_same

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

CASES = {
    "poisson2d-16": ("poisson2d", (16,),
                     dict(ordering="nd-grid", grid_shape=(16, 16), nb=8,
                          nemin=4)),
    "poisson3d-6": ("poisson3d", (6,),
                    dict(ordering="nd-grid", grid_shape=(6, 6, 6), nb=16,
                         nemin=8)),
    "random-80": ("random_spd", (80, 0.05, 5),
                  dict(ordering="amd", nb=8, nemin=4)),
}
COARSE = dict(coarse_subtrees=True, coarse_span=96, coarse_waste=50.0)


def matrices(name):
    """The same matrix from each package's generator."""
    fn, args, opts = CASES[name]
    return getattr(sj, fn)(*args), getattr(st, fn)(*args), opts


def analysed(name, **kw):
    """(matrix, reference symb, port symb, port options) with the coarse
    layer on; ``kw`` adds port-only options."""
    mj, mt, opts = matrices(name)
    base = dict(prune_tree=False, refine=0, **opts, **COARSE)
    symb_j = sj.analyse(mj, sj.Options(mode="stf", **base))
    opt_t = st.Options(device="cpu", dtype="float64", **base, **kw)
    return mt, symb_j, st.analyse(mt, opt_t), opt_t


def bwderr(a, x, b):
    return np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(CASES))
def test_coarse_partition_equal_reference(name):
    _, symb_j, symb_t, _ = analysed(name)
    nsub = []
    for span, waste in ((96, 50.0), (64, 16.0), (256, 8.0)):
        cj = partition_j(symb_j.forest, symb_j.node_flops, max_span=span,
                         waste=waste)
        ct = partition_t(symb_t.forest, symb_t.node_flops, max_span=span,
                         waste=waste)
        assert_same(cj, ct, f"coarse[{span},{waste}]")
        nsub.append(ct.nsub)
    assert nsub[0] > 0, nsub


@pytest.mark.parametrize("name", list(CASES))
def test_dense_tables_equal_reference(name):
    """The plans with the coarse layer on, the dense phase's per-bucket
    tables among them, field by field."""
    _, symb_j, symb_t, opt_t = analysed(name)
    for pj, pt, nm in zip(plans_j(symb_j, symb_j.options),
                          symb_t.cache.block_plans(symb_t, opt_t),
                          ("plan", "fplan", "splan")):
        if nm == "fplan":
            pj, pt = (dataclasses.replace(p, dense=None) for p in (pj, pt))
        assert_same(pj, pt, nm)
    dj = plans_j(symb_j, symb_j.options)[1].dense
    dt = symb_t.cache.block_plans(symb_t, opt_t)[1].dense
    assert dt and len(dj) == len(dt)
    for bj, bt in zip(dj, dt):
        assert set(bj) == set(bt)
        for k in bj:
            assert_same(bj[k], bt[k], k)


@pytest.mark.parametrize("name", list(CASES))
def test_subtree_np_equal_reference(name):
    _, symb_j, symb_t, opt_t = analysed(name)
    plan, fp, _ = symb_t.cache.block_plans(symb_t, opt_t)
    vals = symb_t.a_perm.values
    got = subtree_np(assemble_np(plan, vals), vals, fp)
    ref = subtree_np_j(assemble_np(plan, vals), vals,
                       plans_j(symb_j, symb_j.options)[1])
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_executor_matches_oracle(name):
    """The device executor (gathers from the assembled pool, the potrf
    wrapper's plain version on the CPU, indexed stores) against the float64
    oracle: every pool tile, 1e-12 of max|L| (a library Cholesky and
    triangular solve against NumPy's, summed in another order)."""
    _, _, symb_t, opt_t = analysed(name)
    plan, fp, _ = symb_t.cache.block_plans(symb_t, opt_t)
    vals = symb_t.a_perm.values
    ref = subtree_np(assemble_np(plan, vals), vals, fp)
    pool = assemble_torch(plan, vals, torch.float64, "cpu")
    ex = DenseSubtreeExecutor(fp, "cpu")
    got, bad = ex(pool)
    assert got is pool and not bool(bad)
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * scale
    # the tiles of nodes outside the coarse layer are untouched
    touched = np.zeros(plan.nblocks + 1, bool)
    for t in ex.buckets:
        touched[t["blk"].numpy()] = True
    assert np.array_equal(got.numpy()[~touched],
                          assemble_np(plan, vals)[~touched])
    # on the CPU the wrapper runs its plain version: no launch is counted
    assert [t["launches"] for t in ex.buckets] == [0] * len(ex.buckets)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("mode,schedule", [("stf", "scan"),
                                           ("batched", "scan"),
                                           ("batched", "mega")])
def test_coarse_matches_plain(name, mode, schedule):
    """tests/test_coarse_subtrees.py::test_coarse_matches_plain for the
    port, under both schedules: the same bounds."""
    mat, _, symb_co, _ = analysed(name, mode=mode, schedule=schedule)
    _, _, opts = matrices(name)
    kw = dict(mode=mode, schedule=schedule, prune_tree=False, refine=0,
              device="cpu", dtype="float64")
    plain = st.factor(st.analyse(mat, st.Options(**opts, **kw)))
    co = st.factor(symb_co)
    assert co.fplan.dense and sum(b["nsub"] for b in co.fplan.dense) > 0
    assert co.fplan.num_tasks < plain.fplan.num_tasks
    xt, b = st.make_rhs(mat, nrhs=2)
    x1 = st.solve(plain, b)
    x2 = st.solve(co, b)
    assert bwderr(mat, x2, b) < 1e-12
    np.testing.assert_allclose(x2, x1, atol=1e-9)


def poisoned(mat, symb):
    """``mat`` with a negative diagonal entry on the first column of the
    first coarsened subtree (a front that is not positive definite)."""
    fp = symb.cache.block_plans(symb, symb.options)[1]
    for b in fp.dense:
        hit = np.flatnonzero(b["asm_r"] == b["asm_c"])
        if len(hit):
            vidx = int(b["asm_vidx"][hit[0]])
            col = int(np.searchsorted(symb.a_perm.colptr, vidx,
                                      side="right") - 1)
            break
    u = int(symb.perm[col])            # the column in the user's order
    vals = mat.values.copy()
    lo, hi = mat.colptr[u], mat.colptr[u + 1]
    vals[lo + int(np.flatnonzero(mat.rowind[lo:hi] == u)[0])] = -1.0
    return st.CscMatrix(mat.n, mat.colptr, mat.rowind, vals)


@pytest.mark.parametrize("mode,schedule", [("stf", "scan"),
                                           ("batched", "scan"),
                                           ("batched", "mega")])
def test_failed_front_raises(mode, schedule):
    """A front that is not positive definite raises NotPositiveDefiniteError
    — through the dense phase's own flag in batched mode — and the same
    symbolic object then factors the good matrix."""
    mat, _, symb, _ = analysed("poisson2d-16", mode=mode, schedule=schedule)
    with pytest.raises(st.NotPositiveDefiniteError):
        st.factor(symb, poisoned(mat, symb))
    xt, b = st.make_rhs(mat, nrhs=1)
    assert bwderr(mat, st.solve(st.factor(symb, mat), b), b) < 1e-12


def test_dense_flag_alone_reaches_the_guard():
    """The dense phase's flag is true for a failed front even where the
    NaN front never reaches element [0, 0] of a tile."""
    mat, _, symb, opt_t = analysed("random-80")
    plan, fp, _ = symb.cache.block_plans(symb, opt_t)
    bad = poisoned(mat, symb)
    from spllt_tpu_torch.api import _permuted_values

    pool = assemble_torch(plan, _permuted_values(symb, bad, opt_t),
                          torch.float64, "cpu")
    _, flag = DenseSubtreeExecutor(fp, "cpu")(pool)
    assert bool(flag)


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_cache_keys_follow_the_coarse_options(schedule):
    """Toggling coarse_subtrees, or changing coarse_span, on one symbolic
    object builds the plan and executor of that setting, never another's;
    and each setting's second factorization reuses its own."""
    mat, _, symb, _ = analysed("poisson2d-16", schedule=schedule)
    xt, b = st.make_rhs(mat, nrhs=1)
    nums = []
    for kw in (dict(coarse_subtrees=False), COARSE,
               dict(COARSE, coarse_span=64), dict(coarse_subtrees=False),
               COARSE):
        o = st.Options(**dict(CASES["poisson2d-16"][2], prune_tree=False,
                              refine=0, device="cpu", dtype="float64",
                              schedule=schedule, **kw))
        num = st.factor(symb, options=o)
        assert bwderr(mat, st.solve(num, b), b) < 1e-12
        assert bool(num.fplan.dense) == o.coarse_subtrees
        nums.append(num)
    assert nums[0].fplan is nums[3].fplan and nums[1].fplan is nums[4].fplan
    assert len({id(n.fplan) for n in nums[:3]}) == 3
    assert (sum(b["nsub"] for b in nums[1].fplan.dense)
            != sum(b["nsub"] for b in nums[2].fplan.dense)
            or nums[1].fplan.num_tasks != nums[2].fplan.num_tasks)
    state = symb.cache.device("cpu")
    fex = list(state.factor_executors.values())
    assert len(fex) == 3 and len({id(e.fp) for e in fex}) == 3
    dense = list(state.dense_executors.values())
    assert len(dense) == 2
    assert symb.cache.dense_executor(symb, nums[1].options, "cpu") in dense
    assert len(state.dense_executors) == 2


@pytest.mark.parametrize("mode,schedule", [("stf", "scan"),
                                           ("batched", "mega")])
def test_trace_and_timers_options(mode, schedule):
    """Options(trace=True, timers=True): factor and solve leave one event
    each on the factor's TraceLog and one node each in the timer registry,
    as in spllt_tpu.api; the batched factor also its assembly's phase."""
    mat, _, symb, _ = analysed("poisson3d-6", mode=mode, schedule=schedule,
                               trace=True, timers=True)
    timers.reset_timers()
    num = st.factor(symb)
    xt, b = st.make_rhs(mat, nrhs=1)
    st.solve(num, b)
    st.solve(num, b, job=1)
    names = [e["name"] for e in num.trace_log.events]
    phases = ["factor.assemble"] if mode == "batched" else []
    assert names == phases + ["factor", "solve(job=0)", "solve(job=1)"]
    assert all(e["dur"] > 0 for e in num.trace_log.events)
    from spllt_tpu_torch.api import trace_log

    assert trace_log(num) is num.trace_log is trace_log(num.options)
    text = timers.print_timers()
    for nm in phases + ["factor", "solve(job=0)", "solve(job=1)"]:
        assert nm in text
    timers.reset_timers()
    assert st.Options(device="cpu").timers is False
    plain = st.factor(symb, options=st.Options(**CASES["poisson3d-6"][2],
                                               mode=mode, device="cpu"))
    assert plain.trace_log is None


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_coarse_default_precision_refines_to_f64(schedule):
    """coarse_subtrees=True on a float32 pool at precision='default' (TF32
    update products on the card): the dense phase runs and is cached, a
    second factorization of the same values gives the same bits, and 6
    refinement steps reach the float64 backward error."""
    _, mat, opts = matrices("poisson2d-16")
    o = st.Options(device="cpu", dtype="float32", precision="default",
                   refine=6, schedule=schedule, prune_tree=False, **opts,
                   **COARSE)
    symb = st.analyse(mat, o)
    num = st.factor(symb)
    assert num.fplan.dense and sum(b["nsub"] for b in num.fplan.dense) > 0
    dense_executors = num.state.dense_executors
    (dense,) = dense_executors.values()
    assert isinstance(dense, DenseSubtreeExecutor)
    first = num.pool.clone()
    again = st.factor(symb, mat)
    assert list(dense_executors.values()) == [dense]
    assert again.pool.dtype == torch.float32
    assert torch.equal(again.pool, first)
    _, b = st.make_rhs(mat, nrhs=2)
    assert bwderr(mat, st.solve(num, b), b) < 1e-13
