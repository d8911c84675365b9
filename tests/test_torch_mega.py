"""spllt_tpu_torch ``schedule='mega'`` (the stream executors) against the
JAX package, on the CPU.

On CPU tensors the stream kernels' wrappers take their plain PyTorch
versions, so these tests hold the host stream tables, the plain versions
(the semantics the CUDA kernels are checked against on the card) and the
API routing to the reference through its plain references: the f64 oracles
``stf.factorize_np`` / ``solve_fwd_np`` / ``solve_bwd_np``, its host stream
tables and its ``schedule='scan'`` API.  Inputs are NumPy arrays made from
seeds.  Tolerances: float64 1e-12 (1e-10 relative for solves, as the
reference's own stream test uses); float32 pools 1e-5 of max|ref|, float32
solves rtol 2e-4 — other summation order and f32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.numeric import megakernel as mk_j
from spllt_tpu.numeric.solve import solve_bwd_np, solve_fwd_np
from spllt_tpu.numeric.stf import factorize_np
from spllt_tpu.plan.solve_mega import build_solve_mega_plan as bsmp_j
from spllt_tpu_torch.api import _plans as plans_t
from spllt_tpu_torch.convert import numeric_from_numpy, numeric_to_numpy
from spllt_tpu_torch.numeric import hopper_update as hu_t
from spllt_tpu_torch.numeric import megakernel as mk_t
from spllt_tpu_torch.numeric import solve_mega as sm_t
from spllt_tpu_torch.numeric.assemble import assemble_np, assemble_torch
from spllt_tpu_torch.plan.solve_mega import build_solve_mega_plan as bsmp_t

# the fixtures of tests/test_solve_mega.py
CASES = {
    "poisson2d-10": (lambda m: m.poisson2d(10),
                     dict(ordering="amd", nb=8, nemin=8)),
    "poisson2d-16-nd": (lambda m: m.poisson2d(16),
                        dict(ordering="nd-grid", grid_shape=(16, 16), nb=8,
                             nemin=16)),
    "random-60": (lambda m: m.random_spd(60, 0.05, seed=7),
                  dict(ordering="amd", nb=8, nemin=4)),
    "poisson3d-5": (lambda m: m.poisson3d(5),
                    dict(ordering="nd-grid", grid_shape=(5, 5, 5), nb=16,
                         nemin=8)),
}
API_CASES = ["poisson2d-10", "poisson3d-5"]
BWD_ERR = 1e-13


def bwd_err(a, x, b):
    return np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)


def rhs(a, nrhs, seed=0):
    b = np.random.default_rng(seed).standard_normal((a.n, nrhs))
    return b[:, 0] if nrhs == 1 else b


@pytest.fixture(scope="module", params=list(CASES))
def host(request):
    """Per matrix: both packages' analyses and plans, the f64 oracle factor
    and the port's stream executors on the CPU."""
    gen, kw = CASES[request.param]
    aj, at = gen(sj), gen(st)
    assert np.array_equal(aj.values, at.values)
    symb_j = sj.analyse(aj, sj.Options(mode="stf", prune_tree=False, **kw))
    symb_t = st.analyse(at, st.Options(device="cpu", prune_tree=False, **kw))
    plan_j, fplan_j, splan_j = plans_j(symb_j, symb_j.options)
    plan_t, fplan_t, splan_t = plans_t(symb_t, symb_t.options)
    vals = symb_t.a_perm.values
    oracle = factorize_np(assemble_np(plan_t, vals, dtype=np.float64),
                          fplan_j)
    return dict(name=request.param, kw=kw, a=at, symb_j=symb_j,
                symb_t=symb_t, plan_j=plan_j, fplan_j=fplan_j,
                splan_j=splan_j, plan_t=plan_t, fplan_t=fplan_t, vals=vals,
                oracle=oracle, nb=kw["nb"])


def test_solve_mega_plan_equals_reference(host):
    """plan/solve_mega.py is an exact copy: every field, every run."""
    ref = bsmp_j(host["symb_j"], host["plan_j"])
    got = bsmp_t(host["symb_t"], host["plan_t"])
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    for nm in ("nb", "n", "P", "X", "num_tasks"):
        assert getattr(got, nm) == getattr(ref, nm), nm
    for nm in ("xp_src", "col_to_xp"):
        assert np.array_equal(getattr(got, nm), getattr(ref, nm)), nm
    for nm in ("fwd_runs", "bwd_runs"):
        rr, gr = getattr(ref, nm), getattr(got, nm)
        assert len(rr) == len(gr) > 0
        for i, (r, g) in enumerate(zip(rr, gr)):
            assert r["kind"] == g["kind"], (nm, i)
            assert set(r) == set(g)
            for k in ("wA", "wS", "dst", "aux", "rel", "own"):
                assert r[k].dtype == g[k].dtype, (nm, i, k)
                assert np.array_equal(r[k], g[k]), (nm, i, k)


def test_factor_stream_equals_reference(host):
    """The port's factor stream against the reference's build_mega_stream
    with group=1 and no chunking (then the reference pads nothing): the same
    tasks in the same order, run starts where the reference drains."""
    nb, fp = host["nb"], host["fplan_t"]
    rows = (fp.nblocks + 1) * nb
    chunks = mk_j.build_mega_stream(host["fplan_j"], 1, rows, kmax=10 ** 9)
    assert len(chunks) == 1
    ref = chunks[0]
    got = mk_t.build_mega_stream(fp, rows)
    k = len(got["dst"])
    assert len(ref["kind"]) == k > 0
    run_of = np.repeat(np.arange(len(got["run_kind"])),
                       np.diff(got["run_ptr"]))
    assert np.array_equal(ref["kind"], got["run_kind"][run_of])
    assert np.array_equal(np.flatnonzero(ref["drain"]), got["run_ptr"][:-1])
    for nm in ("wr", "wc"):
        assert np.array_equal(ref[nm], got[nm]), nm
    upd = ref["kind"] == mk_j.KIND_UPD
    assert upd.sum() == len(got["relr"]) > 0
    # UPD aux carries blkn in its low bits, POTRF / TRSM aux is kv
    blkn = ref["aux"] & ((1 << mk_j._BLKN_BITS) - 1)
    assert np.array_equal(np.where(upd, blkn, ref["aux"]), got["aux"])
    for nm in ("relr", "relc"):
        assert np.array_equal(ref[nm][upd].astype(np.int32), got[nm]), nm
    # the reference names a UPD task's destination only on the task that
    # completes its segment (the others point at the scratch tile)
    sact = ((ref["aux"] >> mk_j._SACT_BIT) & 1).astype(bool)
    named = ~upd | sact
    assert np.array_equal(ref["dst"][named], got["dst"][named])
    nseg = 0
    for r in np.flatnonzero(got["run_kind"] == mk_t.KIND_UPD):
        seg = got["seg_ptr"][got["run_seg"][r]:got["run_seg"][r + 1]]
        assert seg[0] == got["run_ptr"][r] and seg[-1] == got["run_ptr"][r + 1]
        nseg += len(seg) - 1
        for s0, s1 in zip(seg[:-1], seg[1:]):
            assert s1 > s0 and len(set(got["dst"][s0:s1])) == 1
            assert sact[s1 - 1] and not sact[s0:s1 - 1].any()
    assert sact[upd].sum() == nseg > 0
    # srcn, the port's own field: beyond it the source rows are zero
    poolf = host["oracle"].reshape(-1, nb)
    for t in np.flatnonzero(upd):
        r = got["relr"][t - got["run_rel"][run_of[t]]]
        src = poolf[got["wr"][t] + r[r >= 0]]
        assert not src[:, got["srcn"][t]:].any(), t


def test_mega_factor_executor_f64_equals_oracle(host):
    fp, nb = host["fplan_t"], host["nb"]
    ex = mk_t.MegaFactorExecutor(fp, dtype=torch.float64, device="cpu")
    pool = assemble_torch(host["plan_t"], host["vals"], torch.float64, "cpu")
    out, notpos = ex(pool)
    assert out is pool and not bool(notpos)
    np.testing.assert_allclose(out.numpy(), host["oracle"], rtol=0,
                               atol=1e-12 * np.abs(host["oracle"]).max())
    assert not out[-1].any()                  # trailing block stays zero
    # the wrapper on CPU tensors is the plain version
    again = assemble_torch(host["plan_t"], host["vals"], torch.float64, "cpu")
    mk_t.mega_factorize_plain(again.view(-1, nb), ex.stream)
    assert torch.equal(again, out)
    with pytest.raises(ValueError):
        ex(pool[:-1])
    with pytest.raises(ValueError):
        ex(pool.float())


@pytest.mark.parametrize("nrhs", [1, 3, 65])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_mega_solve_executor_equals_oracle(host, dtype, nrhs):
    """fwd / bwd / full against solve_fwd_np / solve_bwd_np on the oracle's
    factor."""
    n = host["symb_t"].n
    pool = np.concatenate([host["oracle"][:host["plan_t"].nblocks],
                           np.zeros((1,) + host["oracle"].shape[1:])])
    ex = sm_t.MegaSolveExecutor(host["symb_t"], host["plan_t"], nrhs,
                                dtype=dtype, device="cpu")
    x = np.zeros((n + 1, nrhs))
    x[:n] = np.random.default_rng(3).standard_normal((n, nrhs))
    y_ref = solve_fwd_np(pool, host["splan_j"], x.copy())
    z_ref = solve_bwd_np(pool, host["splan_j"], y_ref.copy())
    pool_t = torch.as_tensor(pool, dtype=dtype)
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == torch.float64 else \
        dict(rtol=2e-4, atol=2e-5 * np.abs(z_ref).max())
    y = ex.fwd(pool_t, x)
    assert y.shape == (n + 1, nrhs) and y.dtype == dtype
    np.testing.assert_allclose(y.numpy()[:n], y_ref[:n], **tol)
    z = ex.bwd(pool_t, y_ref)
    np.testing.assert_allclose(z.numpy()[:n], z_ref[:n], **tol)
    zf = ex.full(pool_t, x)
    np.testing.assert_allclose(zf.numpy()[:n], z_ref[:n], **tol)
    assert not zf[n].any()                    # the dump row stays zero
    with pytest.raises(ValueError):
        ex.fwd(pool_t, x[:-1])


def test_stream_tables_reject_bad_input():
    nb, rows = 8, 48
    z = np.zeros(2, np.int64)
    rel = np.zeros((2, nb), np.int32)
    good = dict(wr=z, wc=z, dst=np.array([8, 16]), aux=z + nb, srcn=z + nb)
    mk_t.assemble_stream([(mk_t.KIND_UPD, good, rel, rel)], nb, rows)
    for key, val in (("dst", np.array([16, 8])),            # unsorted
                     ("dst", np.array([8, 17])),            # not a tile
                     ("wc", np.array([0, rows - nb + 1])),  # window past end
                     ("aux", z + nb + 1),
                     ("srcn", z - 1)):
        with pytest.raises(ValueError):
            mk_t.assemble_stream(
                [(mk_t.KIND_UPD, dict(good, **{key: val}), rel, rel)], nb,
                rows)
    for bad in (np.full((2, nb), nb, np.int32), np.full((2, nb), -2)):
        with pytest.raises(ValueError):
            mk_t.assemble_stream([(mk_t.KIND_UPD, good, bad, rel)], nb, rows)
    with pytest.raises(ValueError):
        mk_t.assemble_stream([(7, good, rel, rel)], nb, rows)
    run = dict(kind=0, wA=z, wS=np.array([0, 8]), dst=np.array([16, 24]),
               aux=z, rel=rel)
    sm_t.solve_stream([run], nb, rows, 40)
    for key, val in (("dst", np.array([24, 16])), ("wS", np.array([0, 9])),
                     ("dst", np.array([16, 40])), ("wA", z + rows),
                     ("rel", np.full((2, nb), nb)), ("kind", 9)):
        with pytest.raises(ValueError):
            sm_t.solve_stream([dict(run, **{key: val})], nb, rows, 40)


@pytest.mark.parametrize("nb", [48, 128, 256])
def test_update_edge_case_tasks(nb):
    """The hand-made update tasks of the card's edge-stream checks are valid
    tables with the cases they name, and the factor stream's plain version
    on them equals the update written out in NumPy (float64, 1e-12)."""
    rows = 12 * nb
    tasks = hu_t.edge_case_tasks(nb, rows, seed=nb)
    dev = hu_t.tasks_to_device(tasks, nb, rows, "cpu")      # validates
    assert dev["seg_ptr"].tolist() == [0, 11, 12, 15, 16]
    live_r = (tasks["relr"] >= 0).sum(1)
    live_c = ((tasks["relc"] >= 0)
              & (np.arange(nb)[None] < tasks["blkn"][:, None])).sum(1)
    assert live_r[0] >= 16                 # a live row for every warp
    assert live_r[1] == live_c[1] == 1
    assert len(set(tasks["relr"][2][tasks["relr"][2] >= 0])) == 1
    # an all-masked task in the middle of the 11-task segment
    assert live_r[5] == 0 and live_r[4] > 0 and live_r[6] > 0
    assert tasks["dst"][0] == tasks["dst"][5] == tasks["dst"][10]
    assert {0, 1, 15, 16, 17, nb} <= set(tasks["srcn"][:11].tolist())
    assert (tasks["blkn"] < nb).any()
    assert min(tasks["lor"].min(), tasks["loc"].min()) >= 4 * nb
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((rows, nb))
    stream = mk_t.stream_to_device(mk_t.assemble_stream([
        (mk_t.KIND_UPD, {"wr": tasks["lor"], "wc": tasks["loc"],
                         "dst": tasks["dst"].astype(np.int64) * nb,
                         "aux": tasks["blkn"], "srcn": tasks["srcn"]},
         tasks["relr"], tasks["relc"])], nb, rows), "cpu")
    got = mk_t.mega_factorize(torch.as_tensor(pool.copy()), stream).numpy()
    ref = pool.copy()
    ar = np.arange(nb)
    for t in range(len(tasks["dst"])):
        kn, relr, relc = tasks["srcn"][t], tasks["relr"][t], tasks["relc"][t]
        r = np.where((relr >= 0)[:, None],
                     pool[tasks["lor"][t] + np.maximum(relr, 0), :kn], 0)
        c = np.where(((relc >= 0) & (ar < tasks["blkn"][t]))[:, None],
                     pool[tasks["loc"][t] + np.maximum(relc, 0), :kn], 0)
        d0 = tasks["dst"][t] * nb
        ref[d0:d0 + nb] -= r @ c.T
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("nrhs", [1, 3, 65])
def test_solve_work_items_cover_each_output_once(host, nrhs):
    """The kernel's work items (as work_items mirrors them, with the runs'
    splits) cover every destination row and rhs column of every run exactly
    once: ADDG groups of segments, MM/MMT segments x chunks x bands, SOL/SOLT
    tiles x chunks; runs with few items are split, the others not."""
    nb = host["nb"]
    smp = bsmp_t(host["symb_t"], host["plan_t"])
    rows = (host["plan_t"].nblocks + 1) * nb
    for runs in (smp.fwd_runs, smp.bwd_runs):
        stream = sm_t.solve_stream(runs, nb, rows, smp.P + smp.X)
        dev = sm_t.stream_to_device(stream, "cpu")
        for itemsize in (4, 8):
            items = sm_t.work_items(dev, nrhs, itemsize)
            for r, kind in enumerate(stream["run_kind"]):
                nseg = stream["run_seg"][r + 1] - stream["run_seg"][r] - 1
                n = (stream["run_ptr"][r + 1] - stream["run_ptr"][r]
                     if kind >= sm_t.KIND_SOL else nseg)
                split = stream["run_split"][r]
                assert split == (4 if 4 * n <= sm_t.BLOCKS else 2
                                 if 2 * n <= sm_t.BLOCKS else 1) or \
                    kind == sm_t.KIND_ADDG
                cover = np.zeros((n, nb, nrhs), np.int64)
                for first, count, c0, rc, row0, nrow in items[r]:
                    assert 0 < rc <= 64 and 0 < nrow <= 128
                    cover[first:first + count, row0:row0 + nrow,
                          c0:c0 + rc] += 1
                assert (cover == 1).all(), (r, kind)


def solve_stream_np(pool, work, runs, nb):
    """The solve stream's semantics written out in NumPy (float64): the
    oracle of the plain version on hand-made streams."""
    work = work.copy()
    for run in runs:
        kind = run["kind"]
        for t in range(len(run["dst"])):
            src = work[run["wS"][t]:run["wS"][t] + nb]
            d = slice(run["dst"][t], run["dst"][t] + nb)
            blk = pool[run["wA"][t]:run["wA"][t] + nb]
            if kind == sm_t.KIND_ADDG:
                rel = run["rel"][t]
                work[d] += np.where((rel >= 0)[:, None], src[rel], 0.0)
            elif kind in (sm_t.KIND_MM, sm_t.KIND_MMT):
                work[d] -= (blk.T if kind == sm_t.KIND_MMT else blk) @ src
            else:
                kv = run["aux"][t]
                m = np.tril(blk) * (np.arange(nb) < kv)[None, :]
                m[kv:, kv:] = np.eye(nb - kv)
                y = np.linalg.solve(m.T if kind == sm_t.KIND_SOLT else m,
                                    src)
                work[run["wS"][t]:run["wS"][t] + nb] = y
                work[d] = y
    return work


@pytest.mark.parametrize("nrhs", [1, 65])
@pytest.mark.parametrize("nb", [16, 48])
def test_solve_edge_case_runs(nb, nrhs):
    """The hand-made solve streams of the card's edge checks (kv at the
    edges of the 32-column substitution panels, segments of 1 to 3 tasks,
    each run reading what the one before wrote) are valid tables, and the
    plain version on them equals the NumPy oracle (float64, 1e-10)."""
    runs, kvs, nblk, wrows = sm_t.edge_case_runs(nb, seed=nb)
    assert kvs[0] == 0 and kvs[-1] == nb and (nb < 33 or 33 in kvs)
    rng = np.random.default_rng(nb + nrhs)
    pool = rng.standard_normal((nblk, nb, nb))
    for i, kv in enumerate(kvs):         # factored diagonal tiles
        pool[i] = np.tril(pool[i]) * (np.arange(nb) < kv)[None, :]
        pool[i][np.arange(kv), np.arange(kv)] = 2.0 + rng.random(kv)
    pool = pool.reshape(-1, nb)
    work = rng.standard_normal((wrows, nrhs))
    ref = solve_stream_np(pool, work, runs, nb)
    stream = sm_t.stream_to_device(
        sm_t.solve_stream(runs, nb, nblk * nb, wrows), "cpu")
    got = sm_t.mega_solve(torch.as_tensor(pool), torch.as_tensor(work),
                          stream)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


# --------------------------------------------------------------------- #
# the slice as a whole, through the public API of both packages
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=API_CASES)
def case(request):
    """Per matrix: the reference's f64 schedule='scan' factor and the port's
    f64 and f32 schedule='mega' factors on the CPU."""
    gen, kw = CASES[request.param]
    aj, at = gen(sj), gen(st)
    num_j = sj.factor(sj.analyse(aj, sj.Options(
        mode="batched", schedule="scan", dtype="float64",
        pallas_updates="off", **kw)))
    symb_t = st.analyse(at, st.Options(device="cpu", dtype="float64",
                                       schedule="mega", **kw))
    num_t64 = st.factor(symb_t)
    num_t32 = st.factor(symb_t, options=dataclasses.replace(
        symb_t.options, dtype="float32"))
    return dict(name=request.param, kw=kw, aj=aj, at=at, num_j=num_j,
                symb_t=symb_t, num_t64=num_t64, num_t32=num_t32)


def executors(symb, num):
    fex = [v for k, v in symb._cache.items()
           if k[0] == "fex" and k[3] == num.options.dtype]
    return [type(v).__name__ for v in fex], \
        sorted({type(v).__name__ for v in num._solve_execs.values()})


def test_api_mega_factor_pools(case):
    """f64 against the reference's schedule='scan' f64 factor (1e-12 of
    max|ref|); f32 against its f32 scan factor (1e-5 of max|ref|); the
    stream executor is the one that ran."""
    ref = np.asarray(case["num_j"].pool)
    got = case["num_t64"].pool
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert executors(case["symb_t"], case["num_t64"])[0] == \
        ["MegaFactorExecutor"]
    num_j32 = sj.factor(sj.analyse(case["aj"], sj.Options(
        mode="batched", schedule="scan", dtype="float32",
        pallas_updates="off", **case["kw"])))
    ref32 = np.asarray(num_j32.pool)
    got32 = case["num_t32"].pool.numpy()
    assert got32.dtype == np.float32 and got32.shape == ref32.shape
    assert np.abs(got32 - ref32).max() <= 1e-5 * np.abs(ref32).max()
    # 'mega' and the level executors do not share a cache slot; 'scan' and
    # 'unrolled' do
    symb = case["symb_t"]
    before = set(symb._cache)
    n_scan = st.factor(symb, options=dataclasses.replace(
        symb.options, schedule="scan"))
    new = set(symb._cache) - before
    assert {k[0] for k in new} == {"fex", "sex"}
    assert all(type(symb._cache[k]).__name__ == "ScanFactorExecutor"
               for k in new if k[0] == "fex")
    keys = set(symb._cache)
    st.factor(symb, options=dataclasses.replace(symb.options,
                                                schedule="unrolled"))
    assert set(symb._cache) == keys
    assert np.abs(n_scan.pool.numpy() - ref).max() <= \
        1e-12 * np.abs(ref).max()


def reference_solve(case, job, nrhs):
    """The reference's unrefined solution of ``rhs(a, nrhs, seed=job)``.
    The right-hand sides of nrhs 1 and 3 are solved as one block of four
    columns (the columns are independent), so each job compiles once."""
    cache = case.setdefault("ref_solves", {})
    if job not in cache:
        b1, b3 = rhs(case["at"], 1, seed=job), rhs(case["at"], 3, seed=job)
        x = sj.solve(case["num_j"], np.column_stack([b1, b3]), job=job,
                     refine=0)
        cache[job] = {1: x[:, 0], 3: x[:, 1:]}
    return cache[job][nrhs]


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("job", [0, 1, 2])
def test_api_mega_solve_jobs_match_reference(case, job, nrhs):
    """Unrefined solves of the port (f64, stream executor) against the
    reference's scan path: 1e-10; shapes [n] and [n, nrhs] are kept."""
    b = rhs(case["at"], nrhs, seed=job)
    ref = reference_solve(case, job, nrhs)
    got = st.solve(case["num_t64"], b, job=job, refine=0)
    assert got.shape == b.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(ref).max()))
    assert executors(case["symb_t"], case["num_t64"])[1] == \
        ["MegaSolveExecutor"]


@pytest.mark.parametrize("nrhs", [1, 3])
def test_api_mega_refined_solve(case, nrhs):
    """f32 stream factor + 2 refinement steps: ≤ 1e-13, and equal to the
    reference's refined solution to 1e-11."""
    b = rhs(case["at"], nrhs, seed=7)
    x = st.solve(case["num_t32"], b)                  # refine=2 default
    assert x.shape == b.shape
    assert bwd_err(case["at"], x, b) <= BWD_ERR
    assert bwd_err(case["at"], st.solve(case["num_t32"], b, refine=0),
                   b) > BWD_ERR
    ref = sj.solve(case["num_j"], b)
    np.testing.assert_allclose(x, ref, rtol=0,
                               atol=1e-11 * np.abs(ref).max())
    assert executors(case["symb_t"], case["num_t32"]) == \
        (["MegaFactorExecutor"], ["MegaSolveExecutor"])
    x0 = st.solve(case["num_t32"], b, refine=0)
    x12 = st.solve(case["num_t32"], st.solve(case["num_t32"], b, job=1),
                   job=2)
    np.testing.assert_allclose(x12, x0, rtol=0,
                               atol=1e-5 * np.abs(x0).max())


def test_api_mega_refactorize_reuses_streams_and_executors(case):
    symb, a, num = case["symb_t"], case["at"], case["num_t32"]
    b = rhs(a, 3, seed=9)
    st.solve(num, b)                       # the solve plan and executor exist
    cache_ids = {k: id(v) for k, v in symb._cache.items()}
    assert ("smplan", num.plan.nb) in symb._cache
    fex = next(v for k, v in symb._cache.items()
               if k[0] == "fex" and k[1] == "mega" and k[3] == "float32")
    stream_id = id(fex.stream)
    rng = np.random.default_rng(3)
    diag = a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr))
    vals = a.values * (1.0 + 0.2 * rng.random(a.values.shape))
    vals[diag] = a.values[diag] * 1.5
    a2 = st.CscMatrix(a.n, a.colptr, a.rowind, vals)
    num2 = st.factor(symb, a2, options=num.options)
    ex_before = dict(num._solve_execs)
    assert bwd_err(a2, st.solve(num2, b), b) <= BWD_ERR
    assert {k: id(v) for k, v in symb._cache.items()} == cache_ids
    assert id(fex.stream) == stream_id
    assert num2.plan is num.plan and num2.fplan is num.fplan
    assert num2._solve_execs is num._solve_execs
    for k, ex in ex_before.items():
        assert num2._solve_execs[k] is ex
    xj = sj.solve(sj.factor(case["num_j"].symb,
                            sj.CscMatrix(a.n, a.colptr, a.rowind, vals)), b)
    np.testing.assert_allclose(st.solve(num2, b), xj, rtol=0,
                               atol=1e-11 * np.abs(xj).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_mega_errors(case, dtype):
    """Pattern mismatch → ValueError; indefinite → NotPositiveDefiniteError
    (the NaN of a failed tile reaches the executor's guard)."""
    a, symb = case["at"], case["symb_t"]
    opts = dataclasses.replace(symb.options, dtype=dtype)
    with pytest.raises(ValueError, match="pattern"):
        st.factor(symb, st.sparse.generators._grid_laplacian((a.n,)),
                  options=opts)
    vals = a.values.copy()
    diag = np.flatnonzero(
        a.rowind == np.repeat(np.arange(a.n), np.diff(a.colptr)))
    vals[diag[a.n // 2]] = -1.0
    with pytest.raises(st.NotPositiveDefiniteError):
        st.factor(symb, st.CscMatrix(a.n, a.colptr, a.rowind, vals),
                  options=opts)
    with pytest.raises(sj.NotPositiveDefiniteError):
        sj.factor(case["num_j"].symb,
                  sj.CscMatrix(a.n, a.colptr, a.rowind, vals))


def test_api_mega_convert_round_trip(case):
    """A stream-factored pool crosses to the reference and back through
    NumPy arrays only; same x either way (1e-12)."""
    b = rhs(case["at"], 3, seed=11)
    num_j, num_t = case["num_j"], case["num_t64"]
    x_ref = sj.solve(num_j, b, refine=0)
    pool_np, vals = numeric_to_numpy(num_t)
    assert isinstance(pool_np, np.ndarray) and pool_np.dtype == np.float64
    assert np.array_equal(vals, num_j.values_perm)
    x_back = sj.solve(dataclasses.replace(num_j, pool=pool_np,
                                          values_perm=vals), b, refine=0)
    np.testing.assert_allclose(x_back, x_ref, rtol=0,
                               atol=1e-12 * np.abs(x_ref).max())
    num_c = numeric_from_numpy(case["symb_t"], np.asarray(num_j.pool),
                               num_j.values_perm, num_t.options)
    x_c = st.solve(num_c, b, refine=0)
    np.testing.assert_allclose(x_c, x_ref, rtol=0,
                               atol=1e-12 * np.abs(x_ref).max())
    assert type(num_c._solve_execs[(3,)]).__name__ == "MegaSolveExecutor"
    assert bwd_err(case["at"], st.solve(num_c, b), b) <= BWD_ERR


@pytest.mark.cuda
def test_cuda_stream_kernels_match_plain_versions():
    """On a machine with an NVIDIA GPU and nvcc: the factor stream kernel
    and the solve stream kernel against their plain versions on poisson3d(8)
    at nb=128, and the factor stream and the update kernel on the
    hand-made update tasks at nb=128, with 1, 3 and all blocks (float32
    1e-5, float64 1e-11 of max|ref|; of the size of the update for the
    update tasks).  ``python3 chip_smoke.py`` runs the same comparisons at
    the main path's shapes and on more edge streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    a = st.poisson3d(8)
    symb = st.analyse(a, st.Options(ordering="nd-grid", grid_shape=(8, 8, 8),
                                    nb=128, nemin=192))
    plan, fplan, _ = plans_t(symb, symb.options)
    rows = (plan.nblocks + 1) * 128
    smp = bsmp_t(symb, plan)
    stream = mk_t.stream_to_device(mk_t.build_mega_stream(fplan, rows),
                                   "cuda")
    erows = 12 * 128
    etasks = hu_t.edge_case_tasks(128, erows, seed=128)
    estream = mk_t.stream_to_device(mk_t.assemble_stream([
        (mk_t.KIND_UPD, {"wr": etasks["lor"], "wc": etasks["loc"],
                         "dst": etasks["dst"].astype(np.int64) * 128,
                         "aux": etasks["blkn"], "srcn": etasks["srcn"]},
         etasks["relr"], etasks["relc"])], 128, erows), "cuda")
    edev = hu_t.tasks_to_device(etasks, 128, erows, "cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-11)):
        pool0 = assemble_torch(plan, symb.a_perm.values, dtype, "cuda")
        ref = mk_t.mega_factorize_plain(pool0.clone().view(-1, 128), stream)
        epool = torch.randn(erows, 128, dtype=dtype, device="cuda")
        eref = mk_t.mega_factorize_plain(epool.clone(), estream)
        escale = (eref - epool).abs().max()
        efull = mk_t.mega_factorize(epool.clone(), estream)
        for mb in (1, 3, 0):
            got = mk_t.mega_factorize(pool0.clone().view(-1, 128), stream,
                                      max_blocks=mb)
            assert float((got - ref).abs().max() / ref.abs().max()) <= tol
            got = mk_t.mega_factorize(epool.clone(), estream, max_blocks=mb)
            assert float((got - eref).abs().max() / escale) <= tol
            assert torch.equal(got, efull)
        got = hu_t.apply_updates(epool.clone(), edev)
        assert float((got - hu_t.apply_updates_plain(epool.clone(), edev))
                     .abs().max() / escale) <= tol
        w0 = torch.randn(smp.P + smp.X, 5, dtype=dtype, device="cuda")
        w0[:smp.P] = 0
        for runs in (smp.fwd_runs, smp.bwd_runs):
            st_d = sm_t.stream_to_device(
                sm_t.solve_stream(runs, 128, rows, smp.P + smp.X), "cuda")
            wref = sm_t.mega_solve_plain(ref, w0.clone(), st_d)
            for mb in (1, 3, 0):
                got = sm_t.mega_solve(ref, w0.clone(), st_d, max_blocks=mb)
                assert float((got - wref).abs().max()
                             / wref.abs().max()) <= tol
