"""The port's multi-device paths (spllt_tpu_torch.parallel) on CPU shards,
held against the reference's host code (spllt_tpu.parallel, NumPy only:
its shard_map executors are not run here) and its float64 oracles.

Poisson 16x16, nb 8, nemin 4, nd-grid ordering with tree pruning; the
reference's tables are compared with their padding (scratch-block tasks,
NOOP steps, padded assembly slots) dropped.
"""

import functools

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.numeric.assemble import assemble_np
from spllt_tpu.numeric.stf import factorize_np
from spllt_tpu.parallel import forest as forest_j
from spllt_tpu_torch.api import _plans as plans_t
from spllt_tpu_torch.api import _solve_mega_plan
from spllt_tpu_torch.convert import (numeric_from_numpy, numeric_to_numpy,
                                     shards_from_numpy, shards_to_numpy)
from spllt_tpu_torch.parallel import device_list
from spllt_tpu_torch.parallel import forest as forest_t
from spllt_tpu_torch.parallel.forest_mega import split_solve_runs
from spllt_tpu_torch.parallel.rhs import solve_rhs_sharded

M = 16
KW = dict(ordering="nd-grid", grid_shape=(M, M), nb=8, nemin=4,
          prune_tree=True)
NDEVS = [1, 2, 3, 4]


@functools.lru_cache(maxsize=None)
def problem(ndev: int):
    """(reference symb, plans, forest plan; port symb, plans, forest plan)
    of the Poisson matrix partitioned over ``ndev``."""
    a = sj.poisson2d(M)
    symb_j = sj.analyse(a, sj.Options(ndevices=ndev, **KW))
    plan_j, fplan_j, splan_j = plans_j(symb_j, symb_j.options)
    md_j = forest_j.build_multidevice_factor(symb_j, plan_j, fplan_j, ndev,
                                             splan=splan_j)
    symb_t = st.analyse(st.poisson2d(M),
                        st.Options(ndevices=ndev, device="cpu", **KW))
    plan_t, fplan_t, splan_t = plans_t(symb_t, symb_t.options)
    md_t = forest_t.build_multidevice_factor(symb_t, plan_t, fplan_t, ndev,
                                             splan=splan_t)
    return (symb_j, plan_j, fplan_j, md_j), (symb_t, plan_t, fplan_t, md_t)


@functools.lru_cache(maxsize=None)
def oracle(ndev: int) -> np.ndarray:
    """The reference's float64 factor of the matrix (global pool)."""
    symb_j, plan_j, fplan_j, _ = problem(ndev)[0]
    return factorize_np(assemble_np(plan_j, symb_j.a_perm.values,
                                    dtype=np.float64), fplan_j)


def options(ndev, **kw):
    return st.Options(ndevices=ndev, device="cpu", **dict(KW, **kw))


def tuples(table: dict, names) -> list:
    """A port task table as the reference's task tuples (lvl, fields...)."""
    cols = [table["lvl"]] + [table[nm] for nm in names]
    return [tuple(int(v) if np.ndim(v) == 0 else tuple(v.tolist())
                  for v in row) for row in zip(*cols)]


@pytest.mark.parametrize("ndev", NDEVS)
def test_partition_equals_reference(ndev):
    (_, _, _, md_j), (_, _, _, md_t) = problem(ndev)
    pj, pt = md_j.part, md_t.part
    assert pt.ndev == pj.ndev and pt.ntop == pj.ntop
    for nm in ("part_of_node", "blk_dev", "blk_local"):
        assert np.array_equal(getattr(pt, nm), getattr(pj, nm)), nm
    # the port's pools are not padded: ppart is the largest own count
    assert int(pt.nown.max()) == pj.ppart
    assert list(pt.nlocal) == [pj.ntop + c + 1 for c in pt.nown]


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_task_split_equals_reference(ndev):
    """Phase-A and phase-C task lists, srcvec, blk_n and the assembly split
    field by field (the reference's padded assembly slots dropped)."""
    (_, _, _, md_j), (_, _, _, md_t) = problem(ndev)
    for kind, names in forest_t.FACTOR_FIELDS.items():
        for d in range(ndev):
            assert tuples(md_t.a_tasks[kind][d], names) == \
                md_j.a_tasks[kind][d], (kind, d)
        assert tuples(md_t.c_tasks[kind], names) == md_j.c_tasks[kind][0]
    assert np.array_equal(md_t.srcvec_local, md_j.srcvec_local[0])
    for d in range(ndev):
        n_d = int(md_t.part.nlocal[d]) - 1
        assert np.array_equal(md_t.blk_n_local[d][:n_d],
                              md_j.blk_n_local[d][:n_d])
        sel = md_j.asm_val_idx[d] >= 0
        rows, cols, idx = md_t.asm[d]
        assert np.array_equal(rows, md_j.asm_rowflat[d][sel])
        assert np.array_equal(cols, md_j.asm_col[d][sel])
        assert np.array_equal(idx, md_j.asm_val_idx[d][sel])
    for got, want in zip(md_t.top_asm, (md_j.top_rowflat, md_j.top_col,
                                        md_j.top_val_idx)):
        assert np.array_equal(got, want)


def unbucket(buckets, dev, scratch, names, kind):
    """The reference's padded solve bucket tables of one kind as task
    tuples of device ``dev`` (levels from 1, scratch tasks dropped)."""
    out, lvl = [], 1
    for bt in buckets:
        nlev = next(iter(bt.values())).shape[1]
        for li in range(nlev):
            cols = [bt[f"{kind}_{nm}"][dev, li] for nm in names]
            for row in zip(*cols):
                if int(row[0]) != scratch:
                    out.append((lvl + li,) + tuple(
                        int(v) if np.ndim(v) == 0 else tuple(v.tolist())
                        for v in row))
        lvl += nlev
    return out


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_solve_split_equals_reference(ndev):
    (_, _, _, md_j), (_, _, _, md_t) = problem(ndev)
    scratch = md_j.part.nlocal - 1
    for dirn in ("fwd", "bwd"):
        for kind, names in forest_t.SOLVE_FIELDS.items():
            per, top = md_t.s_tasks[dirn][kind]
            for d in range(ndev):
                assert len(per[d]["lvl"]), "a device without solve tasks"
                assert tuples(per[d], names) == unbucket(
                    md_j.fsolve[dirn + "_a"], d, scratch, names, kind)
            assert tuples(top, names) == unbucket(
                md_j.fsolve[dirn + "_c"], 0, scratch, names, kind)


def flat_runs(runs):
    """Runs as (kind, wA, wS, dst, aux, rel) task tuples; wA only where a
    kind reads the pool, aux only for SOL/SOLT, rel only for ADDG."""
    out = []
    for r in runs:
        kind = int(r["kind"])
        for t in range(len(r["wS"])):
            out.append((kind, int(r["wA"][t]) if kind else None,
                        int(r["wS"][t]), int(r["dst"][t]),
                        int(r["aux"][t]) if kind >= 3 else None,
                        tuple(r["rel"][t].tolist()) if kind == 0 else None))
    return out


def flat_chunks(chunks, dev, work_scratch, group):
    """The reference's padded solve chunks (stacked over devices when
    ``dev`` is not None) as the same tuples, NOOP steps and padded slots
    dropped."""
    out = []
    for c in chunks:
        c = {k: (v[dev] if dev is not None else v) for k, v in c.items()}
        kinds = np.repeat(c["kind"], group)
        for t, kind in enumerate(kinds):
            kind = int(kind)
            if kind < 0 or int(c["dst"][t]) == work_scratch:
                continue
            out.append((kind, int(c["wA"][t]) if kind else None,
                        int(c["wS"][t]), int(c["dst"][t]),
                        int(c["aux"][t]) if kind >= 3 else None,
                        tuple(c["rel"][t].astype(int).tolist())
                        if kind == 0 else None))
    return out


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_mega_solve_streams_equal_reference(ndev):
    """The per-device and top solve streams (split by the ``own`` field)
    against the reference's chunked tables."""
    from spllt_tpu.parallel.forest_mega import build_device_solve_mega_streams

    (symb_j, plan_j, _, md_j), (symb_t, plan_t, _, md_t) = problem(ndev)
    group = 2
    smp, fwd, fwd_top, bwd, bwd_top = build_device_solve_mega_streams(
        md_j, symb_j, plan_j, group)
    runs = split_solve_runs(md_t, _solve_mega_plan(symb_t, plan_t))
    ws = smp.P - md_j.nb
    for dirn, per_j, top_j in (("fwd", fwd, fwd_top), ("bwd", bwd, bwd_top)):
        per_t, top_t = runs[dirn]
        for d in range(ndev):
            assert per_t[d], "a device without solve tasks"
            assert flat_runs(per_t[d]) == flat_chunks(per_j, d, ws, group)
        assert flat_runs(top_t) == flat_chunks(top_j, None, ws, group)


@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_forest_factor_matches_oracle(schedule, dtype, ndev):
    """The reconstructed global pool against the reference's float64
    factor, the executors per shard and the top replicated bit for bit."""
    symb_t, _, _, md_t = problem(ndev)[1]
    num = st.factor(symb_t, options=options(ndev, schedule=schedule,
                                            dtype=dtype))
    ref = oracle(ndev)
    g = forest_t.reconstruct_global_pool(num.mdf.md, num.pool)
    tol = 1e-11 if dtype == "float64" else 1e-5
    assert np.abs(g - ref[:len(g)]).max() <= tol * np.abs(ref).max()
    kind = "Mega" if schedule == "mega" else "Scan"
    assert num.mdf.executors()["factor"] == [f"{kind}FactorExecutor"] * ndev
    ntop = md_t.part.ntop
    for p in num.pool[1:]:
        assert torch.equal(p[:ntop], num.pool[0][:ntop])


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_forest_solve_refines_and_reruns_bit_for_bit(schedule):
    """f32 factor + host refinement: bwd_err < 1e-10; jobs 1 then 2 give
    job 0; a second factor and solve are bit for bit the first; a
    refactorization with doubled values halves the solution."""
    a = st.poisson2d(M)
    symb = problem(3)[1][0]
    opts = options(3, schedule=schedule)
    num = st.factor(symb, options=opts)
    b = np.random.default_rng(5).standard_normal((a.n, 3))
    x = st.solve(num, b)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-10
    x0 = st.solve(num, b, refine=0)
    x12 = st.solve(num, st.solve(num, b, job=1), job=2)
    assert np.abs(x12 - x0).max() <= 1e-5 * np.abs(x0).max()
    again = st.factor(symb, options=opts)
    for p, q in zip(again.pool, num.pool):
        assert torch.equal(p, q)
    assert np.array_equal(st.solve(again, b), x)
    a2 = st.CscMatrix(a.n, a.colptr, a.rowind, a.values * 2.0)
    assert np.allclose(st.solve(st.factor(symb, a2, options=opts), b),
                       x / 2.0, atol=1e-8)


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_forest_not_positive_definite_raises(schedule):
    """A negative pivot in the first leaf (a shard's subtree) or in the last
    column (the top) raises NotPositiveDefiniteError: the flags of every
    shard and of the top are OR-ed."""
    a = st.poisson2d(M)
    symb = problem(2)[1][0]
    diag = np.flatnonzero(a.rowind == np.repeat(np.arange(a.n),
                                                np.diff(a.colptr)))
    for col in (symb.perm[0], symb.perm[-1]):
        vals = a.values.copy()
        vals[diag[col]] = -1.0
        with pytest.raises(st.NotPositiveDefiniteError):
            st.factor(symb, st.CscMatrix(a.n, a.colptr, a.rowind, vals),
                      options=options(2, schedule=schedule))


@pytest.mark.parametrize("ndev", [2, 3])
def test_rhs_sharded_matches_single_device(ndev):
    """An odd nrhs over ``ndev`` CPU shards, against the single-device
    solve of the same factor."""
    a = st.poisson2d(M)
    num = st.factor(st.analyse(a, st.Options(device="cpu", **KW)))
    b = np.random.default_rng(7).standard_normal((a.n, 5))
    x = solve_rhs_sharded(num, b, devices=[torch.device("cpu")] * ndev)
    assert x.shape == b.shape
    assert np.allclose(x, st.solve(num, b), atol=1e-8)


def test_missing_cards_raise():
    """'cuda' with ndevices=2 and fewer cards visible: ValueError (the
    rhs-sharded solve likewise); one device without a card: RuntimeError.
    Nothing runs on the CPU instead."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    symb = problem(2)[1][0]
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        st.factor(symb, options=st.Options(ndevices=2, **KW))
    num = st.factor(symb, options=st.Options(device="cpu", **KW))
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        solve_rhs_sharded(num, np.ones(num.symb.n),
                          devices=device_list("cuda", 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            st.factor(symb, options=st.Options(**KW))


def test_explicit_device_list():
    """factor(..., devices=[...]) runs the forest on the devices given (the
    same one repeated here) and refuses a list of another length or off the
    forest path."""
    symb = problem(2)[1][0]
    cpu = torch.device("cpu")
    num = st.factor(symb, options=options(2), devices=[cpu, cpu])
    assert num.mdf.devices == [cpu, cpu]
    for opts, devices in ((options(2), [cpu]), (options(1), [cpu])):
        with pytest.raises(ValueError, match="devices"):
            st.factor(symb, options=opts, devices=devices)


def test_forest_checkpoint_round_trip(tmp_path):
    """save_factor of a forest factor writes its global pool; load_factor
    spreads it over the shards again: pools and solve bit for bit."""
    from spllt_tpu_torch.utils.persist import load_factor, save_factor

    a = st.poisson2d(M)
    symb = st.analyse(a, options(2, schedule="mega"))
    num = st.factor(symb)
    path = str(tmp_path / "f.npz")
    save_factor(path, num)
    num2 = load_factor(path, device="cpu")
    assert num2.mdf is not None
    for p, q in zip(num2.pool, num.pool):
        assert torch.equal(p, q)
    b = np.ones(a.n)
    assert np.array_equal(st.solve(num2, b), st.solve(num, b))


def test_package_exports_equal_reference():
    """The port exports what the reference exports; the rhs-sharded solve
    stays in its module, as in the reference."""
    assert st.__all__ == sj.__all__
    assert not hasattr(st, "solve_rhs_sharded")


def test_stf_ignores_ndevices_as_the_reference():
    kw = dict(nb=8, mode="stf", ndevices=2)
    num_j = sj.factor(sj.analyse(sj.poisson2d(8), sj.Options(**kw)))
    num_t = st.factor(st.analyse(st.poisson2d(8), st.Options(**kw)))
    assert isinstance(num_t.pool, np.ndarray) and num_t.mdf is None
    assert np.array_equal(num_t.pool, np.asarray(num_j.pool))


def test_coarse_subtrees_off_across_devices():
    """coarse_subtrees=True with ndevices=2 plans without the coarse layer
    (as the reference's use_coarse), builds no dense executor and gives
    the factor of coarse_subtrees=False bit for bit."""
    symb = problem(2)[1][0]
    num = st.factor(symb, options=options(2, coarse_subtrees=True))
    assert num.fplan.dense is None
    assert not [k for k in symb._cache if k[0] == "dense"]
    plain = st.factor(symb, options=options(2))
    for p, q in zip(num.pool, plain.pool):
        assert torch.equal(p, q)


def test_sharded_pools_cross_both_ways():
    """The reference's host assembly of the sharded pools, carried in,
    equals the port's own bit for bit; the port's factored shards, carried
    back, reconstruct through the reference's code to the port's own
    global pool; numeric_to_numpy / numeric_from_numpy round trip."""
    ndev = 3
    (_, plan_j, _, md_j), (symb_t, _, _, md_t) = problem(ndev)
    devices = [torch.device("cpu")] * ndev
    vals = symb_t.a_perm.values
    pools_j, top_j = md_j.local_pools(vals, dtype=np.float32)
    pools_t, top_t = md_t.local_pools(vals, torch.float32, devices)
    for p, q in zip(shards_from_numpy(md_t, pools_j, torch.float32, devices),
                    pools_t):
        assert torch.equal(p, q)
    assert np.array_equal(top_t.numpy().reshape(-1, md_t.nb),
                          top_j[:md_t.part.ntop * md_t.nb])

    num = st.factor(symb_t, options=options(ndev))
    g = forest_t.reconstruct_global_pool(md_t, num.pool)
    back = shards_to_numpy(md_t, num.pool)
    assert back.shape == (ndev, md_j.part.nlocal * md_t.nb, md_t.nb)
    assert np.array_equal(
        forest_j.reconstruct_global_pool(md_j, back, plan_j), g)

    pool_np, values = numeric_to_numpy(num)
    assert np.array_equal(pool_np[:-1], g) and not pool_np[-1].any()
    num2 = numeric_from_numpy(symb_t, pool_np, values, options(ndev))
    for p, q in zip(num2.pool, num.pool):
        assert torch.equal(p, q)
