"""spllt_tpu_torch host side: import hygiene, host-code copies held equal
to the spllt_tpu originals, Options(device=...) and Options(ndevices=...)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.numeric import assemble as asm_j
from spllt_tpu.numeric import spmv as spmv_j
from spllt_tpu.numeric.pallas_update import build_micro_tasks as bmt_j
from spllt_tpu_torch.numeric import assemble as asm_t
from spllt_tpu_torch.numeric import spmv as spmv_t
from spllt_tpu_torch.numeric.hopper_update import (build_micro_tasks as bmt_t,
                                                   tasks_to_device)

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_FIELDS = {"options"}      # the two packages have their own Options


def assert_same(x, y, path="") -> None:
    """Field-by-field exact equality of (nested) dataclasses / arrays."""
    if dataclasses.is_dataclass(x):
        assert dataclasses.is_dataclass(y), path
        names = [f.name for f in dataclasses.fields(x)]
        assert names == [f.name for f in dataclasses.fields(y)], path
        for nm in names:
            if nm not in SKIP_FIELDS:
                assert_same(getattr(x, nm), getattr(y, nm), f"{path}.{nm}")
    elif isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray) and x.dtype == y.dtype, path
        assert np.array_equal(x, y), path
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), path
        for i, (u, v) in enumerate(zip(x, y)):
            assert_same(u, v, f"{path}[{i}]")
    else:
        assert x == y, path


def test_import_and_cpu_run_without_jax():
    """A fresh interpreter imports the port, factors and solves on the CPU
    (on one device and on two shards), imports the C interface's and the
    conversion's modules, and loads neither jax nor spllt_tpu."""
    code = (
        "import sys, numpy as np\n"
        "before = set(sys.modules)\n"
        "import spllt_tpu_torch as st\n"
        "a = st.poisson2d(6)\n"
        "s = st.analyse(a, st.Options(nb=8, device='cpu'))\n"
        "x = st.solve(st.factor(s), np.ones(a.n))\n"
        "assert np.abs(a.matvec(x) - 1).max() < 1e-12\n"
        "m = st.factor(s, options=st.Options(nb=8, device='cpu', "
        "schedule='mega'))\n"
        "assert np.abs(a.matvec(st.solve(m, np.ones(a.n))) - 1).max() "
        "< 1e-12\n"
        "assert 'spllt_tpu_torch.numeric.solve_mega' in sys.modules\n"
        "assert 'spllt_tpu_torch.numeric.megakernel' in sys.modules\n"
        "f = st.factor(s, options=st.Options(nb=8, device='cpu', "
        "ndevices=2))\n"
        "assert np.abs(a.matvec(st.solve(f, np.ones(a.n))) - 1).max() "
        "< 1e-12\n"
        "import spllt_tpu_torch.capi, spllt_tpu_torch.convert\n"
        "import spllt_tpu_torch.parallel.rhs\n"
        "bad = [m for m in set(sys.modules) - before if m == 'jax' or "
        "m.startswith('jax.') or m == 'spllt_tpu' or "
        "m.startswith('spllt_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize("ordering", ["amd", "nd", "nd-grid"])
def test_analyse_and_plans_equal_reference(ordering):
    kw = dict(ordering=ordering, nb=8, nemin=4,
              grid_shape=(12, 12) if ordering == "nd-grid" else None)
    symb_j = sj.analyse(sj.poisson2d(12), sj.Options(**kw))
    symb_t = st.analyse(st.poisson2d(12), st.Options(device="cpu", **kw))
    assert_same(symb_j, symb_t, "symb")
    for pj, pt, nm in zip(plans_j(symb_j, symb_j.options),
                          symb_t.cache.block_plans(symb_t, symb_t.options),
                          ("plan", "fplan", "splan")):
        assert_same(pj, pt, nm)


def test_host_copies_equal_reference():
    """build_micro_tasks, assemble_np, build_ell / ell_vals copies."""
    kw = dict(ordering="nd", nb=8, nemin=4)
    symb_j = sj.analyse(sj.poisson2d(12), sj.Options(**kw))
    symb_t = st.analyse(st.poisson2d(12), st.Options(device="cpu", **kw))
    plan_j, fplan_j, _ = plans_j(symb_j, symb_j.options)
    plan_t, fplan_t, _ = symb_t.cache.block_plans(symb_t, symb_t.options)
    rows = (plan_t.nblocks + 1) * 8
    poolf = st.factor(symb_t, options=st.Options(
        mode="stf", **kw)).pool.reshape(-1, 8)
    ntasks = 0
    for lvl in range(1, fplan_t.nlevels + 1):
        mj = bmt_j(fplan_j, lvl, lvl, 8, rows)
        mt = bmt_t(fplan_t, lvl, lvl, 8, rows)
        assert set(mt) == set(mj) | {"srcn"}     # the port's one new field
        for k in mj:
            assert mj[k].dtype == mt[k].dtype
            assert np.array_equal(mj[k], mt[k]), (lvl, k)
        # srcn: beyond it the source rows of a factored pool are zero, so
        # the trimmed contraction is the full product
        assert ((mt["srcn"] >= 1) & (mt["srcn"] <= 8)).all()
        for t in range(len(mt["dst"])):
            for lo, rel in ((mt["lor"][t], mt["relr"][t]),
                            (mt["loc"][t], mt["relc"][t])):
                src = poolf[lo + rel[rel >= 0]]
                assert not src[:, mt["srcn"][t]:].any(), (lvl, t)
        # the table checks pass on real plans and add the segment offsets
        dev = tasks_to_device(mt, 8, rows, "cpu")
        seg = dev["seg_ptr"].numpy()
        assert seg[0] == 0 and seg[-1] == len(mt["dst"])
        assert len(seg) - 1 == len(np.unique(mt["dst"]))
        ntasks += len(mt["dst"])
    assert ntasks > 0
    vals = symb_t.a_perm.values
    pool_j = asm_j.assemble_np(plan_j, symb_j.a_perm.values)
    assert np.array_equal(pool_j, asm_t.assemble_np(plan_t, vals))
    pool_d = asm_t.assemble_torch(plan_t, vals, torch.float64, "cpu")
    assert np.array_equal(pool_j, pool_d.numpy())       # exact: one add each
    ell_j, ell_t = spmv_j.build_ell(symb_j.a_perm), spmv_t.build_ell(
        symb_t.a_perm)
    assert_same(ell_j, ell_t, "ell")
    assert np.array_equal(spmv_j.ell_vals(ell_j, vals),
                          spmv_t.ell_vals(ell_t, vals))
    # spmv against the CSC matvec, float64: 1e-13 (sum order differs)
    x = np.random.default_rng(0).standard_normal((symb_t.n + 1, 2))
    x[-1] = 0
    y = spmv_t.spmv(torch.as_tensor(spmv_t.ell_vals(ell_t, vals)),
                    torch.as_tensor(ell_t.idx.astype(np.int64)),
                    torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, symb_t.a_perm.matvec(x[:-1]), rtol=0,
                               atol=1e-13)


def test_tasks_to_device_rejects_bad_tables():
    good = {"dst": np.array([1, 1, 2]), "lor": np.array([0, 8, 16]),
            "loc": np.array([0, 8, 24]), "blkn": np.array([8, 8, 8]),
            "relr": np.zeros((3, 8), np.int32),
            "relc": np.zeros((3, 8), np.int32)}
    tasks_to_device(good, 8, 32, "cpu")
    for key, val in (("dst", np.array([2, 1, 1])),          # unsorted
                     ("loc", np.array([0, 8, 25])),         # window past end
                     ("relr", np.full((3, 8), 8, np.int32)),  # rel >= nb
                     ("relc", np.full((3, 8), -2, np.int32))):
        with pytest.raises(ValueError):
            tasks_to_device(dict(good, **{key: val}), 8, 32, "cpu")


def test_options_device_validation():
    assert st.Options().device is None
    assert st.Options().torch_device == "cuda"
    assert st.Options(device="cpu").torch_device == "cpu"
    assert st.Options(device="cuda:1").torch_device == "cuda:1"
    for bad in ("tpu", "gpu", 0, "xla:0"):
        with pytest.raises(ValueError):
            st.Options(device=bad)
    with pytest.raises(ValueError):
        st.Options(nb=0)
    with pytest.raises(ValueError):
        st.Options(schedule="nope")


def test_default_device_never_falls_back_to_cpu():
    """Default Options ask for CUDA; without a CUDA device factor raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    symb = st.analyse(st.poisson2d(6), st.Options(nb=8))
    with pytest.raises(RuntimeError, match="cuda"):
        st.factor(symb)
    # the stf oracle is host-only and needs no device
    num = st.factor(symb, options=st.Options(nb=8, mode="stf"))
    assert isinstance(num.pool, np.ndarray)


@pytest.mark.parametrize("schedule", ["mega", "scan"])
def test_multidevice_options_factor(schedule):
    """Options(ndevices=2) on device='cpu' runs the forest path on two CPU
    shards with the executors its schedule names, and solves."""
    kind = "Mega" if schedule == "mega" else "Scan"
    opts = st.Options(nb=8, device="cpu", ndevices=2, schedule=schedule)
    a = st.poisson2d(6)
    num = st.factor(st.analyse(a, opts))
    assert [p.device.type for p in num.pool] == ["cpu", "cpu"]
    b = np.ones(a.n)
    x = st.solve(num, b)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-12
    assert num.mdf.executors() == {
        "factor": [f"{kind}FactorExecutor"] * 2,
        "factor_top": f"{kind}FactorExecutor",
        "solve": [f"{kind}SolveExecutor"] * 2,
        "solve_top": f"{kind}SolveExecutor"}


def test_multidevice_cuda_without_cards_raises():
    """Options(ndevices=2) on 'cuda' where fewer cards are visible raises
    ValueError; it never runs on the CPU instead."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    symb = st.analyse(st.poisson2d(6), st.Options(nb=8, device="cpu"))
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        st.factor(symb, options=st.Options(nb=8, ndevices=2))


def test_options_take_every_reference_field():
    """Every field of spllt_tpu.Options constructs in the port with the
    same default, the values the reference refuses are refused, and the
    TPU-only knobs change nothing."""
    ref = {f.name: f for f in dataclasses.fields(sj.Options)}
    got = {f.name: f for f in dataclasses.fields(st.Options)}
    assert set(ref) <= set(got)
    assert set(got) - set(ref) == {"device"}
    dj, dt = sj.Options(), st.Options()
    for name in ref:
        assert getattr(dt, name) == getattr(dj, name), name
        st.Options(**{name: getattr(dj, name)})
    for kw in (dict(pallas_updates="x"), dict(pallas_hmax=4),
               dict(solve_group=0), dict(nb=0), dict(precision="tf32")):
        with pytest.raises(ValueError):
            sj.Options(**kw)
        with pytest.raises(ValueError):
            st.Options(**kw)
    a = st.poisson2d(6)
    symb = st.analyse(a, st.Options(nb=8, device="cpu"))
    base = st.factor(symb).pool
    for kw in (dict(pallas_updates="off"), dict(pallas_hmax=8),
               dict(solve_group=3)):
        num = st.factor(symb, options=st.Options(nb=8, device="cpu", **kw))
        assert torch.equal(num.pool, base), kw


def test_unrolled_maps_to_level_executor():
    a = st.poisson2d(8)
    symb = st.analyse(a, st.Options(nb=8, device="cpu", dtype="float64",
                                    schedule="unrolled"))
    n1 = st.factor(symb)
    n2 = st.factor(symb, options=dataclasses.replace(symb.options,
                                                     schedule="scan"))
    assert torch.equal(n1.pool, n2.pool)
