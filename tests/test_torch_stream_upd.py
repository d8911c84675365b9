"""The factor stream's UPD runs (K4) on the packed live-entry tables of the
level path's compact update body (K3), against the JAX package, on the CPU.

The stream carries, per UPD run, the packed entries that
``hopper_update.pack_live_entries`` makes of the run's own maps and the
launch choice of ``dense_level``; the kernel reads nothing else of a UPD
task on the card.  These tests hold those tables against the packing of
the reference's task order (``spllt_tpu.numeric.megakernel.
build_mega_stream``), run by run, and the stream's plain version (what the
CUDA launches are checked against on the card) against the f64 oracle
``stf.factorize_np`` and a NumPy loop over hand-made runs.  Inputs are
NumPy arrays made from seeds.  Tolerances: float64 1e-12 of max|ref|,
float32 1e-5 (other summation order, f32 rounding).
"""

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.numeric import megakernel as mk_j
from spllt_tpu.numeric.stf import factorize_np
from spllt_tpu_torch.numeric import hopper_update as hu_t
from spllt_tpu_torch.numeric import megakernel as mk_t
from spllt_tpu_torch.numeric.assemble import assemble_np

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

NBS = [8, 16]


@pytest.fixture(scope="module", params=NBS, ids=[f"nb{n}" for n in NBS])
def p2d12(request):
    """poisson2d(12) at nb 8 or 16: both packages' plans and the port's
    factor stream."""
    nb = request.param
    kw = dict(ordering="nd-grid", grid_shape=(12, 12), nb=nb, nemin=4)
    aj, at = sj.poisson2d(12), st.poisson2d(12)
    symb_j = sj.analyse(aj, sj.Options(mode="stf", prune_tree=False, **kw))
    symb_t = st.analyse(at, st.Options(device="cpu", prune_tree=False, **kw))
    plan_t, fplan_t, _ = symb_t.cache.block_plans(symb_t, symb_t.options)
    _, fplan_j, _ = plans_j(symb_j, symb_j.options)
    rows = (fplan_t.nblocks + 1) * nb
    return dict(nb=nb, symb_t=symb_t, plan_t=plan_t, fplan_t=fplan_t,
                fplan_j=fplan_j, rows=rows,
                stream=mk_t.build_mega_stream(fplan_t, rows))


def edge_stream(nb, seed):
    """The hand-made UPD runs of ``upd_edge_runs`` and their stream."""
    runs, rows = mk_t.upd_edge_runs(nb, seed)
    return runs, rows, mk_t.assemble_stream(runs, nb, rows)


def upd_runs(stream):
    return [r for r in range(len(stream["run_kind"]))
            if stream["run_kind"][r] == mk_t.KIND_UPD]


def test_packed_tables_equal_the_reference_packed_run_by_run(p2d12):
    """eptr/enr/ent and run_dense of every UPD run equal pack_live_entries
    and dense_level applied to the reference's tasks of that run (its
    maps, blkn and destinations, in its order); POTRF and TRSM tasks have
    no entries."""
    nb, got = p2d12["nb"], p2d12["stream"]
    ref = mk_j.build_mega_stream(p2d12["fplan_j"], 1, p2d12["rows"],
                                 kmax=10 ** 9)[0]
    upd = ref["kind"] == mk_j.KIND_UPD
    blkn = ref["aux"] & ((1 << mk_j._BLKN_BITS) - 1)
    # the reference names a UPD task's destination only on the task that
    # completes its segment: the others take the next such task's
    sact = np.flatnonzero(upd & ((ref["aux"] >> mk_j._SACT_BIT) & 1)
                          .astype(bool))
    dst = ref["dst"].copy()
    dst[upd] = ref["dst"][sact[np.searchsorted(sact, np.flatnonzero(upd))]]
    runs = upd_runs(got)
    assert len(runs) > 2
    for r in range(len(got["run_kind"])):
        t0, t1 = got["run_ptr"][r], got["run_ptr"][r + 1]
        e0, e1 = got["eptr"][t0], got["eptr"][t1]
        if r not in runs:
            assert e0 == e1 and not got["enr"][t0:t1].any()
            assert got["run_dense"][r] == 0
            continue
        eptr, enr, ent = hu_t.pack_live_entries(
            ref["relr"][t0:t1].astype(np.int32),
            ref["relc"][t0:t1].astype(np.int32), blkn[t0:t1], dst[t0:t1],
            nb)
        assert np.array_equal(got["eptr"][t0:t1 + 1] - e0, eptr), r
        assert np.array_equal(got["enr"][t0:t1], enr), r
        assert np.array_equal(got["ent"][e0:e1], ent), r
        nseg = got["run_seg"][r + 1] - got["run_seg"][r] - 1
        assert got["run_dense"][r] == hu_t.dense_level(enr, eptr, nseg, nb)
    assert got["eptr"][-1] == len(got["ent"])


@pytest.mark.parametrize("which", ["p2d12", "edge"])
def test_chain_never_crosses_a_run(p2d12, which):
    """CHAIN is set on a task exactly where the next task of its run has
    the same destination and the same live rows and columns: never on the
    last task of a run, never across two runs."""
    nb = p2d12["nb"]
    if which == "p2d12":
        s = p2d12["stream"]
    else:
        s = edge_stream(nb, nb)[2]
    chained = 0
    for r in upd_runs(s):
        t0, t1 = s["run_ptr"][r], s["run_ptr"][r + 1]
        chain = (s["enr"][t0:t1] & hu_t.CHAIN) != 0
        assert not chain[-1], r
        live = [s["ent"][s["eptr"][t]:s["eptr"][t + 1]] >> 16
                for t in range(t0, t1)]
        nr = s["enr"][t0:t1] % hu_t.CHAIN
        for i in range(t1 - t0 - 1):
            same = (s["dst"][t0 + i] == s["dst"][t0 + i + 1]
                    and nr[i] == nr[i + 1]
                    and np.array_equal(live[i], live[i + 1]))
            assert chain[i] == same, (r, i)
        chained += int(chain.sum())
    assert chained > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_executor_equals_oracle(p2d12, dtype):
    """MegaFactorExecutor on the CPU (the stream's plain version) against
    the f64 oracle factorize_np."""
    nb, plan = p2d12["nb"], p2d12["plan_t"]
    vals = p2d12["symb_t"].a_perm.values
    oracle = factorize_np(assemble_np(plan, vals, dtype=np.float64),
                          p2d12["fplan_j"])
    ex = mk_t.MegaFactorExecutor(p2d12["fplan_t"], dtype=dtype,
                                 device="cpu")
    pool = torch.as_tensor(assemble_np(plan, vals, dtype=np.float64),
                           dtype=dtype)
    got, notpos = ex(pool)
    assert not bool(notpos)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.double().numpy(), oracle, rtol=0,
                               atol=tol * np.abs(oracle).max())


@pytest.mark.parametrize("nb", [8, 48])
def test_upd_edge_runs(nb):
    """The hand-made UPD runs of the card's edge checks have the cases they
    name (identity-map tasks, chains, one-task segments, the second run
    flagged dense), and the stream's plain version on them equals the
    update written out in NumPy, run after run (float64, 1e-12 of the
    update's size)."""
    runs, rows, s = edge_stream(nb, nb)
    assert list(s["run_dense"]) == [0, 1]
    seg = np.diff(s["seg_ptr"][s["run_seg"][0]:s["run_seg"][1]])
    assert (seg == 1).sum() >= 40 and seg.max() == 4
    iden = np.arange(nb)
    assert sum(np.array_equal(r, iden) for r in runs[0][2]) == 6
    assert ((s["enr"] & hu_t.CHAIN) != 0).sum() >= 5
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((rows, nb))
    got = mk_t.mega_factorize(torch.as_tensor(pool.copy()),
                              mk_t.stream_to_device(s, "cpu")).numpy()
    ref = pool.copy()
    for _, tab, relr, relc in runs:
        before = ref.copy()
        for t in range(len(tab["dst"])):
            kn = tab["srcn"][t]
            r = np.where((relr[t] >= 0)[:, None],
                         before[tab["wr"][t] + np.maximum(relr[t], 0), :kn],
                         0)
            c = np.where(((relc[t] >= 0) & (iden < tab["aux"][t]))[:, None],
                         before[tab["wc"][t] + np.maximum(relc[t], 0), :kn],
                         0)
            ref[tab["dst"][t]:tab["dst"][t] + nb] -= r @ c.T
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref - pool).max())


def test_device_stream_keeps_the_maps_on_the_host():
    """On a device other than the CPU the stream's tensors are the kernel's
    tables alone (no relr/relc); the host keeps the maps, which
    plain_maps brings to the device where the plain version runs."""
    nb = 8
    s = edge_stream(nb, 3)[2]
    dev = mk_t.stream_to_device(s, "meta")
    tensors = {k for k, v in dev.items() if isinstance(v, torch.Tensor)}
    assert tensors == set(mk_t._DEV_KEYS)
    assert "relr" not in dev and "run_rel" not in dev
    cpu = mk_t.stream_to_device(s, "cpu")
    for k in ("relr", "relc"):
        assert np.array_equal(dev["host"][k], s[k])
        assert np.array_equal(cpu[k].numpy(), s[k])
        assert np.array_equal(
            mk_t.plain_maps(dev, torch.device("cpu"))[k].numpy(), s[k])


@pytest.mark.cuda
def test_cuda_upd_launches_match_plain_version():
    """On a machine with an NVIDIA GPU and nvcc: the stream's UPD launches
    on the hand-made runs (nb 48 and 128, float32 1e-5 and float64 1e-11 of
    the update's size) against the plain version, and bit for bit between
    two launches.  ``python3 chip_smoke.py`` runs the same check at nb 48,
    128 and 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    for nb in (48, 128):
        _, rows, s = edge_stream(nb, nb)
        stream = mk_t.stream_to_device(s, "cuda")
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-11)):
            pool = torch.randn(rows, nb, dtype=dtype, device="cuda")
            ref = mk_t.mega_factorize_plain(pool.clone(), stream)
            got = mk_t.mega_factorize(pool.clone(), stream)
            again = mk_t.mega_factorize(pool.clone(), stream)
            scale = (ref - pool).abs().max()
            assert float((got - ref).abs().max() / scale) <= tol
            assert torch.equal(got, again)
