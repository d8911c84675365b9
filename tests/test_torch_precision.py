"""The reduced-precision operating points of spllt_tpu_torch
(``Options.precision``): 'default' computes the update products of float32
pools in one TF32 pass, on the tensor cores on the card; on the CPU the
update body's plain version forms the same products from the same
TF32-rounded operands.  'high' computes them in IEEE float32, as
'highest' does (as accurate as the TPU's three-pass HIGH).

These tests hold ``round_tf32`` against a NumPy bit-level reference and
against round-to-nearest-ties-away arithmetic, the plain update at each
precision against a float64 product of the rounded operands, and the
factorization at each operating point against the JAX package's float64
oracle ``spllt_tpu.numeric.stf.factorize_np`` (imported inside the fixture,
so the ``cuda`` case runs where JAX is absent).  Inputs are NumPy arrays
made from seeds.  Tolerances are stated at each test.
"""

import numpy as np
import pytest
import torch

import spllt_tpu_torch as st
from spllt_tpu_torch.numeric import hopper_update as hu
from spllt_tpu_torch.numeric import megakernel as mk
from spllt_tpu_torch.numeric.assemble import assemble_np

# One intra-op thread: the suite's xdist workers share the host's CPUs,
# and with a thread per CPU each small op waits on a thread barrier.
torch.set_num_threads(1)

BWD_ERR = 1e-13
NB = 16
# the pool dtype's precision against the float64 oracle: float32 sums and
# pivots (the float32 factor reads ~2e-7 of max|L| here); one TF32 pass
# rounds every update operand to 11 significant bits (2^-11 = 4.9e-4 of
# each product; the factor reads ~2e-4)
FACTOR_TOL = {"highest": 1e-6, "high": 1e-6, "default": 1e-3}
RUNS = [("high", 2), ("default", 6)]


def tf32_bits_np(x: np.ndarray) -> np.ndarray:
    """The bit-level reference: on the uint32 view add 0x1000 and clear
    the low 13 bits, except where the exponent is all ones (inf, nan)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    special = (u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(special, u, r).view(np.float32)


def special_floats() -> np.ndarray:
    """Ties of both signs (a remainder of exactly 0x1000), remainders one
    below and one above, subnormals, zeros, the largest float, inf and nan
    (with payloads), as float32."""
    base = np.array([0x3F800000, 0x40490000, 0x00800000, 0x7F000000],
                    np.uint32)
    bits = []
    for b in base:
        for rem in (0x0000, 0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x3000):
            bits += [b | rem, (b | rem) | 0x80000000]
    bits += [0x00000001, 0x00000FFF, 0x00001000, 0x00001001, 0x007FF000,
             0x007FFFFF, 0x80001000, 0x807FFFFF,          # subnormals
             0x00000000, 0x80000000,                      # zeros
             0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FE000, 0x7F7FEFFF,  # largest
             0x7F800000, 0xFF800000,                      # inf
             0x7FC00000, 0x7F800001, 0xFFC01234, 0x7FFFFFFF]  # nan
    return np.array(bits, np.uint32).view(np.float32)


def test_round_tf32_matches_the_bit_level_reference():
    """Every bit of round_tf32 equals the NumPy reference on the special
    values and on 10 000 random bit patterns (nan payloads included)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([special_floats(), rng.integers(
        0, 2 ** 32, 10_000, dtype=np.uint64).astype(np.uint32)
        .view(np.float32)])
    got = hu.round_tf32(torch.as_tensor(x)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          tf32_bits_np(x).view(np.uint32))
    with pytest.raises(ValueError):
        hu.round_tf32(torch.zeros(2, dtype=torch.float64))


def test_round_tf32_is_round_to_nearest_ties_away():
    """On normal numbers round_tf32 is the nearest multiple of the TF32
    unit 2^(e - 10), ties away from zero (computed in float64); ties of
    both signs go away from zero, the largest float rounds to inf, inf and
    nan stay."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(20_000)
         * 10.0 ** rng.integers(-30, 30, 20_000)).astype(np.float32)
    q = np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float64))[1] - 11)
    want = np.sign(x) * np.floor(np.abs(x) / q + 0.5) * q
    got = hu.round_tf32(torch.as_tensor(x)).numpy().astype(np.float64)
    assert np.array_equal(got, want)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11],
                    np.float32)
    assert hu.round_tf32(torch.as_tensor(ties)).tolist() == \
        [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10]
    ends = np.array([np.finfo(np.float32).max, np.inf, -np.inf, np.nan],
                    np.float32)
    out = hu.round_tf32(torch.as_tensor(ends)).numpy()
    assert np.isposinf(out[0]) and np.isposinf(out[1]) \
        and np.isneginf(out[2]) and np.isnan(out[3])


def edge_tables(nb: int, seed: int):
    """K3's hand-made edge tables at nb (compact, and edge_case where nb
    reaches its srcn of 17), each with a random float32 pool of the rows it
    needs."""
    rng = np.random.default_rng(seed)
    tables = [("compact", *hu.compact_edge_tasks(nb, seed))]
    if nb >= 17:
        tables.append(("edge_case", hu.edge_case_tasks(nb, 16 * nb, seed),
                       16 * nb))
    return [(name, tasks, hu.tasks_to_device(tasks, nb, rows, "cpu"),
             torch.as_tensor(rng.standard_normal((rows, nb)),
                             dtype=torch.float32))
            for name, tasks, rows in tables]


def update_of(pool, t, precision):
    """The plain version's update (what it subtracts), float64."""
    got = hu.apply_updates_plain(pool.clone(), t, precision)
    return (pool.double() - got.double()).numpy()


@pytest.mark.parametrize("nb", [8, 32])
def test_plain_update_high_is_float32_accurate(nb):
    """'high' is the IEEE float32 update: within 1e-6 of max|update| of
    'highest', and in fact bit for bit the same."""
    for name, _, t, pool in edge_tables(nb, 3):
        ref = update_of(pool, t, "highest")
        got = update_of(pool, t, "high")
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), name
        assert np.array_equal(got, ref), name


def tf32_update_np(tasks: dict, pool: np.ndarray) -> np.ndarray:
    """What the TF32 body subtracts, per the kernel's semantics, as a
    float64 product of the TF32-rounded float32 operands (NumPy loop)."""
    nb = pool.shape[1]
    out = np.zeros_like(pool, np.float64)
    rnd = tf32_bits_np(pool).astype(np.float64)
    for t in range(len(tasks["dst"])):
        kn = int(tasks["srcn"][t])
        r = np.zeros((nb, nb))
        c = np.zeros((nb, nb))
        for i in range(nb):
            if tasks["relr"][t, i] >= 0:
                r[i, :kn] = rnd[tasks["lor"][t] + tasks["relr"][t, i], :kn]
            if tasks["relc"][t, i] >= 0 and i < tasks["blkn"][t]:
                c[i, :kn] = rnd[tasks["loc"][t] + tasks["relc"][t, i], :kn]
        d = int(tasks["dst"][t]) * nb
        out[d:d + nb] += r @ c.T
    return out


@pytest.mark.parametrize("nb", [8, 32])
def test_plain_update_default_is_the_tf32_rounded_product(nb):
    """'default' equals a float64 product of the TF32-rounded operands
    within 1e-6 of max|update| (float32 sums of exact products), and
    differs from the IEEE update by more than 1e-5 of it (the rounding is
    applied: one TF32 pass is off by ~1e-4 to 1e-3)."""
    for name, tasks, t, pool in edge_tables(nb, 5):
        got = update_of(pool, t, "default")
        want = tf32_update_np(tasks, pool.numpy())
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-6 * scale, name
        ieee = update_of(pool, t, "highest")
        assert np.abs(got - ieee).max() > 1e-5 * scale, name


def test_float64_ignores_precision_and_tf32x3_rounds_float32_only():
    """body_variant: float64 pools are IEEE at every precision, float32
    pools map 'default' to tf32 and 'highest' and 'high' to ieee (no
    TF32x3 body: float32 is as accurate); each variant has its entry
    point suffix and launch counter on both wrappers; an unknown precision
    raises."""
    assert [hu.body_variant(torch.float64, p)
            for p in ("highest", "high", "default")] == ["ieee"] * 3
    assert [hu.body_variant(torch.float32, p)
            for p in ("highest", "high", "default")] == \
        ["ieee", "ieee", "tf32"]
    assert hu.VARIANT_TAGS == {"ieee": ("", "launches"),
                               "tf32": ("_tf32", "launches_tf32")}
    for _, count in hu.VARIANT_TAGS.values():
        assert isinstance(getattr(hu.apply_updates, count), int)
        assert isinstance(getattr(mk.mega_factorize, count), int)
    with pytest.raises(ValueError):
        hu.body_variant(torch.float32, "tf32")


def test_rounding_tasks_give_minus_rounded_x():
    """The rounding check's tables (hopper_update.rounding_tasks): the
    plain update at 'default' leaves -round_tf32(x) in every column of
    the destination tiles, bit for bit, and at 'highest' -x."""
    nb = 16
    tasks, pool, x = hu.rounding_tasks(nb, 4, 11)
    t = hu.tasks_to_device(tasks, nb, pool.shape[0], "cpu")
    want = {"default": -hu.round_tf32(torch.as_tensor(x)), "highest":
            -torch.as_tensor(x)}
    for p, w in want.items():
        out = hu.apply_updates_plain(torch.tensor(pool), t, p)
        assert torch.equal(out[:len(x)], w[:, None].expand(-1, nb)), p
        assert torch.equal(out[len(x):], torch.tensor(pool)[len(x):])


@pytest.fixture(scope="module")
def p2d16():
    """poisson2d(16) at nb 16: the port's analysis and the JAX package's
    float64 oracle factor of the same plan."""
    import spllt_tpu as sj
    from spllt_tpu.api import _plans as plans_j
    from spllt_tpu.numeric.stf import factorize_np

    kw = dict(ordering="nd-grid", grid_shape=(16, 16), nb=NB, nemin=16)
    a = st.poisson2d(16)
    symb = st.analyse(a, st.Options(device="cpu", **kw))
    symb_j = sj.analyse(sj.poisson2d(16), sj.Options(mode="stf", **kw))
    plan_t, _, _ = symb.cache.block_plans(symb, symb.options)
    _, fplan_j, _ = plans_j(symb_j, symb_j.options)
    oracle = factorize_np(assemble_np(plan_t, symb.a_perm.values,
                                      dtype=np.float64), fplan_j)
    b = np.random.default_rng(7).standard_normal((a.n, 3))
    return dict(a=a, symb=symb, kw=kw, oracle=oracle, b=b)


@pytest.mark.parametrize("schedule", ["scan", "mega"])
@pytest.mark.parametrize("precision,refine", RUNS)
def test_factor_and_refined_solve_at_reduced_precision(p2d16, schedule,
                                                       precision, refine):
    """The float32 factor at 'high' (refine 2) and 'default' (refine 6,
    bench.py's pairs) on both schedules: within FACTOR_TOL of max|L| of
    the float64 oracle, and the refined backward error ≤ 1e-13."""
    o = st.Options(device="cpu", schedule=schedule, precision=precision,
                   refine=refine, **p2d16["kw"])
    num = st.factor(p2d16["symb"], options=o)
    oracle = p2d16["oracle"]
    err = np.abs(num.pool.numpy().astype(np.float64) - oracle).max()
    assert err <= FACTOR_TOL[precision] * np.abs(oracle).max()
    a, b = p2d16["a"], p2d16["b"]
    x = st.solve(num, b)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) <= BWD_ERR


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_default_factor_differs_from_highest_and_reruns_bit_for_bit(
        p2d16, schedule):
    """The TF32 rounding reaches the factor (it moves by more than 1e-5 of
    max|L|), and a second 'default' factorization is bit for bit the
    first."""
    kw = dict(device="cpu", schedule=schedule, **p2d16["kw"])
    hi = st.factor(p2d16["symb"], options=st.Options(precision="highest",
                                                     **kw)).pool
    o = st.Options(precision="default", **kw)
    lo = st.factor(p2d16["symb"], options=o).pool
    assert float((lo - hi).abs().max()) > 1e-5 * float(hi.abs().max())
    assert torch.equal(st.factor(p2d16["symb"], options=o).pool, lo)


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_float64_pools_bit_for_bit_across_precisions(p2d16, schedule):
    """A float64 pool computes in IEEE float64 at every precision: the three
    factors are bit for bit equal."""
    pools = [st.factor(p2d16["symb"], options=st.Options(
        device="cpu", schedule=schedule, precision=p, dtype="float64",
        **p2d16["kw"])).pool for p in ("highest", "high", "default")]
    assert pools[0].dtype == torch.float64
    assert all(torch.equal(pools[0], p) for p in pools[1:])


def test_precisions_get_distinct_cached_executors(p2d16):
    """A 'default' and a 'highest' factor of one symbolic object get
    distinct cached factor executors, each holding its precision, and a
    refactorization at 'default' reuses its own."""
    symb = st.analyse(p2d16["a"], st.Options(device="cpu", **p2d16["kw"]))
    for schedule in ("scan", "mega"):
        kw = dict(device="cpu", schedule=schedule, **p2d16["kw"])
        st.factor(symb, options=st.Options(precision="highest", **kw))
        st.factor(symb, options=st.Options(precision="default", **kw))
        cls = "MegaFactorExecutor" if schedule == "mega" \
            else "ScanFactorExecutor"
        execs = symb.cache.device("cpu").factor_executors
        fex = [e for e in execs.values() if type(e).__name__ == cls]
        assert sorted(e.precision for e in fex) == ["default", "highest"]
        before = dict(execs)
        st.factor(symb, options=st.Options(precision="default", **kw))
        assert execs == before


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_forest_at_default_precision(p2d16, schedule):
    """Options(ndevices=2) at 'default' (refine 6) on both schedules: every
    shard's factor executor and the top's hold the precision, the global
    factor lies within 1e-3 of max|L| of the single-device 'default'
    factor (both TF32: sums in another order move an operand across a
    TF32 rounding boundary now and then) and of the float64 oracle, and
    the refined backward error is ≤ 1e-13."""
    from spllt_tpu_torch.parallel.forest import reconstruct_global_pool

    kw = dict(device="cpu", schedule=schedule, precision="default",
              refine=6, **p2d16["kw"])
    one = st.factor(p2d16["symb"], options=st.Options(**kw)).pool.numpy()
    num = st.factor(p2d16["symb"], options=st.Options(ndevices=2, **kw))
    fx = num.mdf
    assert [e.precision for e in fx.local_ex + [fx.top_ex]] == \
        ["default"] * 3
    g = reconstruct_global_pool(fx.md, num.pool).astype(np.float64)
    oracle = p2d16["oracle"]
    scale = np.abs(oracle).max()
    assert np.abs(g - one[:len(g)]).max() <= FACTOR_TOL["default"] * scale
    assert np.abs(g - oracle[:len(g)]).max() <= \
        FACTOR_TOL["default"] * scale
    a, b = p2d16["a"], p2d16["b"]
    x = st.solve(num, b)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) <= BWD_ERR


@pytest.mark.cuda
def test_cuda_tensor_core_bodies_match_their_plain_versions():
    """On the card: K3 and K4's UPD runs at 'default' against the plain
    version of the same precision on the edge tables and on each hand-made
    UPD run as a stream of its own (so that both read the same inputs),
    within 1e-5 of the size of the update (the same rounded operands,
    float32 sums in another order), with the TF32 launch counters moving
    and 'high' running the IEEE body; and the TF32 body's rounding
    (cvt.rna) bit for bit round_tf32's on ties of both signs
    (rounding_tasks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    for nb in (48, 128):
        rng = np.random.default_rng(nb)
        tasks, rows = hu.compact_edge_tasks(nb, nb)
        cases = [("k3", hu.tasks_to_device(tasks, nb, rows, "cuda"), rows)]
        runs, rows_s = mk.upd_edge_runs(nb, nb)
        for run in runs:
            stream = mk.stream_to_device(mk.assemble_stream([run], nb,
                                                            rows_s), "cuda")
            stream.update(mk.plain_maps(stream, torch.device("cuda")))
            cases.append(("k4", stream, rows_s))
        for kind, tab, n in cases:
            pool = torch.as_tensor(rng.standard_normal((n, nb)),
                                   dtype=torch.float32, device="cuda")
            wrapper = hu.apply_updates if kind == "k3" else mk.mega_factorize
            for p in ("default", "high"):
                count = hu.VARIANT_TAGS[hu.body_variant(torch.float32, p)][1]
                before = getattr(wrapper, count)
                if kind == "k3":
                    got = hu.apply_updates(pool.clone(), tab, p)
                    ref = hu.apply_updates_plain(pool.clone(), tab, p)
                else:
                    got = mk.mega_factorize(pool.clone(), tab, precision=p)
                    ref = mk.mega_factorize_plain(pool.clone(), tab, p)
                torch.cuda.synchronize()
                scale = float((ref - pool).abs().max())
                assert float((got - ref).abs().max()) <= 1e-5 * scale
                assert getattr(wrapper, count) == before + 1
        tasks, pool, x = hu.rounding_tasks(nb, 4, nb)
        t = hu.tasks_to_device(tasks, nb, pool.shape[0], "cuda")
        got = hu.apply_updates(torch.as_tensor(pool, device="cuda"), t,
                               "default")[:len(x)].cpu()
        want = -hu.round_tf32(torch.as_tensor(x))
        assert torch.equal(got, want[:, None].expand(-1, nb))
