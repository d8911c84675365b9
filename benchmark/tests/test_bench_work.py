"""The frozen work counts of the configurations."""

import pytest

from benchmark import count_work, harness

BENCH = harness.Bench()

# the program's analysis at this configuration's options (nd-grid, nb 128,
# nemin 192), counted on the CPU when the counts were frozen
FROZEN = {
    "poisson3d-64": dict(n=262144, nnz_a=1036288, nnz_a_full=1810432,
                         nnz_l=186983272, flops=468371872660,
                         pool_bytes=3131506688, levels=98, tasks=471848,
                         flop_peak="fp32"),
    "poisson3d-96": dict(n=884736, nnz_a=3511296, nnz_a_full=6137856,
                         nnz_l=981664626, flops=5291667897094,
                         pool_bytes=7349993472, levels=206, tasks=2385681,
                         flop_peak="fp32"),
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_configuration_files_hold_the_frozen_counts(name):
    assert BENCH.config(name)["work"] == FROZEN[name]


def test_count_agrees_with_the_programs_analysis_at_a_small_size():
    import spllt_tpu_torch as st

    config = dict(BENCH.config("poisson3d-64"), matrix={"m": 10})
    config["options"] = dict(config["options"], grid_shape=[10, 10, 10],
                             nb=16, nemin=8)
    w = count_work.count(config, BENCH)
    symb = st.analyse(st.poisson3d(10), harness.options(config, "cpu"))
    assert w["n"] == 1000 and w["nnz_a"] == st.poisson3d(10).nnz
    assert w["nnz_a_full"] == 2 * w["nnz_a"] - w["n"]
    assert w["nnz_l"] == symb.inform.num_factor
    assert w["flops"] == symb.inform.num_flops
    assert w["pool_bytes"] % (16 * 16 * 4) == 0


def test_factor_bound_takes_the_larger_of_compute_and_bytes():
    from benchmark import work

    peaks = work.card_peaks("NVIDIA H100 80GB HBM3")
    w = FROZEN["poisson3d-64"]
    assert work.factor_bound_s(w, peaks) == pytest.approx(
        468371872660 / 67e12)
    thin = dict(w, flops=1)
    assert work.factor_bound_s(thin, peaks) == pytest.approx(
        4 * (186983272 + 1036288) / 3.35e12)
    assert work.card_peaks("cpu") is None
