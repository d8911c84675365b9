"""``python -m spllt_tpu_torch`` held against ``python -m spllt_tpu``: the same
structural numbers and backward errors for the same arguments, every flag
of the reference's CLI (matrix files, stats, DOT, timers, trace, coarse)
plus ``--device``, the exit codes, and the --stats / --dot-tree texts
against the reference's functions.  In-process, on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spllt_tpu as sj
import spllt_tpu_torch as st
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.cli import main as main_j
from spllt_tpu.sparse.io import write_matrix_market, write_rutherford_boeing
from spllt_tpu.utils.dot import atree_dot as dot_j
from spllt_tpu.utils.stats import factor_plan_stats as stats_j
from spllt_tpu_torch.api import _plans as plans_t
from spllt_tpu_torch.cli import main as main_t
from spllt_tpu_torch.utils.dot import atree_dot as dot_t
from spllt_tpu_torch.utils.stats import factor_plan_stats as stats_t
from spllt_tpu_torch.utils.stats import print_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("matrix", "n", "nnz", "nnz_L", "flops", "t_analyse", "t_factor",
        "t_solve", "gflops", "bwd_err", "fwd_err")


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1]) if "--json" in argv \
        else None
    return rc, out, rec


def matrix_file(tmp_path, kind):
    """A Poisson 6x6 matrix written in the reference's own formats."""
    a = sj.poisson2d(6)
    path = str(tmp_path / ("a.mtx" if kind == "--mm" else "a.rb"))
    (write_matrix_market if kind == "--mm" else write_rutherford_boeing)(
        path, a)
    return path


@pytest.mark.parametrize("args", [
    ["--poisson2d", "10", "--nb", "8", "--nrhs", "2"],
    ["--poisson3d", "5", "--nb", "16", "--nemin", "8", "--no-prune-tree"],
    ["--random", "60", "--nb", "8", "--ordering", "rcm", "--reps", "2"],
    ["--mm"], ["--mat"]],
    ids=["poisson2d", "poisson3d", "random", "mm", "mat"])
def test_stf_matches_reference(tmp_path, capsys, args):
    """--mode stf --json: n, nnz, nnz_L and flops equal the reference CLI's
    for the same arguments, the keys are the same, both backward errors
    are below 1e-12 and both exit 0."""
    if args[0] in ("--mm", "--mat"):
        args = [args[0], matrix_file(tmp_path, args[0]), "--nb", "8"]
    argv = args + ["--mode", "stf", "--json"]
    rc_j, _, rec_j = run(main_j, argv, capsys)
    rc_t, out, rec_t = run(main_t, argv, capsys)
    assert rc_j == rc_t == 0
    assert tuple(rec_t) == tuple(rec_j) == KEYS
    for k in ("matrix", "n", "nnz", "nnz_L", "flops"):
        assert rec_t[k] == rec_j[k], k
    assert rec_t["bwd_err"] < 1e-12 and rec_j["bwd_err"] < 1e-12
    for tag in ("[analyse]", "[factor ]", "[solve  ]"):
        assert tag in out


@pytest.mark.parametrize("extra", [["--schedule", "mega"],
                                   ["--schedule", "scan", "--coarse"],
                                   ["--schedule", "unrolled", "--dtype",
                                    "float64", "--refine", "0"]],
                         ids=["mega", "scan-coarse", "unrolled-f64"])
def test_batched_with_every_output_flag(tmp_path, capsys, extra):
    """The batched path on the CPU with --stats, --timers, --trace and
    --dot-tree: rc 0, the trace holds the factor and solve events, the DOT
    file is a digraph, the stats and timers are printed."""
    trace, dot = str(tmp_path / "t.json"), str(tmp_path / "a.dot")
    argv = ["--poisson2d", "12", "--nb", "8", "--nrhs", "2", "--device",
            "cpu", "--json", "--stats", "--timers", "--trace", trace,
            "--dot-tree", dot] + extra
    rc, out, rec = run(main_t, argv, capsys)
    assert rc == 0 and rec["bwd_err"] < 1e-12
    names = [e["name"] for e in json.load(open(trace))["traceEvents"]]
    assert names == ["factor", "solve"]
    assert open(dot).read().startswith("digraph")
    for text in ("num_tasks", "tasks_per_kind", f"[trace  ] wrote {trace}",
                 f"[atree  ] wrote {dot}", "analyse", "GFLOP/s"):
        assert text in out


def test_stats_and_dot_text_equal_reference():
    """--stats prints factor_plan_stats(fplan) (the reference's with
    buckets=None) and --dot-tree writes atree_dot(symb): the same text."""
    kw = dict(ordering="nd-grid", grid_shape=(12, 12), nb=8, nemin=4,
              coarse_subtrees=True)
    symb_j = sj.analyse(sj.poisson2d(12), sj.Options(**kw))
    symb_t = st.analyse(st.poisson2d(12), st.Options(device="cpu", **kw))
    fj = plans_j(symb_j, symb_j.options)[1]
    ft = plans_t(symb_t, symb_t.options)[1]
    assert stats_t(ft) == stats_j(fj)
    assert print_stats(stats_t(ft)) == print_stats(stats_j(fj))
    assert dot_t(symb_t) == dot_j(symb_j)
    assert dot_t(symb_t, max_nodes=5) == dot_j(symb_j, max_nodes=5)


@pytest.mark.parametrize("schedule", ["mega", "scan"])
def test_ndev_two_runs_the_forest_on_cpu_shards(capsys, schedule):
    """--ndev 2 --device cpu exits 0 with the reference CLI's output lines
    and --json keys; the structural numbers equal the reference's for the
    same arguments (which it runs in stf mode here: its batched forest
    compiles for minutes on the CPU)."""
    argv = ["--poisson2d", "10", "--nb", "8", "--nrhs", "2", "--ndev", "2",
            "--json", "--schedule", schedule]
    rc_j, out_j, rec_j = run(main_j, argv + ["--mode", "stf"], capsys)
    rc_t, out, rec_t = run(main_t, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert tuple(rec_t) == tuple(rec_j) == KEYS
    for k in ("matrix", "n", "nnz", "nnz_L", "flops"):
        assert rec_t[k] == rec_j[k], k
    assert rec_t["bwd_err"] < 1e-12
    for tag in ("[analyse]", "[factor ]", "[solve  ]"):
        assert out.count(tag) == out_j.count(tag) == 1


def test_stf_ignores_ndev(capsys):
    """--mode stf --ndev 2 runs the NumPy oracle, as the reference does."""
    argv = ["--poisson2d", "6", "--nb", "8", "--mode", "stf", "--ndev", "2",
            "--json"]
    rc_j, _, rec_j = run(main_j, argv, capsys)
    rc_t, _, rec_t = run(main_t, argv, capsys)
    assert rc_j == rc_t == 0
    assert rec_t["nnz_L"] == rec_j["nnz_L"] and rec_t["bwd_err"] < 1e-12


def test_cuda_without_a_card_exits_non_zero(capsys):
    """--device cuda (the default) where torch sees no CUDA device: exit 2
    with the RuntimeError's text, nothing factored on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main_t(["--poisson2d", "6", "--nb", "8"])
    cap = capsys.readouterr()
    assert rc == 2 and "torch.cuda.is_available() is false" in cap.err
    assert "[factor ]" not in cap.out


def test_python_m_entry_point():
    """``python -m spllt_tpu_torch`` runs the CLI in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-m", "spllt_tpu_torch", "--poisson2d", "6",
         "--nb", "8", "--device", "cpu", "--json"],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1])["bwd_err"] < 1e-12
    assert np.isfinite(json.loads(out.stdout.splitlines()[-1])["t_factor"])


def test_trace_files_equal_reference(tmp_path):
    """TraceLog.dump / dump_paje of the same events write the reference's
    files, and device_trace writes a Chrome trace of the block (on the CPU:
    its host activity)."""
    from spllt_tpu.utils.tracing import TraceLog as TraceLog_j
    from spllt_tpu_torch.utils.tracing import TraceLog, device_trace

    tj, tt = TraceLog_j(), TraceLog()
    with tt.event("factor", rep=0):
        tt.instant("level", width=3)
    tj.events = [dict(e) for e in tt.events]
    for fmt in ("dump", "dump_paje"):
        getattr(tj, fmt)(str(tmp_path / f"j.{fmt}"))
        getattr(tt, fmt)(str(tmp_path / f"t.{fmt}"))
        assert (tmp_path / f"j.{fmt}").read_text() == \
            (tmp_path / f"t.{fmt}").read_text()
    with device_trace(str(tmp_path / "dev")) as prof:
        torch.ones(8).cumsum(0)
    assert prof is not None
    events = json.load(open(tmp_path / "dev" / "trace.json"))["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
