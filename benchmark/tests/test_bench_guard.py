"""What a run refuses: no card, a JAX module loaded, a checkout without the
program."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness, run

from conftest import ROOT


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax", ["flax"]), ("spllt_tpu", ["spllt_tpu"]),
    ("spllt_tpu.api", ["spllt_tpu"]), ("spllt_tpu_torch", []),
    ("spllt_tpu_torch.api", []), ("jaxtyping", []), ("spllt_tpux", []),
])
def test_import_guard_compares_whole_top_level_names(monkeypatch, name,
                                                     found):
    for m in list(sys.modules):
        if m.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == found


def fake_card(monkeypatch, result):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: result)


RESULT = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
          "device": {}, "checks": {"bwd_err": {"value": 1e-16,
                                               "limit": 1e-12}}}
ARGS = ["--workload", "p3d64.refactor", "--seed", "1", "--seconds", "1"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    fake_card(monkeypatch, RESULT)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(ARGS) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_a_run_prints_checks_last(monkeypatch, capsys):
    fake_card(monkeypatch, RESULT)
    for m in list(sys.modules):
        if m.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    assert run.main(ARGS) == 0
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1].startswith('{"correct": true')
    assert out.rstrip().endswith('"limit": 1e-12}}}')
    assert err.strip().splitlines()[-1] == \
        "check bwd_err 1e-16 <= limit 1e-12"


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no result, exit
    code other than 0."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS,
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
