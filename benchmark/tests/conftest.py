"""Fixtures of the benchmark's own tests (run with
``python -m pytest benchmark/tests -q``; the card's tests carry the ``cuda``
marker and skip without a card)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine")
    return "cuda"


def small_copy(dest: str, m: int = 16, nb: int = 32) -> str:
    """A copy of the benchmark in ``dest`` with one more configuration,
    ``poisson3d-<m>``, made from ``poisson3d-64``'s file at a size a test
    holds, and its cells ``p3d<m>.refactor`` and ``p3d<m>.resolve``, each
    listed wherever the 64³ cell of its traffic is."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "poisson3d-64.json")) as f:
        config = json.load(f)
    name = f"poisson3d-{m}"
    config.update(name=name, matrix={"m": m})
    config["options"].update(grid_shape=[m, m, m], nb=nb)
    config["work"] = {}
    rel = f"benchmark/configs/{name}.json"
    with open(os.path.join(dest, rel), "w") as f:
        json.dump(config, f)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": name, "source": "test", "file": rel,
                            "reduced": [], "why": "test size"})
    for traffic in ("refactor", "resolve"):
        cell = f"p3d{m}.{traffic}"
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test size"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if f"p3d64.{traffic}" in metric.get("workloads", []):
                metric["workloads"].append(cell)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dest


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    """The harness's ``Bench`` over a :func:`small_copy`."""
    from benchmark import harness

    dest = small_copy(str(tmp_path_factory.mktemp("bench")))
    return harness.Bench(root=dest, bench_dir=os.path.join(dest, "benchmark"))
