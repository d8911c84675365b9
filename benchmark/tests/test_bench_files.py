"""BENCHMARK.json, and every file it names, as the contract has them."""

import hashlib
import json
import os
import re
import time

import pytest

from benchmark import harness

from conftest import ROOT, small_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.Bench().spec
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_named_file_is_found_and_parsed():
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        config = bench.config(w["config"])
        assert config["name"] == w["config"]
        assert callable(bench.generator(config["generator"]))
        harness.options(config, "cpu")          # the program accepts them
        traffic = bench.traffic(w["traffic"])
        assert {"refactor_each_step", "value_sets", "nrhs", "rhs_sets",
                "check_sample"} <= set(traffic)
        assert float(config["correct"]["bwd_err"]) > 0
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_every_cell_reports_what_the_contract_asks():
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.metrics("per_layer", w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def harness_files(bdir):
    """Every file of the benchmark folder outside its tests, by path."""
    out = {}
    for d, dirs, files in os.walk(bdir):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, bdir)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_and_metric_files_are_picked_up(tmp_path):
    """A configuration and a metric added as new files, and named in
    BENCHMARK.json, run without an edit of any file already there."""
    dest = small_copy(str(tmp_path), m=6, nb=8)
    bdir = os.path.join(dest, "benchmark")
    with open(os.path.join(bdir, "metrics", "steps_run.py"), "w") as f:
        f.write("def read(run):\n    return len(run.of('step'))\n")
    spec_path = os.path.join(dest, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["per_layer"].append({
        "name": "steps_run", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "API and caches",
        "moves": "solve_ms", "workloads": ["p3d6.resolve"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    bench = harness.Bench(root=dest, bench_dir=bdir)
    out = harness.run_cell(bench, "p3d6.resolve", 3, 0.2, True,
                           time.perf_counter(), device="cpu")
    assert out["correct"]
    assert out["metrics"]["steps_run"]["value"] == out["attempted"]
    old = harness_files(os.path.join(ROOT, "benchmark"))
    new = harness_files(bdir)
    assert set(new) - set(old) == {"configs/poisson3d-6.json",
                                   "metrics/steps_run.py"}
    assert all(new[p] == h for p, h in old.items())


def test_unknown_names_are_refused():
    bench = harness.Bench()
    with pytest.raises(harness.BenchError):
        bench.workload("p3d64.nothing")
    with pytest.raises(harness.BenchError):
        bench.reader("no_such_metric")
