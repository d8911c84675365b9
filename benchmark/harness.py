"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, one traffic mix or one metric
is a file of its own, found by the name that ``BENCHMARK.json`` gives:

- ``BENCHMARK.json``'s ``configs[].file``: the matrix (``generator`` and its
  parameters), the program's ``options``, the frozen ``work``, the ``correct``
  limit and the ``control`` used to set it;
- ``generators/<generator>.py``: ``make(params) -> (n, colptr, rowind,
  values)``, the lower-CSC matrix;
- ``traffic/<traffic>.json``: the parameters that :mod:`inputs` reads;
- ``metrics/<metric>.py``: ``read(run) -> float | None`` for each metric of
  ``end_to_end`` (read from a ``--trace 0`` run) and ``per_layer`` (from a
  ``--trace 1`` run).  A reader that finds nothing to read returns None and
  the metric is left out of the line.

The program is driven through its public API only: ``analyse``, ``factor``,
``solve``, ``Options`` and ``CscMatrix`` of ``spllt_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "spllt_tpu")


class BenchError(RuntimeError):
    """A cell that cannot be run as asked."""


@dataclasses.dataclass
class Bench:
    """The benchmark's files: ``BENCHMARK.json`` under ``root`` and the
    harness's data folders under ``bench_dir``."""

    root: str = ROOT
    bench_dir: str = HERE

    def __post_init__(self):
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")

    def config_path(self, name: str) -> str:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return os.path.join(self.root, c["file"])
        raise BenchError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.config_path(name))

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      name + ".json"))

    def metrics(self, kind: str, cell: str) -> list:
        """The ``kind`` ('end_to_end' or 'per_layer') metrics that ``cell``
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        metric + ".py")).read

    def generator(self, name: str):
        return load_module(os.path.join(self.bench_dir, "generators",
                                        name + ".py")).make


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """Import the file at ``path`` (names may hold '.' and '-')."""
    if not os.path.isfile(path):
        raise BenchError(f"missing file {os.path.relpath(path, ROOT)}")
    name = "_bench_" + "".join(c if c.isalnum() else "_" for c in
                               os.path.relpath(path, ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def options(config: dict, device: str, overrides: dict | None = None):
    """The program's ``Options`` of ``config`` on ``device``."""
    import spllt_tpu_torch as st

    kw = dict(config["options"])
    if "grid_shape" in kw:
        kw["grid_shape"] = tuple(kw["grid_shape"])
    kw.update(overrides or {})
    return st.Options(device=device, **kw)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (``spllt_tpu_torch`` is not ``spllt_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """Host-clock spans of the window; under a trace each is also a
    ``torch.profiler.record_function`` named ``bench.<kind>``, so that the
    profiler's timeline carries it."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans = []           # (kind, start_s, end_s), perf_counter

    def __call__(self, kind: str):
        return _Span(self, kind)


class _Span:
    def __init__(self, owner: Spans, kind: str):
        self.owner, self.kind, self.rf = owner, kind, None

    def __enter__(self):
        if self.owner.traced:
            import torch

            self.rf = torch.profiler.record_function("bench." + self.kind)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.spans.append((self.kind, self.t0, t1))
        return False


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    config: dict
    traffic: dict
    setup: dict               # analyse_s, first_factor_s, first_solve_s, setup_s
    spans: list               # host-clock spans of the window
    window_s: float
    memory_peak_bytes: int
    device_name: str
    timeline: object = None   # timeline.Timeline of a traced run, else None

    def of(self, kind: str) -> list:
        return [s for s in self.spans if s[0] == kind]


def card(device) -> dict:
    """The ``device`` object of the result line (without the peak)."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits",
             f"--id={torch.device(device).index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = float(smi.stdout.split(",")[-1])
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    return out


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """Run ``cell`` once and return the result line's object.  ``t_start``
    is the host clock at the process's start; ``device`` is 'cuda' for a
    measurement ('cpu' only in the benchmark's own tests, which run the
    same steps at a small size); ``overrides`` replace options of the
    configuration (the control: a precision below the one it states)."""
    import torch

    import spllt_tpu_torch as st

    from benchmark import inputs as inputs_mod
    from benchmark.reference import Reference

    w = bench.workload(cell)
    config = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # ---- set-up -------------------------------------------------------
    n, colptr, rowind, values = bench.generator(config["generator"])(
        config["matrix"])
    data = inputs_mod.make_inputs((n, colptr, rowind, values), traffic, seed)
    opts = options(config, device, overrides)
    refactor = bool(traffic["refactor_each_step"])
    nv, nr = len(data.value_sets), len(data.rhs_sets)

    def matrix(i):
        return st.CscMatrix(n, colptr, rowind, data.value_sets[i % nv])

    setup = {}
    t0 = time.perf_counter()
    symb = st.analyse(matrix(0), opts)
    setup["analyse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    num = st.factor(symb, matrix(0))
    sync()
    setup["first_factor_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st.solve(num, data.rhs_sets[0])
    setup["first_solve_s"] = time.perf_counter() - t0
    # one warm step: the window's first step, on the same inputs
    if refactor:
        num = st.factor(symb, matrix(0))
    st.solve(num, data.rhs_sets[0])
    sync()

    # ---- the window: one caller, each step waits for the one before ----
    spans = Spans(trace)
    kept, sampler = [], random.Random(seed)
    k_keep = int(traffic["check_sample"])
    attempted = failed = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup["setup_s"] = time.perf_counter() - t_start
    w0 = time.perf_counter()
    while True:
        i = attempted
        attempted += 1
        with spans("step"):
            try:
                if refactor:
                    a = matrix(i)
                    with spans("factor"):
                        num = st.factor(symb, a)
                with spans("solve"):
                    x = st.solve(num, data.rhs_sets[i % nr])
            except st.SpLLTError as e:
                failed += 1
                print(f"step {i}: {type(e).__name__}: {e}", file=sys.stderr)
                x = None
        # a uniform sample of the window's steps, drawn from the seed
        if len(kept) < k_keep:
            kept.append((i, x))
        else:
            j = sampler.randrange(attempted)
            if j < k_keep:
                kept[j] = (i, x)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    trace_file = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, trace_file = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_file)
        del prof

    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    device_info = card(dev) if cuda else {"platform": "cpu", "kind": "cpu",
                                          "count": 1}
    device_info["memory_peak_bytes"] = memory_peak

    # ---- the check, with the program's state freed ----------------------
    del num, symb
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(n, colptr, rowind, data.value_sets, dev)
    errs = []
    for i, x in kept:
        if x is None:
            errs.append(float("inf"))
            continue
        errs.extend(ref.backward_errors(i % nv if refactor else 0, x,
                                        data.rhs_sets[i % nr]))
    del ref
    bwd_err = max(errs) if errs else float("inf")
    limit = float(config["correct"]["bwd_err"])
    checks = {
        "bwd_err": {"value": bwd_err, "limit": limit},
        "failed_steps": {"value": failed, "limit": 0},
    }
    correct = bool(bwd_err <= limit and failed == 0 and len(kept) >= 1)

    # ---- metrics -----------------------------------------------------------
    run = Run(config=config, traffic=traffic, setup=setup,
              spans=spans.spans, window_s=window_s,
              memory_peak_bytes=memory_peak,
              device_name=device_info["kind"])
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    breakdown = None
    if trace:
        from benchmark import timeline as tl_mod

        tl = tl_mod.from_chrome_trace(trace_file)
        os.remove(trace_file)
        kind = "per_layer"
        # device metrics come from a card's timeline only, never a CPU run's
        if cuda and tl.of("step") and tl.ops:
            run.timeline = tl
            w_start, w_end = tl_mod.window(tl)
            device_info["busy_s"] = tl_mod.busy_seconds(tl)
            device_info["window_s"] = w_end - w_start
            breakdown = {"device_ops": tl_mod.top_ops(tl),
                         "idle_gaps": tl_mod.idle_gaps(tl)}
    else:
        kind = "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, cell):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device_info
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def check_lines(checks: dict) -> list:
    """The numbers compared, each beside its limit, one per line."""
    return [f"check {k} {v['value']!r} <= limit {v['limit']!r}"
            for k, v in checks.items()]
