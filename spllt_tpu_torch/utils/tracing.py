"""Execution tracing.

The reference hand-rolls Paje traces for ViTE (``trace_mod.F90``) and uses
StarPU FxT; here, as in ``spllt_tpu.utils.tracing``:
  * a host-side event log dumped as Chrome-trace JSON (view in Perfetto) or
    as Paje for ViTE — :class:`TraceLog`, a copy of the JAX package's — and
  * :func:`device_trace`, a thin wrapper over ``torch.profiler`` that
    records the host's and the card's activity (every kernel launch by
    name) into a Chrome trace, where the JAX package wraps
    ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

__all__ = ["TraceLog", "device_trace"]


class TraceLog:
    """Chrome-trace event collector (Paje-dump analogue)."""

    def __init__(self):
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def event(self, name: str, category: str = "spllt", **args):
        """Record the block as one complete event; yields the event's
        ``args`` dict, which the block may fill in before it ends."""
        t0 = time.perf_counter()
        try:
            yield args
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.events.append({
                    "name": name, "cat": category, "ph": "X",
                    "ts": (t0 - self._t0) * 1e6,
                    "dur": (t1 - t0) * 1e6,
                    "pid": 0, "tid": threading.get_ident() % 1000,
                    "args": args,
                })

    def instant(self, name: str, **args):
        with self._lock:
            self.events.append({
                "name": name, "cat": "spllt", "ph": "i",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": 0, "tid": 0, "s": "g", "args": args,
            })

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)

    def dump_paje(self, path: str) -> None:
        """Dump in Paje format for ViTE (exact parity with the reference's
        ``trace_log_dump_paje``, SpLLT:src/trace_mod.F90:170-307)."""
        cats = sorted({e["name"] for e in self.events if e["ph"] == "X"})
        tids = sorted({e["tid"] for e in self.events if e["ph"] == "X"})
        lines = [
            "%EventDef PajeDefineContainerType 1",
            "% Alias string", "% ContainerType string", "% Name string",
            "%EndEventDef",
            "%EventDef PajeDefineStateType 3",
            "% Alias string", "% ContainerType string", "% Name string",
            "%EndEventDef",
            "%EventDef PajeDefineEntityValue 6",
            "% Alias string", "% EntityType string", "% Name string",
            "% Color color", "%EndEventDef",
            "%EventDef PajeCreateContainer 7",
            "% Time date", "% Alias string", "% Type string",
            "% Container string", "% Name string", "%EndEventDef",
            "%EventDef PajeSetState 10",
            "% Time date", "% Type string", "% Container string",
            "% Value string", "%EndEventDef",
            "1 CT_Prog 0 'Program'",
            "1 CT_Thread CT_Prog 'Thread'",
            "3 ST_ThreadState CT_Thread 'Thread State'",
            "7 0.000000 C_Prog CT_Prog 0 'Program'",
        ]
        for i, c in enumerate(cats):
            frac = (i + 1) / (len(cats) + 1)
            lines.append(
                f"6 V_{i} ST_ThreadState '{c}' '{frac:.2f} {1-frac:.2f} 0.5'")
        for t in tids:
            lines.append(
                f"7 0.000000 C_T{t} CT_Thread C_Prog 'Worker {t}'")
        vid = {c: i for i, c in enumerate(cats)}
        evs = sorted((e for e in self.events if e["ph"] == "X"),
                     key=lambda e: e["ts"])
        for e in evs:
            t0 = e["ts"] / 1e6
            t1 = (e["ts"] + e["dur"]) / 1e6
            lines.append(f"10 {t0:.6f} ST_ThreadState C_T{e['tid']} "
                         f"V_{vid[e['name']]}")
            lines.append(f"10 {t1:.6f} ST_ThreadState C_T{e['tid']} V_idle")
        lines.insert(len(lines) - 2 * len(evs),
                     "6 V_idle ST_ThreadState 'idle' '0.9 0.9 0.9'")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host activity, and the
    CUDA kernels and copies when a card is present) and write the Chrome
    trace to ``logdir/trace.json`` on exit; yields the profiler, whose
    ``key_averages()`` sums the time by kernel.  The FxT /
    ``starpu_fxt_tool`` analogue for the CUDA runtime."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
