"""Hierarchical step timers.

Analogue of the reference's ``timer_mod`` (hierarchical per-thread step
timers with min/max/avg and flop rates,
SpLLT:src/timer_mod.F90:36-59): a process-global registry of
named nested timers driven by context managers, printable as a tree and
dumpable as CSV (``timer_log_dump`` analogue, utils_mod.F90:298-383).

A copy of ``spllt_tpu.utils.timers``.  The timers read the host clock.  On
the card that clock stays honest around the API's phases because each of
them ends in a host synchronisation: ``factor`` reads the device's
not-positive-definite flag with ``bool()``, which waits for every launch
of the factorization, and ``solve`` returns a NumPy array copied from the
device.  A timer around other device work must synchronise itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["timer", "print_timers", "reset_timers", "timer_csv"]


@dataclasses.dataclass
class _Node:
    name: str
    total: float = 0.0
    count: int = 0
    tmin: float = float("inf")
    tmax: float = 0.0
    flops: float = 0.0
    children: dict = dataclasses.field(default_factory=dict)

    def record(self, dt: float, flops: float = 0.0):
        self.total += dt
        self.count += 1
        self.tmin = min(self.tmin, dt)
        self.tmax = max(self.tmax, dt)
        self.flops += flops


_root = _Node("root")
_stack = [_root]


@contextlib.contextmanager
def timer(name: str, flops: float = 0.0):
    parent = _stack[-1]
    node = parent.children.get(name)
    if node is None:
        node = _Node(name)
        parent.children[name] = node
    _stack.append(node)
    t0 = time.perf_counter()
    try:
        yield node
    finally:
        node.record(time.perf_counter() - t0, flops)
        _stack.pop()


def reset_timers() -> None:
    _root.children.clear()


def _walk(node: _Node, depth: int, lines: list):
    for child in node.children.values():
        rate = (f"  {child.flops / child.total / 1e9:8.1f} GFLOP/s"
                if child.flops and child.total else "")
        avg = child.total / max(1, child.count)
        lines.append(
            f"{'  ' * depth}{child.name:<30} {child.total:9.4f}s "
            f"n={child.count:<4d} avg={avg:8.4f}s min={child.tmin:8.4f}s "
            f"max={child.tmax:8.4f}s{rate}")
        _walk(child, depth + 1, lines)


def print_timers(out=None) -> str:
    lines: list = []
    _walk(_root, 0, lines)
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


def timer_csv() -> str:
    rows = ["name,total_s,count,min_s,max_s,gflops"]

    def rec(node, prefix):
        for c in node.children.values():
            name = f"{prefix}/{c.name}" if prefix else c.name
            g = c.flops / c.total / 1e9 if c.flops and c.total else 0.0
            rows.append(f"{name},{c.total:.6f},{c.count},"
                        f"{c.tmin:.6f},{c.tmax:.6f},{g:.2f}")
            rec(c, name)

    rec(_root, "")
    return "\n".join(rows)
