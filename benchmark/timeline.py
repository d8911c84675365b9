"""The traced run's timeline: the benchmark's spans and the device's
operations, on the profiler's one clock, and the arithmetic over them.

A span is (kind, start, end) in seconds: ``step``, ``factor``, ``solve``,
recorded by the benchmark around the public calls.  A device operation is
(name, start, end): a kernel, a copy or a memset that the profiler saw on the
card.  Each call of the program ends in a synchronisation (``factor`` in its
``notpos`` read, ``solve`` in the copy of x back to the host), so the device
work a call starts lies inside its span.
"""

from __future__ import annotations

import dataclasses
import json

SPAN_PREFIX = "bench."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Timeline:
    spans: list           # (kind, start_s, end_s), sorted by start
    ops: list             # (name, start_s, end_s), sorted by start

    def of(self, kind: str) -> list:
        return [s for s in self.spans if s[0] == kind]


def from_chrome_trace(path: str) -> Timeline:
    """Read the spans and device operations of a ``torch.profiler`` Chrome
    trace (timestamps in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], t0, t1))
        elif cat in DEVICE_CATEGORIES:
            ops.append((name, t0, t1))
    spans.sort(key=lambda s: s[1])
    ops.sort(key=lambda o: o[1])
    return Timeline(spans=spans, ops=ops)


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def covered(intervals, spans) -> float:
    """Seconds of the (kind, start, end) ``spans``, sorted and disjoint,
    that the sorted disjoint ``intervals`` cover."""
    total, i = 0.0, 0
    for _, t0, t1 in spans:
        while i < len(intervals) and intervals[i][1] <= t0:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < t1:
            a, b = intervals[j]
            total += max(0.0, min(b, t1) - max(a, t0))
            j += 1
    return total


def ops_in(tl: Timeline, kind: str, names=None) -> list:
    """The device operations that start inside a span of ``kind``; with
    ``names``, only those whose name contains one of them."""
    spans = tl.of(kind)
    out, i = [], 0
    for op in tl.ops:
        while i < len(spans) and spans[i][2] < op[1]:
            i += 1
        if i == len(spans):
            break
        if spans[i][1] <= op[1] and (
                names is None or any(n in op[0] for n in names)):
            out.append(op)
    return out


def op_seconds(ops) -> float:
    return sum(t1 - t0 for _, t0, t1 in ops)


def idle_share(tl: Timeline, kind: str):
    """Share of the time inside the spans of ``kind`` in which no device
    operation runs (None without such spans)."""
    spans = tl.of(kind)
    total = sum(t1 - t0 for _, t0, t1 in spans)
    if total <= 0:
        return None
    busy = union((t0, t1) for _, t0, t1 in tl.ops)
    return 1.0 - covered(busy, spans) / total


def window(tl: Timeline):
    """(start, end) of the traced window: its first step to its last."""
    steps = tl.of("step")
    return steps[0][1], max(s[2] for s in steps)


def busy_seconds(tl: Timeline) -> float:
    """Seconds of the window in which some device operation runs."""
    w0, w1 = window(tl)
    return covered(union((t0, t1) for _, t0, t1 in tl.ops),
                   [("window", w0, w1)])


def top_ops(tl: Timeline, k: int = 10) -> list:
    """[name, seconds] of the ``k`` device operations with the most time in
    the window, summed by name."""
    w0, w1 = window(tl)
    tot: dict = {}
    for name, t0, t1 in tl.ops:
        if w0 <= t0 <= w1:
            tot[name] = tot.get(name, 0.0) + (t1 - t0)
    return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(tl: Timeline, k: int = 10) -> list:
    """[label, seconds] of the ``k`` longest stretches of the window with no
    device operation.  The label names the span the stretch lies in:
    ``factor`` or ``solve`` with ``.start`` (before the span's first device
    operation), ``.mid`` or ``.end`` (after its last), ``.idle`` where the
    span has none, or ``between`` outside them (building the next step's
    matrix, the loop)."""
    w0, w1 = window(tl)
    busy = union((t0, t1) for _, t0, t1 in tl.ops if w0 <= t0 <= w1)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    calls = [s for s in tl.spans if s[0] != "step"]
    out = []
    for g0, g1 in gaps[:k]:
        mid = 0.5 * (g0 + g1)
        label = "between"
        for kind, s0, s1 in calls:
            if s0 <= mid <= s1:
                inside = [iv for iv in busy if s0 <= iv[0] <= s1]
                if not inside:
                    label = f"{kind}.idle"
                elif g1 <= inside[0][0]:
                    label = f"{kind}.start"
                elif g0 >= inside[-1][1]:
                    label = f"{kind}.end"
                else:
                    label = f"{kind}.mid"
                break
        out.append([label, g1 - g0])
    return out
