"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time (the union of the intervals in which a
kernel, copy or fill ran on the card) inside the traced window, each
kernel name's device seconds, and the idle gaps named by what the host
was doing meanwhile.

The trace is the Chrome trace the profiler exports (``ts`` and ``dur`` in
microseconds, device events aligned to the host's clock), read back from
the file the run writes under ``TMPDIR``.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "hicbench.window"
SCAN = 256


def union(intervals) -> list:
    """Disjoint, sorted intervals covering the given (start, end) ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] outside the disjoint ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def reduce(events: list) -> dict:
    """``window_s``, ``busy_s``, ``kernel_s`` {name: seconds},
    ``device_ops`` and ``idle_gaps`` (the ten largest, [name, seconds],
    gaps summed by the host operation that overlaps them most, ``host``
    where none does) of Chrome trace events."""
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise ValueError("the trace has no hicbench.window span")
    lo = min(e["ts"] for e in win)
    hi = max(e["ts"] + e["dur"] for e in win)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy = union(clip([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi))
    kernel_s = defaultdict(float)
    for e in dev:
        s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if t > s:
            kernel_s[e["name"]] += (t - s) * 1e-6
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "cpu_op" and "dur" in e))
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in gaps(busy, lo, hi):
        best, name = 0.0, "host"
        # the last SCAN host ops that start before the gap ends
        j = bisect.bisect_left(starts, e)
        for i in range(max(0, j - SCAN), j):
            hs, he, hn = host[i]
            ov = min(he, e) - max(hs, s)
            if ov > best:
                best, name = ov, hn
        idle[name] += (e - s) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": dict(kernel_s),
        "device_ops": top(kernel_s),
        "idle_gaps": top(idle),
    }


def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` largest entries as [name, value], names cut to ``width``
    characters (templated kernel names run to thousands)."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def read(path: str) -> dict:
    with open(path) as f:
        return reduce(json.load(f)["traceEvents"])


def seconds_of(kernel_s: dict, names) -> float:
    """Device seconds of the kernels whose name contains any of ``names``."""
    return sum(v for k, v in kernel_s.items() if any(n in k for n in names))
