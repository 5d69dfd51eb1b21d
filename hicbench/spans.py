"""The port's spans and counters in a ``torch.profiler`` trace, on the
device's clock.

The port's tracer (``hichap_master_tpu_torch.utils.profiling``) marks a
span with ``record_function`` while a profiler records, so each lands in
the Chrome trace as a ``user_annotation`` event.  A span never waits for
the card: the device time it caused is that of the kernels, copies and
fills launched inside it, linked to their launching ``cuda_runtime``
calls by ``args.correlation``.  For each span inside the traced window
(other than ``hicbench.window``), ``occurrences`` gives its start on the
host, its end on the host, its end on the device (the later of its host
end and the end of the last device event it launched), the innermost
span that holds it, and the blocking runtime calls (``WAITS``) made
inside it.  A counter is an empty ``user_annotation`` event
``<counter>+=<n>``; ``occurrences`` sums those inside the window.

The traced run writes its trace to
``$TMPDIR/hicbench_trace_<cell>_<seed>.json``; ``latest`` reads the
newest such file once, and gives it to a reader only when its window is
the one the run reduced into ``ctx["trace"]``.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import tempfile
from collections import defaultdict

from hicbench import trace

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
COUNT = "+="
_CACHE: dict = {}


def _window(events) -> tuple:
    win = [e for e in events if e.get("name") == trace.WINDOW and "dur" in e]
    if not win:
        raise ValueError("the trace has no hicbench.window span")
    return (min(e["ts"] for e in win),
            max(e["ts"] + e["dur"] for e in win))


def measure(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(e - s for s, e in trace.union(intervals))


def occurrences(events: list) -> dict:
    """Every program span inside the window, as dicts (``name``, ``ts``,
    ``host_end``, ``end``: its device tail, ``parent``: the index of the
    innermost span of the same thread that holds it on the host, or None,
    ``waits``), the window (``lo``, ``hi``, microseconds) and the
    ``counts`` {counter: sum} of the counter events in it."""
    lo, hi = _window(events)
    tail = {}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in trace.DEVICE_CATS and "dur" in e and c is not None:
            tail[c] = max(tail.get(c, 0.0), e["ts"] + e["dur"])
    rt = sorted((e["ts"], e["name"], e.get("args", {}).get("correlation"))
                for e in events if e.get("cat") in RUNTIME_CATS
                and "dur" in e)
    rt_ts = [r[0] for r in rt]
    rt_tail = [tail.get(c, float("-inf")) for _, _, c in rt]
    wait_pre = [0]
    for _, name, _ in rt:
        wait_pre.append(wait_pre[-1] + (name in WAITS))
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e.get("name") != trace.WINDOW
             and lo <= e["ts"] < hi]
    counts = defaultdict(int)
    for e in marks:
        name, sep, n = e["name"].rpartition(COUNT)
        if sep:
            counts[name] += int(n)
    spans = sorted((e for e in marks if COUNT not in e["name"]),
                   key=lambda e: (e.get("tid"), e["ts"], -e["dur"]))
    out, stack = [], []
    for e in spans:
        ts, he = e["ts"], e["ts"] + e["dur"]
        while stack and (out[stack[-1]]["tid"] != e.get("tid")
                         or out[stack[-1]]["host_end"] < he):
            stack.pop()
        i, j = bisect.bisect_left(rt_ts, ts), bisect.bisect_right(rt_ts, he)
        out.append({"name": e["name"], "tid": e.get("tid"), "ts": ts,
                    "host_end": he, "end": max([he] + rt_tail[i:j]),
                    "parent": stack[-1] if stack else None,
                    "waits": wait_pre[j] - wait_pre[i]})
        stack.append(len(out) - 1)
    return {"spans": out, "lo": lo, "hi": hi, "counts": dict(counts)}


def ancestors(occ: list, k: int):
    p = occ[k]["parent"]
    while p is not None:
        yield p
        p = occ[p]["parent"]


def latest(ctx: dict, tmpdir: str | None = None):
    """``occurrences`` of the newest ``hicbench_trace_*.json`` under the
    run's temporary directory, read once per file; None when the run was
    not traced, when there is no such file, or when its window is not the
    one the run reduced (``ctx["trace"]["window_s"]``): then it is another
    run's trace."""
    if not ctx.get("trace"):
        return None
    paths = glob.glob(os.path.join(tmpdir or tempfile.gettempdir(),
                                   "hicbench_trace_*.json"))
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    key = (path, os.stat(path).st_mtime_ns)
    if key not in _CACHE:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        _CACHE.clear()
        _CACHE[key] = occurrences(events)
    found = _CACHE[key]
    if abs((found["hi"] - found["lo"]) * 1e-6
           - ctx["trace"]["window_s"]) > 1e-9:
        return None
    return found


def named(found, names) -> list:
    """Indices of the spans called one of ``names``."""
    return [k for k, o in enumerate(found["spans"]) if o["name"] in names]


def outermost(found, names) -> list:
    """Indices of the spans called one of ``names`` that no such span
    holds."""
    occ = found["spans"]
    return [k for k in named(found, names)
            if not any(occ[a]["name"] in names for a in ancestors(occ, k))]
