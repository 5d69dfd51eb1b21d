"""Tracing / profiling hooks (SURVEY §5: absent in the reference).

``stage`` is a context manager that logs wall time per pipeline stage and
accumulates a metrics dict; ``trace`` optionally wraps a block in a
``torch.profiler`` trace for device timeline inspection.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

from .logging import get_logger

log = get_logger(__name__)

_METRICS: Dict[str, float] = {}


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage; accumulates into the module metrics dict."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _METRICS[name] = _METRICS.get(name, 0.0) + dt
        log.log(21, "stage %-28s %8.2f s", name, dt)


def add(name: str, value: float) -> None:
    """Accumulate a scalar metric (e.g. bytes moved) outside a timed stage."""
    _METRICS[name] = _METRICS.get(name, 0.0) + value


def metrics() -> Dict[str, float]:
    return dict(_METRICS)


def reset_metrics(prefix: Optional[str] = None) -> None:
    """Clear accumulated metrics; with ``prefix``, clear only matching keys
    (so a caller measuring one stage doesn't drop the rest of the run's
    accumulators)."""
    if prefix is None:
        _METRICS.clear()
        return
    for k in [k for k in _METRICS if k.startswith(prefix)]:
        del _METRICS[k]


def dump_metrics(path: str) -> None:
    with open(path, "w") as f:
        json.dump(metrics(), f, indent=2, sort_keys=True)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace wrapper (no-op when log_dir is None): host and,
    where a card is visible, device activity, written to ``log_dir`` as a
    Chrome trace."""
    if not log_dir:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.log(21, "torch profiler trace written to %s", path)
