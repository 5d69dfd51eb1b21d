"""The port's tracer, the synchronised wall of a pipeline step, and the
command line's stage metrics.

``span(name)`` and ``count(name, n)`` mark where the work happens.  They
are on while a ``torch.profiler`` records, and off otherwise, where they
cost one check of the profiler's flag each: ``span`` returns a shared
null context and ``count`` returns; neither reads a tensor or
synchronises.  On, a span enters ``torch.profiler.record_function``, so
it lands in the profiler's Chrome trace as a ``user_annotation`` event on
the clock of the kernels, copies and runtime calls it launches; the
profiler holds the spans and writes them out at export.  Spans never
synchronise: device time is put down to a span through the launches made
inside it, which a reader of the trace links to their kernels by
``args.correlation``.  ``count`` adds a Python ``int`` (a size the host
already knows) to counter ``name`` as an empty ``user_annotation``
event ``<name>+=<n>`` of the same trace, so a trace holds its own
session's counts and nothing else; a tensor raises ``TypeError``, so no
counter forces a read-back.

``step`` is a span that also synchronises and adds wall seconds to a
``walls`` dict when the caller passes one.  ``add``, ``metrics`` and
``reset_metrics`` hold the command line's ``<workspace>/Metrics/
<command>.json``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_METRICS: Dict[str, float] = {}
_NULL = contextlib.nullcontext()


def _on() -> bool:
    # a torch without the flag leaves the tracer off
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def span(name: str):
    """A context that marks ``name`` in the profiler's trace while a
    profiler records, and a shared null context otherwise."""
    if not _on():
        return _NULL
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n``, a Python ``int``, to counter ``name`` in the profiler's
    trace while a profiler records."""
    if not _on():
        return
    if not isinstance(n, int):
        raise TypeError(f"counter {name!r} takes a Python int, got "
                        f"{type(n).__name__}")
    with torch.profiler.record_function(f"{name}+={n}"):
        pass


@contextlib.contextmanager
def step(walls, name: str, device):
    """A span ``name``; when ``walls`` is a dict, also its wall seconds
    into ``walls[name]``, synchronising the device before and after."""
    with span(name):
        if walls is None:
            yield
            return
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0


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
