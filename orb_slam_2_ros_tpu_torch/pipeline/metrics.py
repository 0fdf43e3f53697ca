"""Host-side stage timers and the program's spans.

``StageTimers`` holds wall-clock accumulators per name, read by
``System.metrics()`` and ``System.timers``. The times are the host's; work
that the device finishes later is charged to the span that next waits for
it.

A ``span(name)`` is a context manager, or a decorator on the function it
measures. It adds its host seconds and a count of 1 under ``name`` to the
active ``StageTimers``: the one of the ``System`` whose entry point is
running (``entry_point``). With no active ``System`` it adds nothing, so a
layer called directly costs two clock reads. While ``torch.profiler``
records, and only then, the span also opens
``torch.profiler.record_function("slam." + name)``, so the program's spans
share the profiler's timeline with the device's operations. A span never
synchronises the device.

``count(name, n)`` is a counter: 0 s and ``n`` added to the count of
``name``, carried in ``System.timers`` like a span.

Nesting is by name: ``frontend.extract`` runs inside ``frontend``.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextvars import ContextVar
from typing import Dict

import torch

PREFIX = "slam."    # of the profiler's ranges, apart from any other range
_ACTIVE: ContextVar = ContextVar("slam_stage_timers", default=None)
_profiling = torch._C._autograd._profiler_enabled


class StageTimers:
    """Wall-clock accumulators and counts per span name."""

    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    def add(self, name: str, n: int):
        """A counter: ``n`` added to the count of ``name``, 0 s."""
        self.total_s[name] += 0.0
        self.count[name] += n

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            s: {"total_ms": 1e3 * self.total_s[s],
                "mean_ms": 1e3 * self.total_s[s] / max(self.count[s], 1),
                "count": self.count[s]}
            for s in sorted(self.total_s)
        }


class span:
    """``with span(name):`` or ``@span(name)``; see the module's doc."""

    __slots__ = ("name", "_timers", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._timers = _ACTIVE.get()
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        timers = self._timers
        if timers is not None:
            timers.total_s[self.name] += dt
            timers.count[self.name] += 1
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` of the active ``StageTimers``."""
    timers = _ACTIVE.get()
    if timers is not None:
        timers.add(name, n)


def entry_point(method):
    """Run a ``System`` method with the system's ``timers`` active."""
    @functools.wraps(method)
    def entered(self, *args, **kwargs):
        token = _ACTIVE.set(self.timers)
        try:
            return method(self, *args, **kwargs)
        finally:
            _ACTIVE.reset(token)
    return entered
