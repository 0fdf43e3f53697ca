"""Host-side stage timers for the run summary.

This package's own copy of ``orb_slam_2_ros_tpu/pipeline/metrics.py``:
wall-clock accumulators per pipeline stage, read by ``System.metrics()``.
The times are the host's; work that the device finishes later is charged
to the stage that next waits for it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class StageTimers:
    """Wall-clock accumulators per pipeline stage."""

    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_s[stage] += time.perf_counter() - t0
            self.count[stage] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            s: {"total_ms": 1e3 * self.total_s[s],
                "mean_ms": 1e3 * self.total_s[s] / max(self.count[s], 1),
                "count": self.count[s]}
            for s in sorted(self.total_s)
        }
