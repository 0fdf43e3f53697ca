"""The traced segment's arithmetic: launches, device busy time, kernel time
by name, and the breakdown of device operations and idle gaps.

``LAUNCH_CALLS`` and the launch count are a frozen copy of
``orb_slam_2_ros_tpu_torch/profiling.py::raw_counts`` at commit
``b77b5cd74ef9125f0ac89662d885404aa9a6b150`` (launches are the runtime's
launch calls among the profiler's raw events, read without building the
event tree). Device busy time is the union of the device operations'
intervals, so that nothing counts twice; the profiler's own range markers
on the device timeline are left out.

Idle gaps are named by the innermost of the harness's ``record_function``
ranges (``RANGES``, put around its calls into the port's layers) that was
open on the host at the gap's midpoint; the host's clock and the device's
are the profiler's one timeline.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
OUTSIDE = "harness"         # a gap while no range of the harness was open
TOP = 10


def layer_ranges():
    """(owner, attribute, range name) of the port's calls the traced
    segment wraps: one name per layer of ``PERF.md``."""
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.pipeline import tracking
    from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import LocalMapper
    from orb_slam_2_ros_tpu_torch.pipeline.loop_closing import LoopCloser
    from orb_slam_2_ros_tpu_torch.pipeline.relocalization import Relocalizer
    return (
        (tracking, "build_frame", "frontend"),
        (tracking.Tracker, "process_chunk", "tracking"),
        (LocalMapper, "run", "local_mapping"),
        (LoopCloser, "dispatch", "loop_closing"),
        (LoopCloser, "step_background", "loop_closing"),
        (LoopCloser, "pop_lagged_verdict", "loop_closing"),
        (LoopCloser, "consume_host", "loop_closing"),
        (Relocalizer, "relocalize", "relocalization"),
        (matcher, "masked_best_two", "b1"),
    )


def _annotation(e) -> bool:
    test = getattr(e, "is_user_annotation", None)
    return bool(test()) if test is not None else False


def _ranged(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def ranges_around_layers():
    """Wrap each call of ``layer_ranges`` in its named range; restored on
    exit."""
    spots = layer_ranges()
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in spots]
    try:
        for owner, attr, name in spots:
            setattr(owner, attr, _ranged(getattr(owner, attr), name))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _innermost_segments(ranges: List[Tuple[int, int, str]]):
    """Nested host ranges -> sorted disjoint (start, end, name) segments,
    each named by the innermost range open over it."""
    bounds = sorted({t for s, e, _ in ranges for t in (s, e)})
    segs = []
    for a, b in zip(bounds, bounds[1:]):
        segs.append([a, b, None, None])
    starts = [s[0] for s in segs]
    # longest first, so shorter (inner) ranges overwrite outer ones
    for s, e, name in sorted(ranges, key=lambda r: r[0] - r[1]):
        i = bisect.bisect_left(starts, s)
        while i < len(segs) and segs[i][0] < e:
            if segs[i][3] is None or segs[i][3] > e - s:
                segs[i][2], segs[i][3] = name, e - s
            i += 1
    return starts, segs


def read(prof, range_names) -> Dict:
    """Launches, busy seconds, device seconds by operation name, and idle
    seconds by host range, from one profiled segment."""
    launches = 0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in LAUNCH_CALLS:
            launches += 1
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            # a range's mirror on the device timeline is no operation
            if not _annotation(e) and name not in range_names:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               name))
        elif name in range_names and e.device_type() == \
                torch.autograd.DeviceType.CPU:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    device.sort()
    by_op = defaultdict(int)
    busy_ns = 0
    gaps = []
    end = None
    for s, t, name in device:
        by_op[name] += t - s
        if end is None or s >= end:
            if end is not None and s > end:
                gaps.append((end, s))
            busy_ns += t - s
            end = t
        elif t > end:
            busy_ns += t - end
            end = t
    starts, segs = _innermost_segments(host)
    idle = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = OUTSIDE
        if 0 <= i < len(segs) and segs[i][0] <= mid < segs[i][1] \
                and segs[i][2] is not None:
            name = segs[i][2]
        idle[name] += b - a
    return {"launches": launches, "busy_s": busy_ns / 1e9,
            "device_ops": {k: v / 1e9 for k, v in by_op.items()},
            "idle_gaps": {k: v / 1e9 for k, v in idle.items()}}


def kernel_seconds(device_ops: Dict[str, float], fragment: str) -> float:
    """Device seconds of the kernels whose name contains ``fragment``."""
    return sum(v for k, v in device_ops.items() if fragment in k)


def top(d: Dict[str, float], n: int = TOP) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
