"""Where a tracked frame's time goes on the card, from one run.

    python -m orb_slam_2_ros_tpu_torch.profiling

Tracks the first 72 frames of ``chip_smoke.py``'s 96-frame synthetic orbit
at the reference operating point on ``cuda``. Frames 0-63 run first, in
unprofiled chunks of 16 timed with the host clock. Frames 64-71 are then
tracked as two windows of 4: the first under
``torch.profiler`` (CPU and CUDA activity), the second unprofiled right
after it. Every number printed comes from this one process:

- wall ms/frame of the unprofiled chunks and of both windows;
- device busy ms/frame in the profiled window: the summed duration of
  every kernel, copy and fill the window put on the card;
- the idle share, 1 - busy / wall, against the profiled window's own wall
  time (the profiler slows the host, so this over-states idleness), the
  unprofiled window's and the unprofiled chunks' after the first;
- kernel launches per frame (runtime launch calls in the profiled window);
- per stage: host ms/frame (the stage's range on the host clock), device
  ms/frame and launches/frame. Stages are ``record_function`` ranges put
  around the tracking step's calls for the profiled window only; they do
  not synchronise. A stage's parts are indented under it (the extractor's
  under ``build_frame``, the tracking step's under ``frame_step``), and a
  launch counts for the innermost stage only.

The top kernels by device time and the stage table also go to
``chiprun_out/profile_tracking.txt``. The last line is a JSON summary.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import extractor, matcher
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.ops import fast
from orb_slam_2_ros_tpu_torch.pipeline import tracking

FRAMES = 72
WINDOW = 4      # frames in the profiled and in the unprofiled window
OUT = os.path.join("chiprun_out", "profile_tracking.txt")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")

# (module, attribute, stage name, depth); the attribute is looked up
# through the module at call time, so replacing it wraps every call
STAGES = (
    (tracking, "build_frame", "build_frame", 0),
    (extractor, "resize_linear", "resize_linear", 1),
    (fast, "fast_score_map", "fast_score_map", 1),
    (fast, "detect", "detect", 1),
    (extractor, "_top_budget", "budget_cut", 1),
    (extractor, "gaussian_blur_7x7", "gaussian_blur", 1),
    (extractor, "ic_angles_at", "ic_angles", 1),
    (extractor, "_descriptors", "descriptors", 1),
    (tracking, "_frame_step", "frame_step", 0),
    (matcher, "search_by_projection_pose", "search_by_projection_pose", 1),
    (matcher, "search_reference_kf", "search_reference_kf", 1),
    (tracking, "pose_optimization", "pose_optimization", 1),
    (matcher, "frustum_check", "frustum_check", 1),
    (matcher, "search_local_map", "search_local_map", 1),
    (map_state, "bump_visibility", "bump_visibility", 1),
    (map_state, "commit_keyframe", "commit_keyframe", 1),
)
STAGE_NAMES = {name for _, _, name, _ in STAGES}


def _ranged(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def stage_ranges():
    """Wrap every stage of ``STAGES`` in a named profiler range."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in STAGES]
    try:
        for mod, attr, name, _ in STAGES:
            setattr(mod, attr, _ranged(getattr(mod, attr), name))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _stage_of(event):
    """The innermost stage range that encloses a host event, or None."""
    e = event.cpu_parent
    while e is not None:
        if e.name in STAGE_NAMES:
            return e.name
        e = e.cpu_parent
    return None


def summarize(events, n_frames):
    """Device busy time, launch counts and the per-stage table of one
    profiled window, from ``prof.events()``."""
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy_us = sum(k.duration for e in host for k in e.kernels)
    n_device_ops = sum(len(e.kernels) for e in host)
    launches = [e for e in host if e.name in LAUNCH_CALLS]
    per = {name: {"calls": 0, "host_us": 0.0, "device_us": 0.0, "launches": 0}
           for name in STAGE_NAMES}
    for e in host:
        if e.name in STAGE_NAMES:
            row = per[e.name]
            row["calls"] += 1
            row["host_us"] += e.cpu_time_total
            row["device_us"] += e.device_time_total
    for e in launches:
        stage = _stage_of(e)
        if stage is not None:
            per[stage]["launches"] += 1
    stages = []
    for _, _, name, depth in STAGES:
        row = per[name]
        stages.append({
            "stage": name, "depth": depth,
            "calls_per_frame": row["calls"] / n_frames,
            "host_ms_per_frame": row["host_us"] / 1e3 / n_frames,
            "device_ms_per_frame": row["device_us"] / 1e3 / n_frames,
            "launches_per_frame": row["launches"] / n_frames})
    return {"device_busy_ms_per_frame": busy_us / 1e3 / n_frames,
            "device_ops_per_frame": n_device_ops / n_frames,
            "launches_per_frame": len(launches) / n_frames,
            "stages": stages}


def stage_table(stages):
    lines = [f"{'stage':34s} {'calls':>6s} {'host ms':>9s} {'device ms':>10s} "
             f"{'launches':>9s}   (per frame)"]
    for s in stages:
        name = "  " * s["depth"] + s["stage"]
        lines.append(f"{name:34s} {s['calls_per_frame']:6.2f} "
                     f"{s['host_ms_per_frame']:9.3f} "
                     f"{s['device_ms_per_frame']:10.4f} "
                     f"{s['launches_per_frame']:9.1f}")
    return "\n".join(lines)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    ds = SyntheticRGBD(cfg, n_frames=96, seed=0, trajectory="orbit")
    n, w = FRAMES, WINDOW
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])

    tracker = tracking.Tracker(cfg, device="cuda")
    C = tracker.CHUNK
    n_chunks = (n - 2 * w) // C

    def timed(f0, f1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.process_chunk(grays[f0:f1], depths[f0:f1],
                              ds.timestamps[f0:f1])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    chunk_s = [timed(c * C, (c + 1) * C) for c in range(n_chunks)]
    f0 = n_chunks * C
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with stage_ranges(), torch.profiler.profile(activities=acts) as prof:
        prof_s = timed(f0, f0 + w)
    plain_s = timed(f0 + w, f0 + 2 * w)
    n_ok = sum(r.state == tracking.OK for r in tracker.records)

    summary = summarize(prof.events(), w)
    steady = chunk_s[1:]
    wall_chunks = 1e3 * sum(steady) / (C * len(steady))
    wall_prof = 1e3 * prof_s / w
    wall_plain = 1e3 * plain_s / w
    busy = summary["device_busy_ms_per_frame"]
    result = {
        "card": smi, "frames": n, "ok_frames": n_ok,
        "chunk_seconds": chunk_s,
        "wall_ms_per_frame_chunks_2_on": wall_chunks,
        "wall_ms_per_frame_profiled_window": wall_prof,
        "wall_ms_per_frame_unprofiled_window": wall_plain,
        "idle_share_vs_profiled_window": 1.0 - busy / wall_prof,
        "idle_share_vs_unprofiled_window": 1.0 - busy / wall_plain,
        "idle_share_vs_chunks_2_on": 1.0 - busy / wall_chunks,
        **summary}

    table = stage_table(summary["stages"])
    print(f"frames {f0}-{f0 + w - 1} profiled, {f0 + w}-{f0 + 2 * w - 1} "
          f"unprofiled; {n_ok}/{n} frames OK")
    print(f"wall ms/frame: chunks 2-{n_chunks} {wall_chunks:.3f}, profiled "
          f"window {wall_prof:.3f}, unprofiled window {wall_plain:.3f}")
    print(f"device busy {busy:.3f} ms/frame in "
          f"{summary['device_ops_per_frame']:.0f} device ops/frame; "
          f"{summary['launches_per_frame']:.0f} kernel launches/frame; idle "
          f"share {result['idle_share_vs_profiled_window']:.4f} (profiled "
          f"window), {result['idle_share_vs_unprofiled_window']:.4f} "
          f"(unprofiled window), {result['idle_share_vs_chunks_2_on']:.4f} "
          f"(chunks 2-{n_chunks})")
    print(table)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(smi + "\n" + table + "\n\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
