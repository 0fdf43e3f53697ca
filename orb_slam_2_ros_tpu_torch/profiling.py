"""Where the time goes on the card: a tracked frame, a mapping step, or
loop closing's programs.

    python -m orb_slam_2_ros_tpu_torch.profiling            # tracking
    python -m orb_slam_2_ros_tpu_torch.profiling mapping    # local mapping
    python -m orb_slam_2_ros_tpu_torch.profiling loop       # loop closing
    python -m orb_slam_2_ros_tpu_torch.profiling reloc      # relocalization
    python -m orb_slam_2_ros_tpu_torch.profiling mono       # mono init, VO

**Tracking.** Tracks the first 72 frames of ``chip_smoke.py``'s 96-frame synthetic orbit
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
  launch counts for the innermost stage only;
- the matcher kernel's device time per launch, by its name in the
  profiler's ``key_averages()``: the kernel's time in the path, on the
  arguments and between the neighbours the tracking step gives it.

The top kernels by device time and the stage table also go to
``chiprun_out/profile_tracking.txt``. The last line is a JSON summary.

**Mapping.** Runs ``System(cfg, enable_loop_closing=False)`` over
``chip_smoke.py``'s 224-frame synthetic loop in chunks of 16. Every call of
the mapper is timed with the host clock between two synchronisations, so a
chunk's wall time splits into tracking and mapping. The executed steps
named in ``PROFILED_STEPS`` run under ``torch.profiler`` with a
``record_function`` range around each part of the step; the others run
unprofiled. It prints, from this one process: per chunk the wall seconds
of tracking and of mapping; per executed step its wall ms and what it did
(free cameras and points, BA iterations, points spawned, fused, culled);
over the profiled steps, per step: device busy ms, kernel launches, the
idle share, the stage table, and the matcher kernel's launches and mean
device time; and the executed steps' share of their chunks' wall time and
of the whole run's. The table and the top kernels also go to
``chiprun_out/profile_mapping.txt``; the last line is a JSON summary.

**Loop.** Trains the in-domain vocabulary and runs ``System(cfg,
vocab=voc)``, all defaults, over the same loop in chunks of 16, then
``flush()``. Every call of the loop closer (``dispatch``: ingest + detect;
``consume_host`` with a candidate: the Sim3 ladder and, if accepted, the
correction; ``step_background`` with a global BA in flight: one chunk of 5
iterations, the last also the reconciliation) is timed with the host clock
between two synchronisations. The dispatches named in
``PROFILED_DISPATCHES``, every ladder and correction, and the first GBA
chunk run under ``torch.profiler`` with a ``record_function`` range around
each program and its parts (ingest/detect: transform, query, candidate
selection; the ladder: BoW pairing, RANSAC, the projection searches, the LM
refinement; the correction: the essential graph, the point correction, the
fuse sweep's searches; a GBA chunk). It prints per kind of call the wall ms
of the unprofiled and profiled calls, the device busy ms, launches, idle
share and stage table per call, and the matcher kernel's launches and mean
device time. The tables also go to ``chiprun_out/profile_loop.txt``; the
last line is a JSON summary.

**Relocalization.** Runs ``System(cfg)``, all defaults (loop closing on, so
the relocalizer is built; the vocabulary trained from the first chunk), over
the first 32 frames of the orbit, then calls ``System._attempt_reloc`` on
two frames against that map: frame 10, a view of the map (a successful
attempt), and a blind frame (zeros: no keypoints, a failed attempt). Each
is timed unprofiled ``RELOC_REPEATS`` times with the host clock between two
synchronisations, then once under ``torch.profiler`` with a
``record_function`` range around the attempt and its parts: the frame, the
BoW candidates (transform, query, candidate selection), the candidate
ladder (BoW matching, EPnP RANSAC, the pose LM over the 5 candidates) and
the widening (frustum check, the matcher kernel over the whole point pool,
the final LM; the ``pose_optimization`` row holds both LMs). It prints per
attempt the wall ms, device busy ms, launches, the idle share and the stage
table, and the matcher kernel's launches and mean device time; the tables
also go to ``chiprun_out/profile_reloc.txt``; the last line is a JSON
summary.

**Mono and VO.** A monocular ``System`` (loop closing off) takes the
orbit's frames one at a time until the two-view initializer succeeds; each
call of the initializer is timed with the host clock between two
synchronisations. A second system, seeded the same, repeats the calls and
runs the successful one under ``torch.profiler`` with a range around the
initializer's parts (the frame, ``search_for_initialization``,
``initialize``, ``_build_map`` and its structure-only BA). Then a
localization-only system on a map of the view straight ahead (the
scenario of ``tests/test_localization_vo.py`` at the full operating point)
tracks 25 frames that yaw the map out of view, unprofiled, and the next
frame twice: once timed, once under the profiler with the tracking stages'
ranges. It prints per case the wall ms, device busy ms, launches, idle
share and stage table, and the matcher kernel's launches and mean device
time; the tables also go to ``chiprun_out/profile_mono_vo.txt``; the last
line is a JSON summary.
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

from orb_slam_2_ros_tpu_torch.config import (SENSOR_MONOCULAR, SENSOR_RGBD,
                                             SlamConfig)
from orb_slam_2_ros_tpu_torch.frontend import extractor, matcher
from orb_slam_2_ros_tpu_torch.frontend import frame as frame_mod
from orb_slam_2_ros_tpu_torch.geometry import triangulate
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.ops import fast
from orb_slam_2_ros_tpu_torch.pipeline import (local_mapping, loop_closing,
                                               relocalization, tracking)
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.place import database, vocabulary
from orb_slam_2_ros_tpu_torch.solvers import (ba, pnp, pose_graph,
                                              sim3_solver)

FRAMES = 72
WINDOW = 4      # frames in the profiled and in the unprofiled window
OUT = os.path.join("chiprun_out", "profile_tracking.txt")
MAP_FRAMES = 224
MAP_OUT = os.path.join("chiprun_out", "profile_mapping.txt")
PROFILED_STEPS = (2, 4, 6)      # executed mapping steps, counted from 0
LOOP_OUT = os.path.join("chiprun_out", "profile_loop.txt")
PROFILED_DISPATCHES = (4, 8)    # calls of ``dispatch``, counted from 0
VOCAB_EVERY = 24                # frames whose descriptors train the vocabulary
RELOC_OUT = os.path.join("chiprun_out", "profile_reloc.txt")
MONO_OUT = os.path.join("chiprun_out", "profile_mono_vo.txt")
VO_FRAMES = 25                  # yawed frames before the profiled VO frame
RELOC_MAP_FRAMES = 32
RELOC_QUERY = 10                # a frame of the orbit that the map has seen
RELOC_REPEATS = 3               # unprofiled attempts of each kind
MATCHER_KERNEL = "masked_best_two_kernel"    # its name in the profile
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
# the parts of one mapping step, nested under the step's own range
MAP_STAGES = (
    (local_mapping, "_mapping_body", "mapping_step", 0),
    (map_state, "covisibility", "covisibility", 1),
    (local_mapping, "create_new_map_points", "create_new_map_points", 1),
    (matcher, "search_for_triangulation", "search_for_triangulation", 2),
    (triangulate, "triangulate_dlt", "triangulate_dlt", 2),
    (local_mapping, "fuse_duplicates", "fuse_duplicates", 1),
    (matcher, "search_by_projection_pose", "search_by_projection_pose", 2),
    (ba, "windowed_bundle_adjustment", "windowed_bundle_adjustment", 1),
    (local_mapping, "cull_keyframes", "cull_keyframes", 1),
    (map_state, "compact_points", "compact_points", 1),
    (map_state, "refresh_point_stats", "refresh_point_stats", 1),
)
# loop closing's programs and their parts; a part that several programs
# call (covisibility, the projection search) is one row
LOOP_STAGES = (
    (loop_closing, "_ingest_and_detect", "ingest_and_detect", 0),
    (map_state, "covisibility", "covisibility", 1),
    (vocabulary, "transform", "transform", 1),
    (vocabulary, "bow_weights", "bow_weights", 1),
    (database, "query", "query", 1),
    (database, "detect_candidates", "detect_candidates", 1),
    (loop_closing, "_sim3_check", "sim3_ladder", 0),
    (matcher, "search_by_node", "search_by_node", 1),
    (sim3_solver, "ransac_sim3", "ransac_sim3", 1),
    (matcher, "search_by_projection_pose", "search_by_projection_pose", 1),
    (sim3_solver, "refine_sim3_lm", "refine_sim3_lm", 1),
    (loop_closing, "_apply_correction", "apply_correction", 0),
    (pose_graph, "optimize_essential_graph", "essential_graph", 1),
    (pose_graph, "correct_points", "correct_points", 1),
    (loop_closing, "_gba_start", "gba_start", 0),
    (loop_closing, "_gba_step", "gba_chunk", 0),
    (loop_closing, "_gba_finish", "gba_finish", 0),
)

# one relocalization attempt and its parts
RELOC_STAGES = (
    (relocalization, "relocalize", "attempt", 0),
    (relocalization, "_candidates", "bow_candidates", 1),
    (vocabulary, "transform", "transform", 2),
    (database, "query", "query", 2),
    (database, "detect_candidates", "detect_candidates", 2),
    (relocalization, "_candidate_ladder", "candidate_ladder", 1),
    (matcher, "search_by_node", "search_by_node", 2),
    (pnp, "ransac_pnp", "ransac_pnp", 2),
    (relocalization, "_widen", "widening", 1),
    (matcher, "frustum_check", "frustum_check", 2),
    (matcher, "search_local_map", "search_local_map", 2),
    (relocalization, "pose_optimization", "pose_optimization", 2),
    (frame_mod, "build_rgbd", "build_frame", 0),
)


def _ranged(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def stage_ranges(stages=STAGES):
    """Wrap every stage of ``stages`` in a named profiler range."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in stages]
    try:
        for mod, attr, name, _ in stages:
            setattr(mod, attr, _ranged(getattr(mod, attr), name))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _stage_of(event, names):
    """The innermost stage range that encloses a host event, or None."""
    e = event.cpu_parent
    while e is not None:
        if e.name in names:
            return e.name
        e = e.cpu_parent
    return None


def summarize(events, n, stages=STAGES, unit="frame"):
    """Device busy time, launch counts and the per-stage table of one
    profiled window (or several, their events concatenated), from
    ``prof.events()``, each divided by ``n``, the window's count of
    ``unit``s (frames, or mapping steps)."""
    names = {name for _, _, name, _ in stages}
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy_us = sum(k.duration for e in host for k in e.kernels)
    n_device_ops = sum(len(e.kernels) for e in host)
    launches = [e for e in host if e.name in LAUNCH_CALLS]
    per = {name: {"calls": 0, "host_us": 0.0, "device_us": 0.0, "launches": 0}
           for name in names}
    for e in host:
        if e.name in names:
            row = per[e.name]
            row["calls"] += 1
            row["host_us"] += e.cpu_time_total
            row["device_us"] += e.device_time_total
    for e in launches:
        stage = _stage_of(e, names)
        if stage is not None:
            per[stage]["launches"] += 1
    rows = []
    for _, _, name, depth in stages:
        row = per[name]
        rows.append({
            "stage": name, "depth": depth,
            f"calls_per_{unit}": row["calls"] / n,
            f"host_ms_per_{unit}": row["host_us"] / 1e3 / n,
            f"device_ms_per_{unit}": row["device_us"] / 1e3 / n,
            f"launches_per_{unit}": row["launches"] / n})
    return {f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
            f"device_ops_per_{unit}": n_device_ops / n,
            f"launches_per_{unit}": len(launches) / n,
            "stages": rows}


def raw_counts(prof):
    """Kernel launches and device-busy ms of a profiled window, read from
    the profiler's raw events: the launches ``summarize`` counts, without
    building its event tree, which takes seconds per 10,000 events (a
    chunk of the mesh's global BA makes about 70,000 launches)."""
    launches, busy_ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.name() in LAUNCH_CALLS:
            launches += 1
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ns += e.duration_ns()
    return launches, busy_ns / 1e6


def kernel_by_name(averages, name):
    """Launches and mean device us per launch of the kernels whose name
    contains ``name``, from ``prof.key_averages()``."""
    rows = [a for a in averages if name in a.key and a.device_time_total > 0]
    count = sum(a.count for a in rows)
    total_us = sum(a.device_time_total for a in rows)
    return {"launches": count,
            "mean_device_us": total_us / count if count else None}


def stage_table(stages, unit="frame"):
    lines = [f"{'stage':34s} {'calls':>6s} {'host ms':>9s} {'device ms':>10s} "
             f"{'launches':>9s}   (per {unit})"]
    for s in stages:
        name = "  " * s["depth"] + s["stage"]
        lines.append(f"{name:34s} {s[f'calls_per_{unit}']:6.2f} "
                     f"{s[f'host_ms_per_{unit}']:9.3f} "
                     f"{s[f'device_ms_per_{unit}']:10.4f} "
                     f"{s[f'launches_per_{unit}']:9.1f}")
    return "\n".join(lines)


def _card():
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return smi


def main():
    smi = _card()
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    ds = SyntheticRGBD(cfg, n_frames=96, seed=0, trajectory="orbit")
    n, w = FRAMES, WINDOW
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])

    tracker = tracking.Tracker(cfg)
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
    averages = prof.key_averages()
    matcher_kernel = kernel_by_name(averages, MATCHER_KERNEL)
    if matcher_kernel["launches"] != 4 * w:
        raise AssertionError(
            f"the profile holds {matcher_kernel['launches']} launches of "
            f"{MATCHER_KERNEL}, {w} frames make {4 * w}")
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
        "matcher_kernel": matcher_kernel, **summary}

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
    print(f"{MATCHER_KERNEL}: {matcher_kernel['launches']} launches in the "
          f"profiled window, mean device time "
          f"{matcher_kernel['mean_device_us']:.3f} us per launch")
    print(table)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(smi + "\n" + table + "\n\n")
        f.write(averages.table(sort_by="self_device_time_total",
                               row_limit=40))
    print(json.dumps(result), flush=True)


def step_numbers(step):
    """A mapping step's record (``LocalMapper.last_step``) as host numbers."""
    return {k: (int(v) if isinstance(v, torch.Tensor) else v)
            for k, v in step.items()}


def main_mapping():
    smi = _card()
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = MAP_FRAMES
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0, trajectory="loop")
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])
    system = System(cfg, enable_loop_closing=False)
    mapper = system.mapper
    C = system.tracker.CHUNK
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls, profiles = [], []      # one entry per call of the mapper
    run = mapper.run

    def timed_run(m, last_mp, **kwargs):
        executes = mapper.has_work(kwargs["n_kfs"])
        profiled = executes and mapper.n_executed in PROFILED_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            with stage_ranges(MAP_STAGES), \
                    torch.profiler.profile(activities=acts) as prof:
                out = run(m, last_mp, **kwargs)
                torch.cuda.synchronize()
            profiles.append(prof)
        else:
            out = run(m, last_mp, **kwargs)
            torch.cuda.synchronize()
        calls.append({"executed": executes, "profiled": profiled,
                      "seconds": time.perf_counter() - t0,
                      **(step_numbers(mapper.last_step) if executes else {})})
        return out

    mapper.run = timed_run
    chunk_s = []
    for w0 in range(0, n, C):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.track_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                           ds.timestamps[w0:w0 + C])
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    n_ok = sum(r.state == tracking.OK for r in system.records)

    for i, (c, total) in enumerate(zip(calls, chunk_s)):
        line = (f"chunk {i:2d}: tracking {total - c['seconds']:.3f} s, "
                f"mapping {c['seconds']:.3f} s")
        if c["executed"]:
            line += (f" ({'profiled' if c['profiled'] else 'unprofiled'}: "
                     f"{c['n_ba_cams']} free cameras, {c['n_ba_free']} free "
                     f"points, BA iterations {c['ba_iters']}, spawned "
                     f"{c['n_spawned']}, fused {c['n_fused']}, culled "
                     f"{c['n_culled']}, keyframes culled {c['n_kf_culled']})")
        print(line, flush=True)

    n_prof = len(profiles)
    events = [e for prof in profiles for e in prof.events()]
    summary = summarize(events, n_prof, MAP_STAGES, unit="step")
    launches = sum(kernel_by_name(p.key_averages(), MATCHER_KERNEL)["launches"]
                   for p in profiles)
    device_us = sum(a.device_time_total for p in profiles
                    for a in p.key_averages() if MATCHER_KERNEL in a.key)
    if launches != 8 * n_prof:
        raise AssertionError(
            f"the profiles hold {launches} launches of {MATCHER_KERNEL}, "
            f"{n_prof} mapping steps make {8 * n_prof}")
    executed = [i for i, c in enumerate(calls) if c["executed"]]
    plain = [calls[i]["seconds"] for i in executed[1:]
             if not calls[i]["profiled"]]
    prof_s = [c["seconds"] for c in calls if c["profiled"]]
    wall_plain = 1e3 * sum(plain) / len(plain)
    wall_prof = 1e3 * sum(prof_s) / n_prof
    busy = summary["device_busy_ms_per_step"]
    step_s = sum(calls[i]["seconds"] for i in executed)
    result = {
        "card": smi, "frames": n, "ok_frames": n_ok,
        "keyframes": system.tracker.n_kfs,
        "map_points": int(system.tracker.map.n_mps),
        "steps_executed": len(executed), "steps_profiled": n_prof,
        "chunk_seconds": chunk_s, "mapper_calls": calls,
        "wall_ms_per_step_unprofiled_after_first": wall_plain,
        "wall_ms_per_step_profiled": wall_prof,
        "idle_share_vs_profiled_steps": 1.0 - busy / wall_prof,
        "idle_share_vs_unprofiled_steps": 1.0 - busy / wall_plain,
        "step_share_of_its_chunks": step_s / sum(chunk_s[i] for i in executed),
        "step_share_of_the_run": step_s / sum(chunk_s),
        "matcher_kernel": {"launches": launches,
                           "mean_device_us": device_us / launches},
        **summary}

    table = stage_table(summary["stages"], unit="step")
    print(f"{n_ok}/{n} frames OK, {result['keyframes']} keyframes, "
          f"{result['map_points']} map points; {len(executed)} mapping steps "
          f"executed, {n_prof} of them profiled")
    print(f"wall ms/step: unprofiled steps after the first {wall_plain:.3f}, "
          f"profiled steps {wall_prof:.3f}")
    print(f"device busy {busy:.3f} ms/step in "
          f"{summary['device_ops_per_step']:.0f} device ops/step; "
          f"{summary['launches_per_step']:.0f} kernel launches/step; idle "
          f"share {result['idle_share_vs_profiled_steps']:.4f} (profiled "
          f"steps), {result['idle_share_vs_unprofiled_steps']:.4f} "
          f"(unprofiled steps)")
    print(f"mapping is {result['step_share_of_its_chunks']:.4f} of the wall "
          f"time of the chunks that ran a step and "
          f"{result['step_share_of_the_run']:.4f} of the whole run")
    print(f"{MATCHER_KERNEL}: {launches} launches in the profiled steps, mean "
          f"device time {device_us / launches:.3f} us per launch")
    print(table)
    os.makedirs(os.path.dirname(MAP_OUT), exist_ok=True)
    with open(MAP_OUT, "w") as f:
        f.write(smi + "\n" + table + "\n\n")
        f.write(profiles[-1].key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    print(json.dumps(result), flush=True)


def main_loop():
    smi = _card()
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = MAP_FRAMES
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0, trajectory="loop")
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])
    voc = vocabulary.train_vocabulary_from_frames(
        grays, VOCAB_EVERY, cfg, seed=0, device="cuda")
    system = System(cfg, vocab=voc)
    lc = system.loop_closer
    C = system.tracker.CHUNK
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls = []          # every timed call: kind, seconds, profiled
    profiles = {"dispatch": [], "ladder": [], "gba_chunk": []}

    def timed(kind, fn, profile_it):
        def wrapped(*args, **kwargs):
            work, label = kind(args)
            if not work:
                return fn(*args, **kwargs)
            profiled = profile_it(label)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profiled:
                with stage_ranges(LOOP_STAGES), \
                        torch.profiler.profile(activities=acts) as prof:
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                profiles[label].append(prof)
            else:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            calls.append({"kind": label, "profiled": profiled,
                          "seconds": time.perf_counter() - t0})
            return out
        return wrapped

    n_dispatch = [0]

    def dispatch_profiled(_):
        n_dispatch[0] += 1
        return n_dispatch[0] - 1 in PROFILED_DISPATCHES

    lc.dispatch = timed(lambda a: (True, "dispatch"), lc.dispatch,
                        dispatch_profiled)
    lc.consume_host = timed(lambda a: (a[1] >= 0, "ladder"), lc.consume_host,
                            lambda _: True)
    lc.step_background = timed(
        lambda a: (lc.gba_running, "gba_chunk"), lc.step_background,
        lambda _: not profiles["gba_chunk"])
    for w0 in range(0, n, C):
        system.track_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                           ds.timestamps[w0:w0 + C])
    system.flush()
    n_ok = sum(r.state == tracking.OK for r in system.records)

    result = {"card": smi, "frames": n, "ok_frames": n_ok,
              "loops_closed": lc.n_loops_closed, "ladders": lc.n_ladders,
              "corrections": lc.n_corrections,
              "gba_finished": lc.n_gba_finished, "events": lc.events,
              "calls": calls, "kinds": {}}
    text = [smi]
    print(f"{n_ok}/{n} frames OK, {lc.n_loops_closed} loops closed, "
          f"{lc.n_ladders} ladders, {lc.n_corrections} corrections, "
          f"{lc.n_gba_finished} global BAs finished")
    for kind, profs in profiles.items():
        mine = [c for c in calls if c["kind"] == kind]
        plain = [1e3 * c["seconds"] for c in mine if not c["profiled"]]
        prof_ms = [1e3 * c["seconds"] for c in mine if c["profiled"]]
        if not profs:
            print(f"{kind}: no call was profiled ({len(mine)} calls)")
            continue
        events = [e for p in profs for e in p.events()]
        summary = summarize(events, len(profs), LOOP_STAGES, unit="call")
        launches = sum(kernel_by_name(p.key_averages(),
                                      MATCHER_KERNEL)["launches"]
                       for p in profs)
        device_us = sum(a.device_time_total for p in profs
                        for a in p.key_averages() if MATCHER_KERNEL in a.key)
        wall_prof = sum(prof_ms) / len(prof_ms)
        busy = summary["device_busy_ms_per_call"]
        # a table of the stages this kind of call ran
        ran = [r for r in summary["stages"] if r["calls_per_call"] > 0]
        table = stage_table(ran, unit="call")
        result["kinds"][kind] = {
            "calls": len(mine), "profiled": len(profs),
            "wall_ms_unprofiled_calls": plain,
            "wall_ms_profiled_calls": prof_ms,
            "idle_share_vs_profiled_calls": 1.0 - busy / wall_prof,
            "matcher_kernel": {
                "launches": launches,
                "mean_device_us": device_us / launches if launches else None},
            **{k: v for k, v in summary.items() if k != "stages"},
            "stages": ran}
        head = (f"{kind}: {len(mine)} calls, {len(profs)} profiled; wall ms "
                f"per profiled call {wall_prof:.3f}, unprofiled "
                f"{[round(x, 3) for x in plain]}; device busy {busy:.3f} "
                f"ms/call in {summary['launches_per_call']:.0f} launches; "
                f"idle share {1.0 - busy / wall_prof:.4f} (profiled calls); "
                f"{MATCHER_KERNEL}: {launches} launches"
                + (f", mean {device_us / launches:.3f} us" if launches
                   else ""))
        print(head)
        print(table)
        text += [head, table, profs[-1].key_averages().table(
            sort_by="self_device_time_total", row_limit=25), ""]
    os.makedirs(os.path.dirname(LOOP_OUT), exist_ok=True)
    with open(LOOP_OUT, "w") as f:
        f.write("\n".join(text))
    print(json.dumps(result), flush=True)


def main_reloc():
    smi = _card()
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = RELOC_MAP_FRAMES
    ds = SyntheticRGBD(cfg, n_frames=96, seed=0, trajectory="orbit")
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])
    system = System(cfg)
    system.track_chunk(grays, depths, ds.timestamps[:n])
    system.flush()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    blind = np.zeros_like(grays[0])
    cases = {"success": (grays[RELOC_QUERY], depths[RELOC_QUERY]),
             "failure": (blind, blind)}
    result = {"card": smi, "map_keyframes": system.tracker.n_kfs,
              "map_points": int(system.tracker.map.n_mps), "attempts": {}}
    text = [smi]
    print(f"map: {result['map_keyframes']} keyframes, "
          f"{result['map_points']} points after {n} frames")

    def attempt(gray, aux):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = system._attempt_reloc(*system._to_float_frame(gray, aux))[0]
        torch.cuda.synchronize()
        return ok, 1e3 * (time.perf_counter() - t0)

    for name, (gray, aux) in cases.items():
        walls = []
        for _ in range(RELOC_REPEATS):
            ok, ms = attempt(gray, aux)
            walls.append(ms)
        with stage_ranges(RELOC_STAGES), \
                torch.profiler.profile(activities=acts) as prof:
            ok_p, ms_p = attempt(gray, aux)
        if ok != (name == "success") or ok_p != ok:
            raise AssertionError(f"the {name} case gave ok={ok}, {ok_p}")
        summary = summarize(prof.events(), 1, RELOC_STAGES, unit="attempt")
        kern = kernel_by_name(prof.key_averages(), MATCHER_KERNEL)
        if kern["launches"] != relocalization.LAUNCHES:
            raise AssertionError(f"{kern['launches']} launches of "
                                 f"{MATCHER_KERNEL} in one attempt")
        busy = summary["device_busy_ms_per_attempt"]
        ran = [r for r in summary["stages"] if r["calls_per_attempt"] > 0]
        table = stage_table(ran, unit="attempt")
        result["attempts"][name] = {
            "ok": ok, "wall_ms_unprofiled": walls, "wall_ms_profiled": ms_p,
            "idle_share_vs_profiled": 1.0 - busy / ms_p,
            "idle_share_vs_unprofiled_mean": 1.0 - busy / np.mean(walls),
            "matcher_kernel": kern,
            **{k: v for k, v in summary.items() if k != "stages"},
            "stages": ran}
        head = (f"{name}: wall ms {[round(w, 3) for w in walls]} unprofiled, "
                f"{ms_p:.3f} profiled; device busy {busy:.3f} ms in "
                f"{summary['launches_per_attempt']:.0f} launches; idle share "
                f"{1.0 - busy / ms_p:.4f} (profiled), "
                f"{1.0 - busy / np.mean(walls):.4f} (unprofiled mean); "
                f"{MATCHER_KERNEL}: {kern['launches']} launch, "
                f"{kern['mean_device_us']:.3f} us")
        print(head)
        print(table)
        text += [head, table, prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=25), ""]
    os.makedirs(os.path.dirname(RELOC_OUT), exist_ok=True)
    with open(RELOC_OUT, "w") as f:
        f.write("\n".join(text))
    print(json.dumps(result), flush=True)


def _profiled(fn, stages, unit):
    """Run ``fn`` once timed with the host clock and once under the
    profiler with ``stages``' ranges. Returns (unprofiled ms, a summary
    dict, the stage table, the top kernels)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def timed(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    plain_ms = timed(fn[0])
    with stage_ranges(stages), \
            torch.profiler.profile(activities=acts) as prof:
        prof_ms = timed(fn[1])
    summary = summarize(prof.events(), 1, stages, unit=unit)
    busy = summary[f"device_busy_ms_per_{unit}"]
    ran = [r for r in summary["stages"] if r[f"calls_per_{unit}"] > 0]
    out = {"wall_ms_unprofiled": plain_ms, "wall_ms_profiled": prof_ms,
           "idle_share_vs_unprofiled": 1.0 - busy / plain_ms,
           "matcher_kernel": kernel_by_name(prof.key_averages(),
                                            MATCHER_KERNEL),
           **{k: v for k, v in summary.items() if k != "stages"},
           "stages": ran}
    return out, stage_table(ran, unit=unit), prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25)


def main_mono():
    from orb_slam_2_ros_tpu_torch.io.synthetic import make_room, render
    from orb_slam_2_ros_tpu_torch.pipeline import mono_init
    from orb_slam_2_ros_tpu_torch.solvers import initializer

    smi = _card()
    ds = SyntheticRGBD(SlamConfig(sensor=SENSOR_RGBD), n_frames=96, seed=0,
                       trajectory="orbit")
    mono = SlamConfig(sensor=SENSOR_MONOCULAR)
    first = System(mono, enable_loop_closing=False).mono_init
    init_ms, frames = [], []
    for i in range(8):
        frames.append(ds[i][0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = first.process(frames[-1], i)
        torch.cuda.synchronize()
        init_ms.append(1e3 * (time.perf_counter() - t0))
        if out is not None:
            break
    if out is None:
        raise AssertionError("the initializer did not succeed in 8 frames")
    # two more initializers seeded the same, each up to the successful call
    again, replay = (System(mono, enable_loop_closing=False).mono_init
                     for _ in range(2))
    for mi in (again, replay):
        for j, g in enumerate(frames[:-1]):
            mi.process(g, j)
    stages = (
        (mono_init.MonoInitializer, "process", "init_attempt", 0),
        (frame_mod, "build_mono", "build_frame", 1),
        (matcher, "search_for_initialization", "search_for_initialization",
         1),
        (initializer, "initialize", "initialize", 1),
        (mono_init, "_build_map", "build_map", 1),
        (ba, "bundle_adjustment", "structure_only_ba", 2),
        (map_state, "refresh_point_stats", "refresh_point_stats", 2))
    i = len(frames) - 1
    init, init_table, init_top = _profiled(
        (lambda: again.process(frames[-1], i),
         lambda: replay.process(frames[-1], i)), stages, "init")
    init["calls_ms"] = init_ms
    init["init_frame"] = i

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    planes = make_room(0)

    def view(yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return render(planes, R, np.zeros(3, np.float32), cfg.camera)

    g0, d0 = view(0.0)
    base = tracking.Tracker(cfg)
    base.process(g0, d0, 0.0)
    loc = tracking.Tracker(cfg.replace(localization_only=True))
    loc.attach_map(base.map)
    yaws = np.linspace(0.0, 1.3, VO_FRAMES + 2)
    views = [view(y) for y in yaws]
    loc.process_chunk(np.stack([v[0] for v in views[:VO_FRAMES]]),
                      np.stack([v[1] for v in views[:VO_FRAMES]]),
                      list(range(VO_FRAMES)))
    carry = loc.carry
    recs = []

    def vo_frame(k):
        def run():
            loc.carry = carry
            recs.append(loc.process(*views[k], float(k)))
        return run

    vo, vo_table, vo_top = _profiled((vo_frame(VO_FRAMES), vo_frame(
        VO_FRAMES)), STAGES, "frame")
    vo["record"] = {"state": recs[-1].state,
                    "n_inliers": recs[-1].n_inliers,
                    "n_map_inliers": recs[-1].n_map_inliers}
    if vo["matcher_kernel"]["launches"] != 6:
        raise AssertionError(f"a VO frame made {vo['matcher_kernel']} "
                             f"launches of {MATCHER_KERNEL}, not 6")
    text = [smi]
    for name, unit, res, table, top in (
            ("mono init", "init", init, init_table, init_top),
            ("VO frame", "frame", vo, vo_table, vo_top)):
        head = (f"{name}: wall ms {res['wall_ms_unprofiled']:.3f} "
                f"unprofiled, {res['wall_ms_profiled']:.3f} profiled; device "
                f"busy {res[f'device_busy_ms_per_{unit}']:.3f} ms in "
                f"{res[f'launches_per_{unit}']:.0f} launches; idle share "
                f"{res['idle_share_vs_unprofiled']:.4f} (unprofiled); "
                f"{MATCHER_KERNEL}: {res['matcher_kernel']['launches']} "
                f"launches")
        print(head)
        print(table)
        text += [head, table, top, ""]
    print(f"mono init: the successful call was frame {i}; every call "
          f"{[round(x, 1) for x in init_ms]} ms; VO frame: {vo['record']}")
    os.makedirs(os.path.dirname(MONO_OUT), exist_ok=True)
    with open(MONO_OUT, "w") as f:
        f.write("\n".join(text))
    print(json.dumps({"card": smi, "mono_init": init, "vo_frame": vo}),
          flush=True)


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["mapping"]:
        main_mapping()
    elif sys.argv[1:] == ["loop"]:
        main_loop()
    elif sys.argv[1:] == ["reloc"]:
        main_reloc()
    elif sys.argv[1:] == ["mono"]:
        main_mono()
    elif sys.argv[1:]:
        raise SystemExit("usage: python -m orb_slam_2_ros_tpu_torch.profiling "
                         "[mapping|loop|reloc|mono]")
    else:
        main()
