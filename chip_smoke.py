#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. card: nvidia-smi's name and power limit; torch, CUDA and nvcc versions;
  2. build: compile every kernel of the port from csrc/ (seconds);
  3. kernel check: the CUDA ``masked_best_two`` against its plain PyTorch
     version on the same CUDA tensors, exact equality of all four outputs:
     at the tracking path's shapes (1536 x 1536 motion-model search,
     4096 x 1536 local-map search) and at ragged and edge shapes (N and M
     no multiple of any tile, M = 1, M = 32767, no column passing, every
     gate open);
  4. kernel time at the path's two shapes: 200 launches replayed from one
     CUDA graph (the kernel's own time), 200 calls of the wrapper in a row
     on the stream (device and host time per call, under their own names),
     the empty kernel the same two ways (the card's launch floor), the
     plain version, and the bound computed from the case's bytes and
     operations;
  5. main path: ``Tracker(cfg)`` (the card is the default device) at the
     reference operating point (640x480, 1200 features, 8 levels, map of
     256 keyframes by 16384 points) over the 96-frame synthetic orbit in
     chunks of 16; every frame must be OK, ATE < 0.01 m, 4 keyframes and
     1931 map points, the map on the card, and the kernel launched exactly
     as often as the path says (4 per frame: the motion-model search and
     its predicated widened retry, the reference-keyframe search, the
     local-map search);
  6. the kernel on the path's own arguments (the four calls of frame 48,
     recorded during phase 5): equality with the plain version, and times
     as in phase 4;
  7. mapping path: ``System(cfg, enable_loop_closing=False)`` (RGB-D, BA
     window 10, the card) at the same operating point over the 224-frame
     synthetic loop in chunks of 16: tracking plus the full local-mapping
     step (triangulation, fusion, windowed BA, culling, compaction) after
     every chunk that inserted a keyframe. Every frame must be OK, the map
     on the card, the mapper executed exactly on the chunks with a
     keyframe, the kernel launched 4 times per frame plus 8 times per
     executed step (fusion: 4 neighbours, both directions), triangulation
     and culling both at work, the point pool a live count with no
     dangling id, no BA phase ending above the cost it started from, and
     the ATE of the composed trajectory below its limit. Per chunk the
     wall seconds of tracking and mapping, per step what it did;
  8. the kernel on the arguments of one fusion call (both directions of
     the first neighbour, recorded in phase 7): equality with the plain
     version, and times as in phase 4.

The frames are rendered on the host by worker processes that end before
tracking starts. The last two lines are a JSON summary of the kernels and
the JSON result.
Any failure raises, so the exit code is not 0. Without a CUDA device the
script exits at once with an error and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ATE_LIMIT_M = 0.01
N_FRAMES = 96
N_KEYFRAMES = 4         # what the orbit gives at this operating point: the
N_MAP_POINTS = 1931     # kernel is exact, so these do not move with it
CAPTURE_FRAME = 48
N_LOOP_FRAMES = 224
CAPTURE_STEP = 3        # the executed mapping step whose fusion calls are kept
# composed-trajectory ATE of the mapping path, rigid alignment: 1.5 x the
# 0.088893 m measured on an NVIDIA H100 80GB HBM3 at 700.00 W
LOOP_ATE_LIMIT_M = 0.133
RENDER_WORKERS = 6
# (N, M, gates) beside the path's two shapes
EDGE_CASES = ((1531, 1237, "random"), (77, 1, "random"), (64, 32767, "random"),
              (300, 500, "closed"), (257, 333, "open"))


def log(msg):
    print(msg, flush=True)


def command_output(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def check_kernel(torch, match_kernel, bench):
    """Phase 3. Returns the largest absolute difference (0) and the device
    tensors of the path's two shapes, for phase 4."""
    worst = 0
    cases = [(N, M, "random") for N, M in bench.PATH_SHAPES]
    kept = []
    for seed, (N, M, gates) in enumerate(cases + list(EDGE_CASES)):
        args = tuple(torch.from_numpy(x).cuda()
                     for x in bench.make_case(N, M, seed, gates))
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        worst = max(worst, bench.assert_equal(
            got, want, f"masked_best_two {N}x{M} ({gates} gates)"))
        has = int((want[1] < 1024).sum())
        if gates == "closed" and has != 0:
            raise AssertionError("the closed case let a column pass")
        if gates == "open" and has != N:
            raise AssertionError("the open case left a row without a match")
        log(f"kernel check {N}x{M} ({gates} gates): all four outputs equal "
            f"({has}/{N} rows with a candidate)")
        if seed < len(cases):
            kept.append((f"random {N}x{M}", args))
    return worst, kept


def time_kernel(match_kernel, bench, timing, label, args, floor):
    """Phases 4 and 6 for one case: one line, and the numbers."""
    w = bench.work(args)
    t = bench.time_contender(None, args)
    plain_us, _ = timing.stream_us(
        lambda: match_kernel.masked_best_two_reference(*args), reps=20)
    log(f"kernel time {label} ({w['N']}x{w['M']}, {w['passes']} of "
        f"{w['pairs']} pairs pass): kernel_graph_us {t['graph_us']:.3f}, "
        f"kernel_stream_us {t['stream_us']:.3f}, wrapper_host_us_per_call "
        f"{t['host_us_per_call']:.3f}, plain_us {plain_us:.1f}, bound_us "
        f"{w['bound_us']:.3f} by {w['bound_by']} ({w['bytes']} B, {w['ops']} "
        f"ops), empty_kernel_graph_us {floor:.3f}")
    return {"case": label, **w, **t, "plain_us": plain_us}


def run_main_path(torch, match_kernel, bench, timing):
    """Phase 5. Returns the number of kernel launches on the path and the
    matcher's arguments in frame ``CAPTURE_FRAME``."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.io import ate_rmse, render_frames
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    t0 = time.perf_counter()
    ds, grays, depths = render_frames(cfg, N_FRAMES, RENDER_WORKERS, seed=0,
                                      trajectory="orbit")
    log(f"rendered {N_FRAMES} frames of {cfg.camera.width}x"
        f"{cfg.camera.height} in {time.perf_counter() - t0:.1f} s (host, "
        f"{RENDER_WORKERS} processes)")

    tracker = Tracker(cfg)
    if tracker.device.type != "cuda":
        raise AssertionError(f"Tracker(cfg) chose {tracker.device}")
    C = tracker.CHUNK
    chunk_s = []
    match_kernel.LAUNCHES = 0
    for w0 in range(0, N_FRAMES, C):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the chunk that starts at CAPTURE_FRAME also records its calls
        with timing.capture_calls(matcher, "masked_best_two") as calls:
            tracker.process_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                                  ds.timestamps[w0:w0 + C])
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        if w0 == CAPTURE_FRAME:
            path_args = bench.label_path_calls(calls[:4])
    launches = match_kernel.LAUNCHES

    recs = tracker.records
    n_ok = sum(r.state == OK for r in recs)
    est = np.stack([r.c_w for r in recs])
    gt = np.stack([ds.gt_pose_wc(i)[1] for i in range(N_FRAMES)])
    ate = float(ate_rmse(est, gt))
    steady = chunk_s[2:6]
    fps = C * len(steady) / sum(steady)
    log(f"main path: {n_ok}/{N_FRAMES} frames OK, ATE {ate:.6f} m, "
        f"{tracker.n_kfs} keyframes, {int(tracker.map.n_mps)} map points, "
        f"{launches} matcher kernel launches")
    log(f"main path: {fps:.2f} fps over chunks 3-6 (host clock, synchronized "
        f"per chunk); chunk seconds {[round(s, 4) for s in chunk_s]}")

    if n_ok != N_FRAMES:
        bad = [i for i, r in enumerate(recs) if r.state != OK]
        raise AssertionError(f"frames not OK: {bad}")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    off_card = [f for f, v in tracker.map._asdict().items() if not v.is_cuda]
    if off_card:
        raise AssertionError(f"map tensors off the card: {off_card}")
    expected = 4 * N_FRAMES
    if launches != expected:
        raise AssertionError(f"matcher kernel launched {launches} times, "
                             f"the path makes {expected}")
    if (tracker.n_kfs, int(tracker.map.n_mps)) != (N_KEYFRAMES, N_MAP_POINTS):
        raise AssertionError(
            f"{tracker.n_kfs} keyframes and {int(tracker.map.n_mps)} map "
            f"points; an exact matcher gives {N_KEYFRAMES} and {N_MAP_POINTS}")
    return launches, path_args


def run_mapping_path(torch, match_kernel, timing):
    """Phase 7. Returns the number of kernel launches on the path and the
    matcher's arguments in the two fusion calls of step ``CAPTURE_STEP``
    against its first neighbour."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.io import ate_rmse, render_frames
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = N_LOOP_FRAMES
    t0 = time.perf_counter()
    ds, grays, depths = render_frames(cfg, n, RENDER_WORKERS, seed=0,
                                      trajectory="loop")
    log(f"rendered {n} frames of the loop in {time.perf_counter() - t0:.1f} s "
        f"(host, {RENDER_WORKERS} processes)")

    system = System(cfg, enable_loop_closing=False)
    if system.device.type != "cuda":
        raise AssertionError(f"System(cfg) chose {system.device}")
    mapper = system.mapper
    run = mapper.run
    calls_of = []       # per call of the mapper: seconds, executed, step
    fusion_args = []

    def timed_run(m, last_mp, **kwargs):
        before = mapper.n_executed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timing.capture_calls(matcher, "masked_best_two") as calls:
            out = run(m, last_mp, **kwargs)
        torch.cuda.synchronize()
        executed = mapper.n_executed > before
        calls_of.append((time.perf_counter() - t0, executed,
                         mapper.last_step if executed else None, len(calls)))
        if executed and before == CAPTURE_STEP:
            fusion_args.extend(
                (label, tuple(a.clone() for a in args)) for label, args in zip(
                    ("path: fusion, newest keyframe into its neighbour",
                     "path: fusion, neighbour into the newest keyframe"),
                    calls[:2]))
        return out

    mapper.run = timed_run
    C = system.tracker.CHUNK
    chunk_s = []
    match_kernel.LAUNCHES = 0
    for w0 in range(0, n, C):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.track_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                           ds.timestamps[w0:w0 + C])
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = match_kernel.LAUNCHES

    recs = system.records
    kf_chunks = [any(r.is_keyframe for r in recs[w0:w0 + C])
                 for w0 in range(0, n, C)]
    totals = {"n_spawned": 0, "n_fused": 0, "n_culled": 0, "n_kf_culled": 0}
    for i, (total, (map_s, executed, step, n_calls)) in enumerate(
            zip(chunk_s, calls_of)):
        line = (f"chunk {i:2d}: tracking {total - map_s:.3f} s, mapping "
                f"{map_s:.3f} s")
        if executed:
            for key in totals:
                totals[key] += int(step[key])
            line += (f": {int(step['n_ba_cams'])} free cameras, "
                     f"{int(step['n_ba_free'])} free points, BA iterations "
                     f"{step['ba_iters']}, cost "
                     + ", ".join(f"{a:.1f} -> {b:.1f}"
                                 for a, b in step["ba_cost"])
                     + f", spawned {int(step['n_spawned'])}, fused "
                     f"{int(step['n_fused'])}, culled {int(step['n_culled'])}"
                     f", keyframes culled {int(step['n_kf_culled'])}, "
                     f"{n_calls} matcher calls")
            for start, end in step["ba_cost"]:
                if not (np.isfinite(end) and end <= start):
                    raise AssertionError(
                        f"chunk {i}: a BA phase went from {start} to {end}")
            if n_calls != 8:
                raise AssertionError(f"chunk {i}: the step made {n_calls} "
                                     f"matcher calls, fusion makes 8")
        log(line)

    n_ok = sum(r.state == OK for r in recs)
    steps = mapper.n_executed
    m = system.tracker.map
    gt_all = [ds.gt_pose_wc(i) for i in range(n)]
    live = float(ate_rmse(np.stack([r.c_w for r in recs]),
                          np.stack([c for _, c in gt_all])))
    poses, ts = system.tracker.composed_trajectory()
    index = {t: i for i, t in enumerate(ds.timestamps)}
    ate = float(ate_rmse(np.stack([c for _, c in poses]),
                         np.stack([gt_all[index[t]][1] for t in ts])))
    map_s = sum(c[0] for c in calls_of if c[1])
    log(f"mapping path: {n_ok}/{n} frames OK, ATE {ate:.6f} m (composed "
        f"through the keyframes; {live:.6f} m as tracked), "
        f"{system.tracker.n_kfs} keyframe rows ({int(m.kf_valid.sum())} "
        f"valid), {int(m.n_mps)} map points, {steps} mapping steps on "
        f"{sum(kf_chunks)} chunks with a keyframe, {launches} matcher kernel "
        f"launches, spawned {totals['n_spawned']}, fused {totals['n_fused']}, "
        f"culled {totals['n_culled']} ({system.n_culled_total}), keyframes "
        f"culled {totals['n_kf_culled']}")
    log(f"mapping path: {n / sum(chunk_s):.2f} fps over the whole run (host "
        f"clock, synchronized); mapping {map_s:.2f} s of {sum(chunk_s):.2f} "
        f"s, {1e3 * map_s / max(steps, 1):.1f} ms per executed step")

    if n_ok != n:
        bad = [i for i, r in enumerate(recs) if r.state != OK]
        raise AssertionError(f"frames not OK: {bad}")
    off_card = [f for f, v in m._asdict().items() if not v.is_cuda]
    if off_card:
        raise AssertionError(f"map tensors off the card: {off_card}")
    if [c[1] for c in calls_of] != kf_chunks:
        raise AssertionError(
            f"the mapper ran on chunks {[c[1] for c in calls_of]}, keyframes "
            f"arrived in {kf_chunks}")
    if launches != 4 * n + 8 * steps:
        raise AssertionError(f"matcher kernel launched {launches} times, the "
                             f"path makes {4 * n} + {8 * steps}")
    if not (totals["n_spawned"] > 0 and totals["n_fused"] > 0
            and totals["n_culled"] > 0):
        raise AssertionError(f"triangulation, fusion or culling idle: "
                             f"{totals}")
    if int(m.n_mps) != int(m.mp_valid.sum()):
        raise AssertionError(f"n_mps {int(m.n_mps)} but "
                             f"{int(m.mp_valid.sum())} valid points")
    held = m.kf_mp[m.kf_mp >= 0].long()
    if not bool(m.mp_valid[held].all()):
        raise AssertionError("an observation names an invalid map point")
    if not ate < LOOP_ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {LOOP_ATE_LIMIT_M} m")
    if len(fusion_args) != 2:
        raise AssertionError(f"step {CAPTURE_STEP} was not reached: "
                             f"{steps} steps")
    return launches, fusion_args


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs only on an NVIDIA card")
    from orb_slam_2_ros_tpu_torch import _build
    from orb_slam_2_ros_tpu_torch import bench_match_kernel as bench
    from orb_slam_2_ros_tpu_torch import kernel_timing as timing
    from orb_slam_2_ros_tpu_torch.ops import match_kernel

    # 1. card
    log(command_output(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]))
    nvcc = _build.find_nvcc()
    nvcc_ver = command_output([nvcc, "--version"]).splitlines()[-1] if nvcc \
        else "not found"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc_ver}, device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build("masked_best_two")
    log(f"built {os.path.relpath(lib)} in {time.perf_counter() - t0:.2f} s")

    # 3. kernel check
    err, shape_cases = check_kernel(torch, match_kernel, bench)

    # 4. kernel time at the path's shapes, and the launch floor
    empty = bench.empty_kernel_launcher()
    floor = timing.graph_us(empty)
    floor_stream, floor_host = timing.stream_us(empty)
    log(f"empty kernel: empty_kernel_graph_us {floor:.3f}, "
        f"empty_kernel_stream_us {floor_stream:.3f}, "
        f"empty_launch_host_us_per_call {floor_host:.3f}")
    timed = [time_kernel(match_kernel, bench, timing, label, args, floor)
             for label, args in shape_cases]

    # 5. main path
    launches, path_args = run_main_path(torch, match_kernel, bench, timing)

    # 6. the kernel on the path's own arguments
    for label, args in path_args:
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        err = max(err, bench.assert_equal(got, want, label))
        timed.append(time_kernel(match_kernel, bench, timing, label, args,
                                 floor))

    # 7. the mapping path
    map_launches, fusion_args = run_mapping_path(torch, match_kernel, timing)

    # 8. the kernel on one fusion call's own arguments, both directions
    for label, args in fusion_args:
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        err = max(err, bench.assert_equal(got, want, label))
        timed.append(time_kernel(match_kernel, bench, timing, label, args,
                                 floor))
    log(f"matcher kernel launches: {launches} on the tracking path, "
        f"{map_launches} on the mapping path")
    launches += map_launches

    # the headline numbers are the local-map search's, the largest call of
    # a frame: random gates at its shape; "cases" holds every case
    main_case = timed[1]
    log(json.dumps({"kernels": [{
        "name": "masked_best_two", "route": "cuda",
        "source": "orb_slam_2_ros_tpu_torch/csrc/masked_best_two.cu",
        "replaces": "orb_slam_2_ros_tpu/ops/pallas_match.py:121",
        "launches": launches, "max_abs_err": err,
        "launches_by_path": {"tracking": launches - map_launches,
                             "mapping": map_launches},
        "ms": main_case["graph_us"] / 1e3,
        "plain_ms": main_case["plain_us"] / 1e3,
        "bound_ms": main_case["bound_us"] / 1e3,
        "bound_by": main_case["bound_by"], "library_ms": None,
        "bound_us": main_case["bound_us"], "floor_us": floor,
        "host_us_per_call": main_case["host_us_per_call"],
        "cases": timed}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
