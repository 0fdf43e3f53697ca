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
     window 10, the card) at the same operating point over the first 112
     frames of the 224-frame synthetic loop (all 224 until phase 17 came
     to pay for) in chunks of 16: tracking plus the full local-mapping
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
     version, and times as in phase 4;
  9. the full system: a vocabulary (k = 10, 4 levels) trained on the
     descriptors of every 24th frame of the loop, then ``System(cfg,
     vocab=voc)``, all defaults (loop closing on, the card), over the same
     224 frames in chunks of 16 and ``flush()``. Every frame must be OK,
     the map on the card, at least one loop closed and one global BA
     finished, every keyframe ingested into the BoW database, the kernel
     launched 4 times per frame + 8 per mapping step + 3 per Sim3 ladder +
     9 per correction, the pool invariants of phase 7, every pose and
     point finite, and the composed ATE below its limit (printed beside
     the JAX reference's own full-size number). Per chunk the host seconds
     of tracking, mapping and loop closing, each ladder's outcome and the
     global BA's progress;
 10. the kernel on the arguments of the accepted ladder's three calls and
     of the correction's first fuse call (16384 x 1536), recorded in
     phase 9: equality with the plain version, and times as in phase 4;
 11. relocalization: ``System(cfg)``, all defaults (loop closing and with
     it relocalization on, the vocabulary trained from the first chunk),
     over a 32-frame synthetic orbit, then one chunk whose first half is
     blind (zeros) and whose second half revisits frames 8 onwards (the
     forced loss of ``tests/test_hard_sequences.py``). Every blind frame
     must be LOST and every visible one OK (relocalized at the first
     visible frame, the chunk replayed around it), the records must count
     each frame once, the relocalized poses lie within 0.08 m of the ground
     truth, and the kernel's launches, counted at its wrapper around every
     relocalization attempt (1 each: the widening over the whole point
     pool), close the phase's launch count with 4 per tracked frame (the
     replay included) and 8 per mapping step;
 12. the kernel on the successful attempt's widening call (16384 x 1536):
     equality with the plain version, and times as in phase 4;
 13. stereo: ``Tracker`` and then ``System(cfg, enable_loop_closing=False)``
     with ``SENSOR_STEREO`` at the same operating point over the 64-pair
     synthetic stereo orbit (the reference bench's two stereo passes):
     every frame OK, the kernel launched 4 times per frame plus 8 times per
     mapping step, the ATE of both below 0.05 m, and the kernel on the four
     calls of frame 48 equal to the plain version and timed as in phase 4;
     then the forced loss of phase 11 on a stereo ``System(cfg)`` (loop
     closing and relocalization on) over the first 32 pairs: relocalized
     at the first visible pair with ``build_stereo`` frames (the
     reference's own stereo relocalization builds RGB-D frames from the
     right image, a fault the port does not copy), 1 launch per attempt;
 14. mono: the reference bench's monocular pass,
     ``System(SlamConfig(sensor=SENSOR_MONOCULAR),
     enable_loop_closing=False)`` over the 96 frames of phase 5's orbit in
     chunks of 8: the first 32 (two-view initialization and warm-up), then
     the other 64. The initialization frame, every frame after the first OK
     frame OK, 64/64 OK over frames 32-95, the map on the card, every pose
     and point finite, the Sim3-aligned ATE below its limit (printed beside
     the reference's CPU number), the kernel launched 4 times per tracked
     frame plus 8 times per mapping step (the initializer's matching is no
     kernel call), and the kernel on one mono frame's four calls equal to
     the plain version and timed as in phase 4;
 15. map I/O, localization-only mode and map merge at full width: an RGB-D
     session over the first 48 frames of the loop saves its map and
     ``System(cfg, load_map=path)`` holds it equal field by field; a
     session maps the view straight ahead and localization-only mode
     tracks the yaw sequence of ``tests/test_localization_vo.py`` on it
     (every frame OK, no keyframe, the map left behind, at least 30
     inliers on the visual-odometry points, the final orientation within
     5 degrees), the kernel launched 6 times per tracked frame (the VO
     search and its widened retry) plus once per relocalization attempt,
     one VO call equal to the plain version and timed; two sessions over
     frames 0-47 and 16-79 of the loop (the second in its own world
     frame) merge with ``System.merge_map`` (counts added, a further chunk
     tracked OK on the merged map);
 16. the vocabulary at ORBvoc scale: the complete k = 10, L = 6 tree
     (1,111,110 nodes) of ``tests/test_orbvoc_scale.py`` written in DBoW2's
     binary format and loaded with ``load_orbvoc_binary`` (the native
     reader) onto the card,
     and ``transform`` of one frame's 1,536 descriptors on the card: the
     load and the transform timed, the words equal to the CPU's and at
     least half of them the true leaf;
 17. the user's entry point on real images (built in phase 2 with the
     kernels: the port's native host library, whose PNG decoder is
     printed): ``run.main`` over the checked-in mini TUM sequence
     (``tests/data/mini_tum``, 20 frames of 640x480, RGB-D, the ``tum1``
     preset, loop closing off), the frames decoded by the native library
     and streamed by its prefetcher in wire format, saving the TUM
     trajectory, the keyframe trajectory and the debug image: at most 2
     frames not OK and the ATE against ``groundtruth.txt`` below 0.05 m
     (``tests/test_tum_e2e.py``'s bars), the saved file read back equal to
     the composed trajectory, the debug image 640 x 500, the kernel
     launched 4 times per frame plus 8 per mapping step. The same frames
     decoded one by one into float images and tracked by ``System`` give
     every record equal. Then ``run.main`` over a 64-frame synthetic orbit
     with loop closing on (a vocabulary trained from the sequence's own
     frames): every frame OK, the ATE below 0.05 m, the launch identity of
     phase 9. The kernel on the four calls of frame 8 of the mini TUM
     sequence, equal to the plain version and timed as in phase 4; the
     decode time per frame and the CLI's frame rate with its host I/O;
 18. the distributed back end on the card (``parallel/``): a world of 1
     rank on NCCL, joined by ``multihost.initialize`` over a
     ``tcp://127.0.0.1`` store. The reference's multi-chip dry run: the
     pose LM with its 16 edges split over the ``mp`` axis (error below
     1e-3, every edge an inlier), the edge-split BA on 4 cameras with one
     free (equal to ``bundle_adjustment`` on the card within 1e-5), and the
     point-and-edge-split GBA chunk on a 65,536-edge, 8,192-point problem
     at 20 CG iterations: ms per LM iteration (host clock around
     synchronized chunks) and the kernel launches of one LM iteration
     (``torch.profiler``). Then ``System(cfg, vocab=voc,
     mesh=global_mesh())`` over phase 9's loop: the mapper's BA through
     ``distributed_windowed_ba`` and the loop GBA through
     ``distributed_gba_chunk``, every frame OK, at least one loop closed
     and one GBA finished, the composed ATE under the larger of phase 9's
     limit and 1.5 x the reference's own mesh run
     (``tools/reference_passes.py loop --mesh``), the launch identity of
     phase 9, the kernel launches of the first GBA chunk; the kernel on
     frame 48's four calls of this run, equal to the plain version and
     timed as in phase 4. Last, ``python -m orb_slam_2_ros_tpu_torch.run
     --dataset synthetic --frames 64 --mesh`` as a subprocess: exit 0 and
     its mesh line.

The frames are rendered on the host by worker processes that end before
tracking starts. The last two lines are a JSON summary of the kernels and
the JSON result.
Any failure raises, so the exit code is not 0. Without a CUDA device the
script exits at once with an error and prints no result.
"""

import concurrent.futures
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ATE_LIMIT_M = 0.01
N_FRAMES = 96
N_KEYFRAMES = 4         # what the orbit gives at this operating point: the
N_MAP_POINTS = 1931     # kernel is exact, so these do not move with it
CAPTURE_FRAME = 48
N_LOOP_FRAMES = 224
N_MAPPING_FRAMES = 112  # phase 7's depth: the loop's first 7 chunks
CAPTURE_STEP = 3        # the executed mapping step whose fusion calls are kept
# composed-trajectory ATE of the mapping path over its 112 frames, rigid
# alignment: 1.5 x the 0.027044 m measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W (over all 224 frames: 0.088893 m)
LOOP_ATE_LIMIT_M = 0.0406
# composed-trajectory ATE of the full system (loop closing and global BA
# on), rigid alignment: 1.5 x the 0.054178 m measured on an NVIDIA H100 80GB
# HBM3 at 700.00 W. The JAX reference's own full-size runs give 0.0296 m on
# a TPU (BENCH_r05.json, its bench's warm-up-then-reset protocol) and
# 0.060413 m on a CPU (this script's pass, no warm-up).
FULL_ATE_LIMIT_M = 0.0813
REFERENCE_FULL_ATE_M = {"TPU": 0.0296, "CPU": 0.060413}
VOCAB_EVERY = 24        # frames whose descriptors train the vocabulary
LOOP_CLOSING_SHAPE = (16384, 1536)   # Scw widening and SearchAndFuse
RENDER_WORKERS = 6
RELOC_MAP_FRAMES = 32   # the forced loss's orbit, mapped before the loss
RELOC_POSE_LIMIT_M = 0.08   # tests/test_slam_system.py's relocalization gate
N_STEREO_FRAMES = 64    # the reference bench's stereo passes (bench.py:263)
STEREO_ATE_LIMIT_M = 0.05   # tests/test_stereo_tracking.py's limit
N_MONO_WARM = 32        # the mono pass's initialization and warm-up frames
MONO_CAPTURE_FRAME = 48
# the reference's mono pass on a CPU (tools/reference_passes.py mono): its
# first OK frame, OK frames in the two parts, keyframes, points, Sim3 ATE
REFERENCE_MONO = {"first_ok": 2, "ok_first_32": 30, "ok_last_64": 64,
                  "keyframes": 5, "map_points": 717, "ate_m": 0.056730}
MAP_IO_FRAMES = 48      # the saved session: the first three chunks of the loop
# two overlapping sessions of the loop, the shortest found with 3 keyframes
# of each in the frames both see (keyframes at frames 19, 31, 47 of the
# first and 16, 17, 26, 38 of the second, on an NVIDIA H100 80GB HBM3 at
# 700.00 W)
MERGE_WINDOWS = ((0, 48), (16, 80))
ORBVOC_K, ORBVOC_L = 10, 6
# the mono pass's first OK frame on the card, and its Sim3 ATE limit: 1.5 x
# the first chip run's 0.056734 m, on an NVIDIA H100 80GB HBM3 at 700.00 W
MONO_INIT_FRAME = 2
MONO_ATE_LIMIT_M = 0.0851
# phase 17: the mini TUM frame whose four matcher calls are kept, the ATE
# bar of tests/test_tum_e2e.py (also the synthetic run's), the synthetic
# run's length
TUM_CAPTURE_FRAME = 8
TUM_ATE_LIMIT_M = 0.05
CLI_SYNTHETIC_FRAMES = 64
# phase 18: the reference's own full-system loop pass with a mesh of one
# device (tools/reference_passes.py loop --mesh, on a CPU): 224/224 OK, 1
# loop, 1 GBA finished, composed ATE 0.304465 m. The mesh GBA frees every
# camera and carries no loop priors, so its map differs from phase 9's by
# design; the port's bar is the larger of phase 9's and 1.5 x this.
REFERENCE_MESH_ATE_M = 0.304465
MESH_ATE_LIMIT_M = max(FULL_ATE_LIMIT_M, 1.5 * REFERENCE_MESH_ATE_M)
# the reference's dry-run shapes (__graft_entry__.dryrun_multichip)
DRY_POSE_EDGES = 16
DRY_BA_CAMS, DRY_BA_POINTS = 4, 8
DRY_GBA_K, DRY_GBA_P, DRY_GBA_M = 128, 512, 8192
DRY_GBA_CG = 20
MESH_CAPTURE_FRAME = 48
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
    cases = [(N, M, "random")
             for N, M in bench.PATH_SHAPES + (LOOP_CLOSING_SHAPE,)]
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
    """Phase 5. Returns the number of kernel launches on the path, the
    matcher's arguments in frame ``CAPTURE_FRAME``, and the orbit (dataset
    and gray images) for phase 14."""
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
    return launches, path_args, (ds, grays)


def render_loop():
    """The 224-frame loop that phases 7 and 9 share."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.io import render_frames

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    t0 = time.perf_counter()
    ds, grays, depths = render_frames(cfg, N_LOOP_FRAMES, RENDER_WORKERS,
                                      seed=0, trajectory="loop")
    log(f"rendered {N_LOOP_FRAMES} frames of the loop in "
        f"{time.perf_counter() - t0:.1f} s (host, {RENDER_WORKERS} processes)")
    return cfg, ds, grays, depths


def composed_ate(system, ds):
    """ATE of the trajectory composed through the keyframes as they stand,
    and of the poses as tracked."""
    from orb_slam_2_ros_tpu_torch.io import ate_rmse

    gt_all = [ds.gt_pose_wc(i) for i in range(len(system.records))]
    live = float(ate_rmse(np.stack([r.c_w for r in system.records]),
                          np.stack([c for _, c in gt_all])))
    poses, ts = system.tracker.composed_trajectory()
    index = {t: i for i, t in enumerate(ds.timestamps)}
    ate = float(ate_rmse(np.stack([c for _, c in poses]),
                         np.stack([gt_all[index[t]][1] for t in ts])))
    return ate, live


def check_pools(m):
    """The point pool is a live count and no observation dangles."""
    if int(m.n_mps) != int(m.mp_valid.sum()):
        raise AssertionError(f"n_mps {int(m.n_mps)} but "
                             f"{int(m.mp_valid.sum())} valid points")
    held = m.kf_mp[m.kf_mp >= 0].long()
    if not bool(m.mp_valid[held].all()):
        raise AssertionError("an observation names an invalid map point")
    off_card = [f for f, v in m._asdict().items() if not v.is_cuda]
    if off_card:
        raise AssertionError(f"map tensors off the card: {off_card}")


def run_mapping_path(torch, match_kernel, timing, loop_seq):
    """Phase 7. Returns the number of kernel launches on the path and the
    matcher's arguments in the two fusion calls of step ``CAPTURE_STEP``
    against its first neighbour."""
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

    cfg, ds, grays, depths = loop_seq
    n = N_MAPPING_FRAMES
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
    ate, live = composed_ate(system, ds)
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
    check_pools(m)
    if not ate < LOOP_ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {LOOP_ATE_LIMIT_M} m")
    if len(fusion_args) != 2:
        raise AssertionError(f"step {CAPTURE_STEP} was not reached: "
                             f"{steps} steps")
    return launches, fusion_args


def run_full_system(torch, match_kernel, timing, loop_seq):
    """Phase 9. Returns the number of kernel launches on the path, how many
    of them loop closing made, the matcher's arguments in the accepted
    ladder's three calls and the correction's first fuse call, and the
    vocabulary."""
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    cfg, ds, grays, depths = loop_seq
    n = N_LOOP_FRAMES

    # the in-domain vocabulary, trained on the host; outside every fps
    t0 = time.perf_counter()
    voc = vocabulary.train_vocabulary_from_frames(
        grays[:n], VOCAB_EVERY, cfg, seed=0, device="cuda")
    log(f"vocabulary: {voc.num_words} words (k = {voc.k}, {voc.levels} "
        f"levels) from every {VOCAB_EVERY}th of {n} frames in "
        f"{time.perf_counter() - t0:.1f} s (host k-medians)")

    system = System(cfg, vocab=voc)         # all defaults: loop closing on
    if system.device.type != "cuda":
        raise AssertionError(f"System(cfg) chose {system.device}")
    lc = system.loop_closer
    captured = {}
    # launches counted at the kernel's wrapper around every ladder and every
    # correction of the run, one entry per call
    measured = {"ladder": [], "correction": []}

    # keep the matcher's arguments of the accepted ladder and of the
    # correction that follows it
    sim3_check, apply_correction = (loop_closing._sim3_check,
                                    loop_closing._apply_correction)

    def recording(fn, key, keep, labels):
        def wrapped(*args, **kwargs):
            launched = match_kernel.LAUNCHES
            with timing.capture_calls(matcher, "masked_best_two") as calls:
                out = fn(*args, **kwargs)
            measured[key].append(match_kernel.LAUNCHES - launched)
            if key == "correction" and key in captured:
                return out              # the first correction is kept
            captured[key] = [
                (label, tuple(a.clone() for a in call))
                for label, call in zip(labels, calls[:keep])]
            if key == "correction":     # and the ladder that led to it
                captured["accepted_ladder"] = captured["ladder"]
            return out
        return wrapped

    loop_closing._sim3_check = recording(
        sim3_check, "ladder", 3,
        ("path: SearchBySim3, candidate into current keyframe",
         "path: SearchBySim3, current keyframe into candidate",
         "path: Scw widening, map points into current keyframe"))
    loop_closing._apply_correction = recording(
        apply_correction, "correction", 1,
        ("path: SearchAndFuse, loop points into current keyframe",))
    # each chunk's dispatched detection verdict (candidate, keyframe), read
    # after the chunk, for the log only
    dispatched = []
    dispatch = lc.dispatch

    def logged_dispatch(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        dispatched.append(lc._pending_verdict[-1])
        return out

    lc.dispatch = logged_dispatch
    C = system.tracker.CHUNK
    stages = ("tracking", "local_mapping", "loop_closing")
    match_kernel.LAUNCHES = 0
    t_run = time.perf_counter()
    try:
        for w0 in list(range(0, n, C)) + [None]:
            before = {s: system.timers.total_s[s] for s in stages}
            n_events = len(lc.events)
            if w0 is None:
                system.flush()
                head = "flush   "
            else:
                system.track_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                                   ds.timestamps[w0:w0 + C])
                head = f"chunk {w0 // C:2d}"
            torch.cuda.synchronize()
            line = head + ": " + ", ".join(
                f"{s} {system.timers.total_s[s] - before[s]:.3f} s"
                for s in stages)
            if w0 is not None:
                line += f"; dispatched verdict {dispatched[-1].tolist()}"
            for e in lc.events[n_events:]:
                if e["kind"] == "ladder":
                    line += (f"; ladder candidate {e['cand']} for keyframe "
                             f"{e['k']}: {e['n_pairs']} BoW pairs, "
                             f"{e['n_inl']} Sim3 inliers, {e['n_widened']} "
                             f"widened, "
                             + ("ACCEPTED" if e["accepted"] else "rejected"))
                else:
                    line += (f"; GBA finished, seam residual "
                             f"{e['seam_before']:.4f} -> "
                             f"{e['seam_after']:.4f} m"
                             + (", REJECTED" if e["rejected"] else ""))
            if lc.gba_running:
                line += (f"; GBA at {lc._gba_iters_done} of "
                         f"{cfg.solver.global_ba_iters} iterations")
            log(line)
    finally:
        loop_closing._sim3_check = sim3_check
        loop_closing._apply_correction = apply_correction
    run_s = time.perf_counter() - t_run
    launches = match_kernel.LAUNCHES

    recs = system.records
    n_ok = sum(r.state == OK for r in recs)
    m = system.tracker.map
    steps = system.mapper.n_executed
    lc_launches = sum(measured["ladder"]) + sum(measured["correction"])
    ate, live = composed_ate(system, ds)
    stage_ms = {s: v["total_ms"] for s, v in system.metrics()["stages"].items()}
    log(f"full system: {n_ok}/{n} frames OK, {lc.n_loops_closed} loops "
        f"closed, {lc.n_ladders} Sim3 ladders, gba_finished "
        f"{lc.n_gba_finished}, gba_rejected {lc.n_gba_rejected}, gba_aborts "
        f"{lc.n_gba_aborts}, ATE {ate:.6f} m composed ({live:.6f} m as "
        f"tracked; limit {FULL_ATE_LIMIT_M} m; the JAX reference's own runs: "
        f"224/224 OK, 1 loop, gba_finished 1, "
        f"{REFERENCE_FULL_ATE_M['TPU']} m on a TPU, "
        f"{REFERENCE_FULL_ATE_M['CPU']} m on a CPU), "
        f"{system.tracker.n_kfs} keyframe rows ({int(m.kf_valid.sum())} "
        f"valid, {lc._n_ingested} ingested), {int(m.n_mps)} map points, "
        f"{steps} mapping steps, {launches} matcher kernel launches "
        f"({lc_launches} by loop closing: {measured['ladder']} in the "
        f"ladders, {measured['correction']} in the corrections)")
    log(f"full system: {n / run_s:.2f} fps over the whole run and the flush "
        f"(host clock); stage ms {json.dumps(stage_ms)}")

    if n_ok != n:
        bad = [i for i, r in enumerate(recs) if r.state != OK]
        raise AssertionError(f"frames not OK: {bad}")
    if lc.n_loops_closed < 1 or lc.n_gba_finished < 1:
        raise AssertionError(f"{lc.n_loops_closed} loops closed, "
                             f"{lc.n_gba_finished} global BAs finished")
    if lc._n_ingested != system.tracker.n_kfs:
        raise AssertionError(f"{lc._n_ingested} keyframes ingested of "
                             f"{system.tracker.n_kfs}")
    if launches != 4 * n + 8 * steps + lc_launches:
        raise AssertionError(
            f"matcher kernel launched {launches} times, the path makes "
            f"{4 * n} + {8 * steps} + {lc_launches}")
    if (measured["ladder"] != [loop_closing.LADDER_LAUNCHES] * lc.n_ladders
            or measured["correction"]
            != [loop_closing.N_FUSE_ROWS] * lc.n_corrections):
        raise AssertionError(
            f"launches per ladder and per correction: {measured}, with "
            f"{lc.n_ladders} ladders and {lc.n_corrections} corrections")
    check_pools(m)
    if lc.gba_running or lc._pending_verdict:
        raise AssertionError("flush left loop-closing work behind")
    for f in ("kf_q", "kf_t", "mp_pos"):
        if not bool(torch.isfinite(getattr(m, f)).all()):
            raise AssertionError(f"{f} is not finite")
    if not ate < FULL_ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate} m >= {FULL_ATE_LIMIT_M} m")
    return (launches, lc_launches,
            captured["accepted_ladder"] + captured["correction"], voc)


def run_relocalization(torch, match_kernel, timing):
    """Phase 11: the forced loss of ``tests/test_hard_sequences.py`` at the
    full operating point, on its 32-frame orbit (the revisited frames lie
    far enough from the last pose that tracking alone loses them). Returns the kernel launches of the phase, those
    of each relocalization attempt, and the matcher's arguments in the
    successful attempt's widening call."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.io import render_frames, umeyama_align
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing, relocalization
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = RELOC_MAP_FRAMES
    t0 = time.perf_counter()
    ds, grays, depths = render_frames(cfg, n, RENDER_WORKERS, seed=0,
                                      trajectory="orbit")
    log(f"rendered the {n}-frame orbit in {time.perf_counter() - t0:.1f} s "
        f"(host, {RENDER_WORKERS} processes)")
    system = System(cfg)    # all defaults: loop closing and relocalization on
    if system.device.type != "cuda":
        raise AssertionError(f"System(cfg) chose {system.device}")
    attempts, captured = [], []
    attempt = system._attempt_reloc

    def measured_attempt(*args):
        launched = match_kernel.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timing.capture_calls(matcher, "masked_best_two") as calls:
            out = attempt(*args)
        torch.cuda.synchronize()
        attempts.append({"ok": out[0], "ms": 1e3 * (time.perf_counter() - t0),
                         "launches": match_kernel.LAUNCHES - launched})
        if out[0] and not captured:
            captured.extend(
                (f"path: relocalization widening, map points into the lost "
                 f"frame ({call[0].shape[0]}x{call[2].shape[0]})",
                 tuple(a.clone() for a in call)) for call in calls)
        return out

    system._attempt_reloc = measured_attempt
    tracked = count_tracked(system)
    C = system.tracker.CHUNK
    h = C // 2
    # one chunk: the first half blind (zeros: no keypoints, LOST), the
    # second half revisits frames 8 onwards, already mapped
    g2 = np.concatenate([np.zeros_like(grays[:h]), grays[8:8 + C - h]])
    d2 = np.concatenate([np.zeros_like(depths[:h]), depths[8:8 + C - h]])
    ts2 = [ds.timestamps[n - 1] + (i + 1) / 30.0 for i in range(C)]
    match_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    system.track_chunk(grays[:n], depths[:n], ds.timestamps[:n])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    recs = system.track_chunk(g2, d2, ts2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = match_kernel.LAUNCHES

    lc = system.loop_closer
    steps = system.mapper.n_executed
    reloc_launches = [a["launches"] for a in attempts]
    states = [r.state for r in recs]
    # the trajectory's frame: aligned on the frames tracked before the loss
    before = system.records[:n]
    _, R, t = umeyama_align(np.stack([r.c_w for r in before]),
                             np.stack([ds.gt_pose_wc(i)[1]
                                       for i in range(n)]))
    err = [float(np.linalg.norm(R @ r.c_w + t - ds.gt_pose_wc(8 + i)[1]))
           for i, r in enumerate(recs[h:])]
    ok_ms = [a["ms"] for a in attempts if a["ok"]]
    fail_ms = [a["ms"] for a in attempts if not a["ok"]]
    log(f"relocalization: map of {n} frames in {t1 - t0:.2f} s "
        f"({system.tracker.n_kfs} keyframes); the lost chunk "
        f"{t2 - t1:.2f} s: states {states}, {len(attempts)} attempts "
        f"({len(ok_ms)} successful: {[round(x, 1) for x in ok_ms]} ms; "
        f"failed: {[round(x, 1) for x in fail_ms]} ms), {tracked[0]} frames "
        f"tracked (the replay included), {len(system.records)} records, "
        f"pose error after the loss {[round(e, 4) for e in err]} m, "
        f"{launches} matcher kernel launches ({sum(reloc_launches)} by "
        f"relocalization: {reloc_launches}), {steps} mapping steps, "
        f"{lc.n_ladders} ladders, {lc.n_corrections} corrections")

    if OK in states[:h]:
        raise AssertionError(f"a blind frame is OK: {states}")
    if states[h:] != [OK] * (C - h):
        raise AssertionError(f"lost-lag above one frame: {states}")
    if [r.frame_id for r in system.records] != list(range(n + C)):
        raise AssertionError("the records do not count each frame once")
    if not attempts or not attempts[-1]["ok"] or len(attempts) != h + 1:
        raise AssertionError(f"attempts {attempts}")
    if reloc_launches != [relocalization.LAUNCHES] * len(attempts):
        raise AssertionError(f"launches per attempt {reloc_launches}")
    expected = (4 * tracked[0] + 8 * steps + sum(reloc_launches)
                + loop_closing.LADDER_LAUNCHES * lc.n_ladders
                + loop_closing.N_FUSE_ROWS * lc.n_corrections)
    if launches != expected:
        raise AssertionError(f"matcher kernel launched {launches} times, the "
                             f"path makes {expected}")
    if max(err) >= RELOC_POSE_LIMIT_M:
        raise AssertionError(f"relocalized poses {err} m off")
    check_pools(system.tracker.map)
    if len(captured) != 1 or captured[0][1][0].shape[0] != cfg.map.max_mps:
        raise AssertionError("the widening call was not captured")
    return launches, reloc_launches, ok_ms, fail_ms, captured


def run_stereo(torch, match_kernel, bench, timing):
    """Phase 13: the reference bench's two stereo passes at full width,
    then the stereo forced loss. Returns the kernel launches of both
    passes, those of the forced loss and of each of its relocalization
    attempts, and the matcher's arguments in the four calls of frame
    ``CAPTURE_FRAME``."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_STEREO, SlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.io import ate_rmse, render_frames
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker

    cfg = SlamConfig(sensor=SENSOR_STEREO)
    n = N_STEREO_FRAMES
    t0 = time.perf_counter()
    ds, lefts, rights = render_frames(cfg, n, RENDER_WORKERS, stereo=True,
                                      seed=0, trajectory="orbit")
    log(f"rendered {n} stereo pairs in {time.perf_counter() - t0:.1f} s "
        f"(host, {RENDER_WORKERS} processes)")
    gt = np.stack([ds.gt_pose_wc(i)[1] for i in range(n)])

    tracker = Tracker(cfg)
    if tracker.device.type != "cuda":
        raise AssertionError(f"Tracker(cfg) chose {tracker.device}")
    C = tracker.CHUNK
    match_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    for w0 in range(0, n, C):
        with timing.capture_calls(matcher, "masked_best_two") as calls:
            tracker.process_chunk(lefts[w0:w0 + C], rights[w0:w0 + C],
                                  ds.timestamps[w0:w0 + C])
        if w0 == CAPTURE_FRAME:
            path_args = [(label.replace("path:", "stereo path:"), args)
                         for label, args in bench.label_path_calls(calls[:4])]
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    track_launches = match_kernel.LAUNCHES
    recs = tracker.records
    n_ok = sum(r.state == OK for r in recs)
    ate = float(ate_rmse(np.stack([r.c_w for r in recs]), gt))
    log(f"stereo tracker: {n_ok}/{n} frames OK, ATE {ate:.6f} m, "
        f"{tracker.n_kfs} keyframes, {int(tracker.map.n_mps)} map points, "
        f"{track_launches} matcher kernel launches, {n / track_s:.2f} fps "
        f"(host clock, the first chunk included)")

    system = System(cfg, enable_loop_closing=False)
    match_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    for w0 in range(0, n, C):
        system.track_chunk(lefts[w0:w0 + C], rights[w0:w0 + C],
                           ds.timestamps[w0:w0 + C])
    torch.cuda.synchronize()
    sys_s = time.perf_counter() - t0
    sys_launches = match_kernel.LAUNCHES
    steps = system.mapper.n_executed
    s_ok = sum(r.state == OK for r in system.records)
    s_ate, s_live = composed_ate(system, ds)
    log(f"stereo system: {s_ok}/{n} frames OK, ATE {s_ate:.6f} m composed "
        f"({s_live:.6f} m as tracked), {system.tracker.n_kfs} keyframe rows, "
        f"{int(system.tracker.map.n_mps)} map points, {steps} mapping steps, "
        f"{sys_launches} matcher kernel launches, {n / sys_s:.2f} fps (host "
        f"clock)")

    if n_ok != n or s_ok != n:
        raise AssertionError(f"stereo frames OK: {n_ok} and {s_ok} of {n}")
    if track_launches != 4 * n:
        raise AssertionError(f"stereo tracker launched {track_launches}, "
                             f"the path makes {4 * n}")
    if sys_launches != 4 * n + 8 * steps:
        raise AssertionError(f"stereo system launched {sys_launches}, the "
                             f"path makes {4 * n} + {8 * steps}")
    if not (ate < STEREO_ATE_LIMIT_M and s_ate < STEREO_ATE_LIMIT_M):
        raise AssertionError(f"stereo ATE {ate} and {s_ate} m >= "
                             f"{STEREO_ATE_LIMIT_M} m")
    check_pools(system.tracker.map)
    loss_launches, loss_attempts = run_stereo_loss(torch, match_kernel, cfg)
    return (track_launches + sys_launches, loss_launches, loss_attempts,
            path_args)


def run_stereo_loss(torch, match_kernel, cfg):
    """Phase 13, second part: the forced loss of phase 11 on a stereo
    ``System(cfg)``, on the 32-pair orbit (over 32 frames the revisited
    pairs lie far enough from the last pose that tracking alone loses
    them; the first 32 of the 64-pair orbit do not). Returns the kernel
    launches of the part and those of each relocalization attempt."""
    from orb_slam_2_ros_tpu_torch.io import render_frames, umeyama_align
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing, relocalization
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import LOST, OK

    n = RELOC_MAP_FRAMES
    t0 = time.perf_counter()
    ds, lefts, rights = render_frames(cfg, n, RENDER_WORKERS, stereo=True,
                                      seed=0, trajectory="orbit")
    log(f"rendered the {n}-pair stereo orbit in "
        f"{time.perf_counter() - t0:.1f} s (host, {RENDER_WORKERS} processes)")
    system = System(cfg)    # loop closing and with it relocalization on
    attempts = count_attempts(system, match_kernel)
    tracked = count_tracked(system)
    C = system.tracker.chunk
    h = C // 2
    lost_l = np.concatenate([np.zeros_like(lefts[:h]), lefts[8:8 + C - h]])
    lost_r = np.concatenate([np.zeros_like(rights[:h]), rights[8:8 + C - h]])
    ts2 = [ds.timestamps[n - 1] + (i + 1) / 30.0 for i in range(C)]
    match_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    system.track_chunk(lefts[:n], rights[:n], ds.timestamps[:n])
    recs = system.track_chunk(lost_l, lost_r, ts2)
    torch.cuda.synchronize()
    launches = match_kernel.LAUNCHES
    lc = system.loop_closer
    per_attempt = [a[1] for a in attempts]
    states = [r.state for r in recs]
    _, R, t = umeyama_align(np.stack([r.c_w for r in system.records[:n]]),
                            np.stack([ds.gt_pose_wc(i)[1] for i in range(n)]))
    err = [float(np.linalg.norm(R @ r.c_w + t - ds.gt_pose_wc(8 + i)[1]))
           for i, r in enumerate(recs[h:])]
    log(f"stereo forced loss: {time.perf_counter() - t0:.2f} s, states "
        f"{states}, {len(attempts)} attempts ({sum(a[0] for a in attempts)} "
        f"successful), {tracked[0]} pairs tracked (the replay included), "
        f"pose error after the loss {[round(e, 4) for e in err]} m, "
        f"{launches} matcher kernel launches ({sum(per_attempt)} by "
        f"relocalization: {per_attempt})")
    if states != [LOST] * h + [OK] * (C - h):
        raise AssertionError(f"stereo lost-lag above one frame: {states}")
    if len(attempts) != h + 1 or not attempts[-1][0]:
        raise AssertionError(f"stereo attempts {attempts}")
    if per_attempt != [relocalization.LAUNCHES] * len(attempts):
        raise AssertionError(f"launches per attempt {per_attempt}")
    expected = (4 * tracked[0] + 8 * system.mapper.n_executed
                + sum(per_attempt)
                + loop_closing.LADDER_LAUNCHES * lc.n_ladders
                + loop_closing.N_FUSE_ROWS * lc.n_corrections)
    if launches != expected:
        raise AssertionError(f"matcher kernel launched {launches} times, the "
                             f"path makes {expected}")
    if max(err) >= RELOC_POSE_LIMIT_M:
        raise AssertionError(f"relocalized poses {err} m off")
    check_pools(system.tracker.map)
    return launches, per_attempt


def count_attempts(system, match_kernel):
    """Record (success, kernel launches) of each relocalization attempt of
    the system, counted at the kernel's wrapper."""
    attempts = []
    attempt = system._attempt_reloc

    def counted(*args):
        launched = match_kernel.LAUNCHES
        out = attempt(*args)
        attempts.append((out[0], match_kernel.LAUNCHES - launched))
        return out

    system._attempt_reloc = counted
    return attempts


def count_tracked(system):
    """Count the frames the system's tracker tracks, replays included."""
    tracked = [0]
    process_chunk = system.tracker.process_chunk

    def counted(grays, *args, **kwargs):
        tracked[0] += len(grays)
        return process_chunk(grays, *args, **kwargs)

    system.tracker.process_chunk = counted
    return tracked


def check_finite(torch, m):
    """Every pose and every valid point of the map is finite."""
    for f in ("kf_q", "kf_t"):
        if not bool(torch.isfinite(getattr(m, f)).all()):
            raise AssertionError(f"{f} is not finite")
    if not bool(torch.isfinite(m.mp_pos[m.mp_valid]).all()):
        raise AssertionError("a valid map point is not finite")


def run_mono(torch, match_kernel, bench, timing, orbit):
    """Phase 14: the reference bench's mono pass on phase 5's orbit.
    Returns the kernel launches of the pass, the matcher's arguments in the
    four calls of the first tracked frame from ``MONO_CAPTURE_FRAME`` on,
    and the initialization's host seconds."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_MONOCULAR, SlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.io import ate_rmse
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

    ds, grays = orbit
    n = len(grays)
    cfg = SlamConfig(sensor=SENSOR_MONOCULAR)
    system = System(cfg, enable_loop_closing=False)
    if system.device.type != "cuda" or system.tracker.chunk != 8:
        raise AssertionError(f"mono System chose {system.device}, chunks of "
                             f"{system.tracker.chunk}")
    init_s = []
    process = system.mono_init.process

    def timed_process(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = process(*args)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
        return out

    system.mono_init.process = timed_process
    tracked = [0]
    path_args = []
    process_chunk = system.tracker.process_chunk

    def counted(grays_, *args, **kwargs):
        first = len(system.tracker.records)
        tracked[0] += len(grays_)
        if path_args or first < MONO_CAPTURE_FRAME:
            return process_chunk(grays_, *args, **kwargs)
        with timing.capture_calls(matcher, "masked_best_two") as calls:
            out = process_chunk(grays_, *args, **kwargs)
        path_args.extend(
            (label.replace("path:", f"mono path, frame {first}:"), a)
            for label, a in bench.label_path_calls(calls[:4]))
        return out

    system.tracker.process_chunk = counted
    match_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    first_recs = system.track_chunk(grays[:N_MONO_WARM], None,
                                    ds.timestamps[:N_MONO_WARM])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rest = system.track_chunk(grays[N_MONO_WARM:], None,
                              ds.timestamps[N_MONO_WARM:])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = match_kernel.LAUNCHES
    steps = system.mapper.n_executed
    states = [r.state for r in system.records]
    first_ok = states.index(OK) if OK in states else None
    ok = [r for r in system.records if r.state == OK]
    ate = float(ate_rmse(np.stack([r.c_w for r in ok]),
                         np.stack([ds.gt_pose_wc(r.frame_id)[1] for r in ok]),
                         with_scale=True))
    n_ok_a = sum(r.state == OK for r in first_recs)
    n_ok_b = sum(r.state == OK for r in rest)
    m = system.tracker.map
    log(f"mono: first OK frame {first_ok}, {n_ok_a}/{N_MONO_WARM} OK in the "
        f"first part, {n_ok_b}/{n - N_MONO_WARM} after, Sim3 ATE {ate:.6f} m "
        f"(limit {MONO_ATE_LIMIT_M} m), {system.tracker.n_kfs} keyframes, "
        f"{int(m.mp_valid.sum())} map points, {steps} mapping steps, "
        f"{tracked[0]} frames tracked, {launches} matcher kernel launches; "
        f"the reference's same pass on a CPU: {json.dumps(REFERENCE_MONO)}")
    log(f"mono: initialization {len(init_s)} calls, "
        f"{[round(x, 3) for x in init_s]} s (host, synchronized); "
        f"{t1 - t0:.2f} s for the first {N_MONO_WARM} frames, "
        f"{(n - N_MONO_WARM) / (t2 - t1):.2f} fps over the other "
        f"{n - N_MONO_WARM} (host clock, mapping included)")
    if first_ok != MONO_INIT_FRAME:
        raise AssertionError(f"mono initialized at frame {first_ok}, not "
                             f"{MONO_INIT_FRAME}")
    if any(st != OK for st in states[first_ok:]):
        raise AssertionError(f"mono lost a frame after the first OK: "
                             f"{states}")
    if n_ok_b != n - N_MONO_WARM:
        raise AssertionError(f"mono: {n_ok_b} of {n - N_MONO_WARM} OK")
    if launches != 4 * tracked[0] + 8 * steps:
        raise AssertionError(f"matcher kernel launched {launches} times, the "
                             f"path makes {4 * tracked[0]} + {8 * steps}")
    check_pools(m)
    check_finite(torch, m)
    if not ate < MONO_ATE_LIMIT_M:
        raise AssertionError(f"mono ATE {ate} m >= {MONO_ATE_LIMIT_M} m")
    if len(path_args) != 4:
        raise AssertionError("the mono frame's calls were not captured")
    return launches, path_args, init_s


def _render_views_block(job):
    """Worker of ``render_views``: ray-cast views of the seeded room."""
    from orb_slam_2_ros_tpu_torch.io.synthetic import make_room, render
    cam, poses = job
    planes = make_room(0)
    return [render(planes, R, c, cam) for R, c in poses]


def render_views(cam, poses):
    """(grays, depths) of the room seen from ``poses`` [(R_wc, c_w)], by
    ``RENDER_WORKERS`` processes that end when the call returns."""
    import concurrent.futures
    import multiprocessing
    blocks = [poses[w::RENDER_WORKERS] for w in range(RENDER_WORKERS)]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=RENDER_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(_render_views_block,
                             [(cam, b) for b in blocks]))
    frames = [None] * len(poses)
    for w, views in enumerate(done):
        frames[w::RENDER_WORKERS] = views
    return (np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))


def _yaw_pose(yaw):
    """tests/test_localization_vo.py's camera: at the origin, yawed."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    return (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32),
            np.zeros(3, np.float32))


def run_map_io(torch, match_kernel, bench, timing, loop_seq, voc, workdir):
    """Phase 15: save and load, localization-only mode, merge. Returns the
    kernel launches of the localization run, the matcher's arguments in
    one VO search call, and the merge's numbers."""
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.pipeline import relocalization
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

    cfg, ds, grays, depths = loop_seq

    # 1-2: a mapping session saves its map; a new System loads it
    n = MAP_IO_FRAMES
    session = System(cfg, vocab=voc)
    session.track_chunk(grays[:n], depths[:n], ds.timestamps[:n])
    path = os.path.join(workdir, "session.npz")
    t0 = time.perf_counter()
    session.save_map(path)
    t1 = time.perf_counter()
    loaded = System(cfg, load_map=path)
    t2 = time.perf_counter()
    saved_m, loaded_m = session.tracker.map, loaded.tracker.map
    differ = [f for f in saved_m._fields
              if not torch.equal(getattr(saved_m, f), getattr(loaded_m, f))]
    if differ or loaded.loop_closer._n_ingested != \
            session.loop_closer._n_ingested:
        raise AssertionError(f"the loaded map differs in {differ}")
    if not torch.equal(loaded.vocab.node_desc, voc.node_desc):
        raise AssertionError("the loaded vocabulary differs")
    log(f"map I/O: {session.tracker.n_kfs} keyframes, "
        f"{int(saved_m.n_mps)} points, saved in {t1 - t0:.2f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB), loaded in {t2 - t1:.2f} s, "
        f"every field equal")

    # 3-4: localization-only mode on a map of the view straight ahead
    yaws = np.concatenate([np.zeros(3), np.linspace(0.0, 1.4, 29)])
    g0, d0 = render_views(cfg.camera, [_yaw_pose(0.0)] * 2)
    gy, dy = render_views(cfg.camera, [_yaw_pose(y) for y in yaws])
    mapper = System(cfg, enable_local_ba=False, enable_loop_closing=False)
    mapper.track_chunk(g0, d0)
    loc_path = os.path.join(workdir, "straight_ahead.npz")
    mapper.save_map(loc_path)
    loc = System(cfg.replace(localization_only=True), enable_local_ba=False,
                 load_map=loc_path)
    n_mps = int(loc.tracker.map.n_mps)
    tracked = count_tracked(loc)
    attempts = count_attempts(loc, match_kernel)
    match_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    with timing.capture_calls(matcher, "masked_best_two") as calls:
        recs = loc.track_chunk(gy, dy)
    torch.cuda.synchronize()
    loc_s = time.perf_counter() - t0
    launches = match_kernel.LAUNCHES
    # a frame's calls: the motion model and its widened retry, the
    # reference keyframe, the VO search and its widened retry, the local map
    per_frame = 6
    vo_args = [(f"path: localization VO search, last frame's temporal "
                f"points into frame 20 ({c[0].shape[0]}x{c[2].shape[0]})",
                tuple(a.clone() for a in c))
               for c in calls[20 * per_frame + 3:20 * per_frame + 4]]
    per_attempt = [a[1] for a in attempts]
    states = [r.state for r in recs]
    R_gt, _ = _yaw_pose(yaws[-1])
    ang = float(np.degrees(np.arccos(np.clip(
        (np.trace(R_gt.T @ recs[-1].R_wc) - 1) / 2, -1, 1))))
    log(f"localization: {sum(s == OK for s in states)}/{len(recs)} OK in "
        f"{loc_s:.2f} s, map inliers {[r.n_map_inliers for r in recs]}, "
        f"inliers {[r.n_inliers for r in recs]}, final orientation "
        f"{ang:.3f} deg off, {len(attempts)} relocalization attempts "
        f"({sum(a[0] for a in attempts)} successful), {tracked[0]} frames "
        f"tracked, {launches} matcher kernel launches")
    if states != [OK] * len(recs) or any(r.is_keyframe for r in recs):
        raise AssertionError(f"localization states {states}")
    if not (recs[1].n_map_inliers > 30 and recs[-1].n_map_inliers < 10
            and recs[-1].n_inliers >= 30 and ang < 5.0):
        raise AssertionError("localization left the map badly")
    if int(loc.tracker.map.n_mps) != n_mps:
        raise AssertionError("localization changed the map")
    if per_attempt != [relocalization.LAUNCHES] * len(attempts):
        raise AssertionError(f"launches per attempt {per_attempt}")
    if launches != per_frame * tracked[0] + sum(per_attempt):
        raise AssertionError(
            f"matcher kernel launched {launches} times, the path makes "
            f"{per_frame} x {tracked[0]} + {sum(per_attempt)}")
    if len(vo_args) != 1 or vo_args[0][1][0].shape[0] != cfg.orb.max_kps:
        raise AssertionError("the VO call was not captured")

    # 5: two sessions of the loop, the second in its own world frame
    sessions = []
    for a, b in MERGE_WINDOWS:
        s = System(cfg, vocab=voc, enable_loop_closing=False)
        s.track_chunk(grays[a:b], depths[a:b], ds.timestamps[a:b])
        sessions.append(s)
    first, second = sessions
    # keyframes of each session inside the frames both sessions saw (the
    # second session counts its frames from its own first one)
    lo, hi = MERGE_WINDOWS[1][0], MERGE_WINDOWS[0][1]
    overlap = []
    for s, (a, _) in zip(sessions, MERGE_WINDOWS):
        fid = s.tracker.map.kf_frame_id[s.tracker.map.kf_valid].cpu().numpy()
        overlap.append(int(((fid + a >= lo) & (fid + a < hi)).sum()))
    if min(overlap) < 3:
        raise AssertionError(f"keyframes in the overlap: {overlap}")
    merge_path = os.path.join(workdir, "second_session.npz")
    second.save_map(merge_path)
    n1, n2 = first.tracker.n_kfs, second.tracker.n_kfs
    p1, p2 = int(first.tracker.map.n_mps), int(second.tracker.map.n_mps)
    t0 = time.perf_counter()
    if not first.merge_map(merge_path):
        raise AssertionError("the sessions did not merge")
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    m = first.tracker.map
    if (int(m.n_kfs), int(m.n_mps)) != (n1 + n2, p1 + p2):
        raise AssertionError(f"merged counts {int(m.n_kfs)}, {int(m.n_mps)}")
    b = MERGE_WINDOWS[0][1]
    more = first.track_chunk(grays[b:b + 16], depths[b:b + 16],
                             ds.timestamps[b:b + 16])
    if any(r.state != OK for r in more):
        raise AssertionError(f"after the merge: {[r.state for r in more]}")
    check_pools(first.tracker.map)
    merge = {"keyframes": [n1, n2], "points": [p1, p2],
             "keyframes_in_overlap": overlap, "seconds": merge_s}
    log(f"merge: sessions of {n1} and {n2} keyframes ({overlap} in the "
        f"frames both saw), {p1} and {p2} points merged in {merge_s:.2f} s; "
        f"a further chunk of 16 tracked OK")
    return launches, per_attempt, vo_args, merge


def _orbvoc_tree(rng):
    """The complete (k=10, L=6) tree of tests/test_orbvoc_scale.py in
    DBoW2's record layout, breadth-first: each child is its parent's
    descriptor with fewer bits flipped at each level. Returns (parents,
    is_leaf, descs, weights, leaf_bits)."""
    k, L = ORBVOC_K, ORBVOC_L
    flips = [96, 40, 24, 14, 8, 5]
    level_bits = [rng.integers(0, 2, (k, 256), dtype=np.uint8)]
    for lvl in range(1, L):
        parent = np.repeat(level_bits[-1], k, axis=0)
        noise = (rng.uniform(size=parent.shape)
                 < flips[lvl] / 256.0).astype(np.uint8)
        level_bits.append(parent ^ noise)
    descs = np.concatenate(
        [np.packbits(b, axis=1, bitorder="little") for b in level_bits])
    sizes = [k ** lvl for lvl in range(1, L + 1)]
    starts = np.cumsum([0] + sizes)
    ids = np.arange(1, sum(sizes) + 1)
    lvl = np.searchsorted(starts[1:], ids - 1, side="right")
    slot = (ids - 1) - starts[lvl]
    parents = np.where(lvl == 0, 0,
                       starts[np.maximum(lvl - 1, 0)] + slot // k + 1)
    weights = np.zeros(sum(sizes))
    weights[starts[L - 1]:] = rng.uniform(0.5, 2.0, k ** L)
    return (parents.astype(np.int32), (lvl == L - 1).astype(np.uint8), descs,
            weights, level_bits[-1])


def run_vocab_scale(torch, workdir):
    """Phase 16. Returns the load seconds and the transform's ms."""
    from orb_slam_2_ros_tpu_torch.config import SlamConfig, VocabConfig
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    t0 = time.perf_counter()
    parents, is_leaf, descs, weights, leaf_bits = _orbvoc_tree(
        np.random.default_rng(0))
    path = os.path.join(workdir, "orbvoc_scale.bin")
    vocabulary.write_orbvoc_bin(path, ORBVOC_K, ORBVOC_L, parents, is_leaf,
                                descs, weights)
    t1 = time.perf_counter()
    cfg = SlamConfig(vocab=VocabConfig(k=ORBVOC_K, levels=ORBVOC_L,
                                       levels_up=4))
    voc = vocabulary.load_orbvoc_binary(path, cfg, device="cuda",
                                        use_native=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    P = cfg.orb.max_kps
    pick = np.random.default_rng(1).choice(leaf_bits.shape[0], P,
                                           replace=False)
    desc = np.packbits(leaf_bits[pick], axis=1, bitorder="little")
    desc = torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).cuda()
    valid = torch.ones((P,), dtype=torch.bool, device="cuda")
    word, _, _ = vocabulary.transform(voc, desc, valid)
    cpu_voc = voc._replace(node_desc=voc.node_desc.cpu(),
                           word_weight=voc.word_weight.cpu())
    cpu_word, _, _ = vocabulary.transform(cpu_voc, desc.cpu(), valid.cpu())
    if not torch.equal(word.cpu(), cpu_word):
        raise AssertionError("the card's words differ from the CPU's")
    exact = float((word.cpu().numpy() == pick).mean())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 20
    start.record()
    for _ in range(reps):
        vocabulary.transform(voc, desc, valid)
    end.record()
    torch.cuda.synchronize()
    transform_ms = start.elapsed_time(end) / reps
    log(f"vocabulary at ORBvoc scale: {voc.node_desc.shape[0]} nodes, "
        f"{voc.num_words} words; tree built and written in {t1 - t0:.1f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB), parsed by the native "
        f"reader and loaded onto the card in {load_s:.2f} s; transform of {P} descriptors {transform_ms:.3f} ms "
        f"(CUDA events over {reps} calls, host-bound), words equal to the "
        f"CPU's, {exact:.3f} of them the true leaf")
    if voc.node_desc.shape[0] != len(parents) or exact < 0.5:
        raise AssertionError(f"{voc.node_desc.shape[0]} nodes, exact-leaf "
                             f"rate {exact}")
    return load_s, transform_ms


def run_cli(torch, match_kernel, bench, timing, workdir):
    """Phase 17. Returns the kernel launches of the mini TUM run and of
    the synthetic run, the four calls of frame ``TUM_CAPTURE_FRAME``, and
    the decode and frame-rate numbers."""
    from orb_slam_2_ros_tpu_torch import native, presets, run
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.io import datasets, trajectory
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "mini_tum")
    ds = datasets.TumRGBD(root)
    t0 = time.perf_counter()
    for rgb, dep in zip(ds.rgb_files, ds.depth_files):
        native.decode_gray8(os.path.join(root, rgb))
        native.decode_depth_mm(os.path.join(root, dep), ds.depth_factor)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    card = command_output(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])
    log(f"cli: native decoder: {native.DECODER}; {decode_ms:.3f} ms per "
        f"frame (gray and depth PNG, 640x480, host); card {card}")

    out = {k: os.path.join(workdir, f"cli_{k}") for k in
           ("traj.txt", "kf_traj.txt", "debug.png")}
    match_kernel.LAUNCHES = 0
    with timing.capture_calls(matcher, "masked_best_two") as calls:
        res = run.main(["--dataset", "tum", "--path", root,
                        "--no-loop-closing", "--save-traj", out["traj.txt"],
                        "--save-kf-traj", out["kf_traj.txt"],
                        "--save-debug-image", out["debug.png"]])
    tum_launches = match_kernel.LAUNCHES
    system, n = res["system"], res["frames"]
    tum_fps = res["fps"]
    f = TUM_CAPTURE_FRAME
    tum_args = [(label.replace("path:", f"mini TUM frame {f}:"), a)
                for label, a in bench.label_path_calls(calls[4 * f:4 * f + 4])]
    steps = system.mapper.n_executed
    ts, poses = trajectory.read_tum(out["traj.txt"])
    want, want_ts = system.tracker.composed_trajectory()
    with open(out["debug.png"], "rb") as fh:
        width, height = struct.unpack(">II", fh.read(24)[16:24])
    log(f"cli: mini TUM through run.main: {res['ok']}/{n} frames OK, ATE "
        f"{res['ate_dataset_m']:.6f} m against groundtruth.txt (limit "
        f"{TUM_ATE_LIMIT_M} m), {system.tracker.n_kfs} keyframes, {steps} "
        f"mapping steps, {tum_launches} matcher kernel launches, "
        f"{res['fps']:.2f} fps with the host I/O ({res['seconds']:.2f} s), "
        f"debug image {width}x{height}")
    if system.device.type != "cuda":
        raise AssertionError(f"run.main chose {system.device}")
    if res["ok"] < n - 2 or n != 20:
        raise AssertionError(f"{res['ok']} of {n} mini TUM frames OK")
    if not res["ate_dataset_m"] < TUM_ATE_LIMIT_M:
        raise AssertionError(f"mini TUM ATE {res['ate_dataset_m']} m")
    if (len(ts) != len(want_ts)
            or np.abs(np.asarray(ts) - want_ts).max() > 1e-6
            or max(np.abs(c - wc).max() for (_, c), (_, wc)
                   in zip(poses, want)) > 1e-6):
        raise AssertionError("the saved trajectory is not the composed one")
    if (width, height) != (640, 500):
        raise AssertionError(f"debug image {width}x{height}, not 640x500")
    if tum_launches != 4 * n + 8 * steps:
        raise AssertionError(f"matcher kernel launched {tum_launches} times, "
                             f"the path makes {4 * n} + {8 * steps}")

    # the same frames decoded one by one into float images
    indexed = System(presets.get("tum1"), enable_loop_closing=False)
    indexed.track_chunk(np.stack([ds[i][0] for i in range(n)]),
                        np.stack([ds[i][1] for i in range(n)]),
                        ds.timestamps)
    differ = [i for i, (a, b) in enumerate(zip(indexed.records,
                                               system.records))
              if a.state != b.state or not np.array_equal(a.c_w, b.c_w)
              or not np.array_equal(a.R_wc, b.R_wc)]
    log(f"cli: the indexed float decode of the same frames: "
        f"{len(indexed.records)} records, {len(differ)} differ from the "
        f"prefetcher's wire-format run")
    if differ or len(indexed.records) != n:
        raise AssertionError(f"records differ at frames {differ}")

    match_kernel.LAUNCHES = 0
    res = run.main(["--dataset", "synthetic", "--frames",
                    str(CLI_SYNTHETIC_FRAMES), "--render-workers",
                    str(RENDER_WORKERS)])
    synth_launches = match_kernel.LAUNCHES
    system = res["system"]
    lc = system.loop_closer
    # every frame OK: no relocalization attempt and no replay
    expected = (4 * res["frames"] + 8 * system.mapper.n_executed
                + 3 * lc.n_ladders + 9 * lc.n_corrections)
    log(f"cli: synthetic orbit through run.main, loop closing on: "
        f"{res['ok']}/{res['frames']} frames OK, ATE {res['ate_m']:.6f} m "
        f"(limit {TUM_ATE_LIMIT_M} m), {lc.n_loops_closed} loops, "
        f"{system.mapper.n_executed} mapping steps, {synth_launches} matcher "
        f"kernel launches, {res['fps']:.2f} fps")
    if res["ok"] != CLI_SYNTHETIC_FRAMES:
        raise AssertionError(f"{res['ok']} of {CLI_SYNTHETIC_FRAMES} OK")
    if not res["ate_m"] < TUM_ATE_LIMIT_M:
        raise AssertionError(f"synthetic ATE {res['ate_m']} m")
    if synth_launches != expected:
        raise AssertionError(f"matcher kernel launched {synth_launches} "
                             f"times, the path makes {expected}")
    return tum_launches, synth_launches, tum_args, {
        "decode_ms_per_frame": decode_ms, "tum_fps_with_host_io": tum_fps,
        "synthetic_fps_with_host_io": res["fps"]}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_dry_mesh(torch, mesh):
    """Phase 18, first part: the reference's multi-chip dry run on the
    mesh. Returns the GBA chunk's numbers."""
    import torch.distributed as dist
    from orb_slam_2_ros_tpu_torch import profiling
    from orb_slam_2_ros_tpu_torch.config import SlamConfig
    from orb_slam_2_ros_tpu_torch.geometry import camera, se3
    from orb_slam_2_ros_tpu_torch.parallel import dist_ba, dist_pose
    from orb_slam_2_ros_tpu_torch.solvers import ba

    cfg = SlamConfig()
    dev = mesh.device
    rng = np.random.default_rng(0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # the pose LM, edges split over the mp axis
    n = DRY_POSE_EDGES
    pts = t(np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                      rng.uniform(2, 6, n)], -1))
    q_true, t_true = se3.exp(t([0.05, -0.02, 0.03, 0.01, -0.02, 0.005]))
    uvr = camera.project_stereo(cfg.camera, se3.apply(q_true, t_true, pts))
    q, tt, inl, n_in = dist_pose.distributed_pose_optimization(
        mesh, t([1.0, 0, 0, 0]), t([0.0, 0, 0]), pts, uvr[:, :2], uvr[:, 2],
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev), cfg)
    pose_err = float(torch.linalg.norm(se3.log(*se3.relative(
        q, tt, q_true, t_true))))
    log(f"mesh dry run: pose LM over {n} edges: error {pose_err:.3e} "
        f"(limit 1e-3), {int(n_in)}/{n} inliers")
    if not pose_err < 1e-3 or int(n_in) != n or not bool(inl.all()):
        raise AssertionError(f"distributed pose LM: error {pose_err}, "
                             f"{int(n_in)} inliers")

    # the edge-split BA: 4 cameras, one free
    nc, npt = DRY_BA_CAMS, DRY_BA_POINTS
    pw = t(np.stack([rng.uniform(-2, 2, npt), rng.uniform(-1, 1, npt),
                     rng.uniform(3, 7, npt)], -1))
    q_c, t_c = se3.exp(t([[0.2 * i, 0.0, 0.0, 0.0, 0.01 * i, 0.0]
                          for i in range(nc)]))
    ci = torch.arange(nc, device=dev).repeat_interleave(npt)
    mi = torch.arange(npt, device=dev).repeat(nc)
    E = nc * npt
    prob = ba.BAProblem(
        cam_idx=ci, mp_idx=mi, obs=camera.project_stereo(
            cfg.camera, se3.apply(q_c[ci], t_c[ci], pw[mi])),
        is_stereo=torch.ones(E, dtype=torch.bool, device=dev),
        inv_sigma2=torch.ones(E, device=dev),
        valid=torch.ones(E, dtype=torch.bool, device=dev))
    q1, t1 = se3.compose(*se3.exp(t([0.02, -0.01, 0.01, 0.005, -0.01,
                                     0.004])), q_c[1], t_c[1])
    q_p, t_p = q_c.clone(), t_c.clone()
    q_p[1], t_p[1] = q1, t1
    cam_free = torch.zeros(nc, dtype=torch.bool, device=dev)
    cam_free[1] = True
    free = torch.ones(npt, dtype=torch.bool, device=dev)
    got = dist_ba.distributed_bundle_adjustment(
        mesh, q_p, t_p, cam_free, pw, free, prob, cfg, phases=(3, 3),
        cg_iters=10)
    want = ba.bundle_adjustment(q_p, t_p, cam_free, pw, free, prob, cfg,
                                phases=(3, 3), cg_iters=10)
    diff = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    ba_err = float(torch.linalg.norm(se3.log(*se3.relative(
        got[0][1], got[1][1], q_c[1], t_c[1]))))
    log(f"mesh dry run: BA over {E} edges, camera 1 free: error "
        f"{ba_err:.3e} (limit 1e-3), largest difference from "
        f"bundle_adjustment {diff:.3e} (limit 1e-5), inlier masks "
        f"{'equal' if torch.equal(got[3], want[3]) else 'DIFFER'}")
    if not ba_err < 1e-3 or not diff <= 1e-5 or not torch.equal(got[3],
                                                                 want[3]):
        raise AssertionError(f"distributed BA: error {ba_err}, difference "
                             f"{diff}")

    # the point-and-edge-split GBA chunk at the reference's scale
    K, P, M = DRY_GBA_K, DRY_GBA_P, DRY_GBA_M
    rng = np.random.default_rng(7)
    pw = t(np.stack([rng.uniform(-4, 4, M), rng.uniform(-2, 2, M),
                     rng.uniform(2, 10, M)], -1))
    ang = 2 * np.pi * np.arange(K) / K
    q_b, t_b = se3.exp(t(np.stack([np.zeros(K), ang, np.zeros(K),
                                   0.1 * np.sin(ang), np.zeros(K),
                                   0.05 * np.cos(ang)], -1)))
    ci = torch.arange(K, device=dev).repeat_interleave(P)
    mi = t(rng.integers(0, M, K * P), torch.int64)
    E = K * P
    prob = ba.BAProblem(
        cam_idx=ci, mp_idx=mi, obs=camera.project_stereo(
            cfg.camera, se3.apply(q_b[ci], t_b[ci], pw[mi])),
        is_stereo=torch.ones(E, dtype=torch.bool, device=dev),
        inv_sigma2=torch.ones(E, device=dev),
        valid=torch.ones(E, dtype=torch.bool, device=dev))
    cam_free = torch.ones(K, dtype=torch.bool, device=dev)
    cam_free[0] = False
    st = dist_ba.shard_gba_state(mesh, ba.gba_init(
        q_b, t_b, cam_free, pw, torch.ones(M, dtype=torch.bool, device=dev),
        dist_ba.pad_problem(prob, mesh.shape["mp"]), K, M, cfg), cfg)
    n_lm = 2
    st = dist_ba.distributed_gba_chunk(mesh, st, cfg, n_iters=n_lm,
                                       cg_iters=DRY_GBA_CG)  # warm-up
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        st = dist_ba.distributed_gba_chunk(mesh, st, cfg, n_iters=n_lm,
                                           cg_iters=DRY_GBA_CG)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / n_lm)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = dist_ba.distributed_gba_chunk(mesh, st, cfg, n_iters=1,
                                           cg_iters=DRY_GBA_CG)
        torch.cuda.synchronize()
    launches, busy_ms = profiling.raw_counts(prof)
    card = command_output(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])
    finite = bool(torch.isfinite(st.pos).all() and torch.isfinite(st.q).all())
    log(f"mesh dry run: GBA chunk over {E} edges and a {M}-point pool, "
        f"{mesh.shape} on {dist.get_backend()}, cg {DRY_GBA_CG}: ms per LM "
        f"iteration {[round(x, 3) for x in ms]} (host clock around "
        f"synchronized 2-iteration chunks), "
        f"{launches} kernel launches and {busy_ms:.3f} device-busy ms per "
        f"LM iteration (torch.profiler); card {card}")
    if not finite:
        raise AssertionError("the GBA chunk gave non-finite values")
    return {"gba_ms_per_lm_iter": ms,
            "gba_launches_per_lm_iter": launches,
            "gba_device_busy_ms_per_lm_iter": busy_ms,
            "gba_edges": E, "gba_points": M, "gba_cg_iters": DRY_GBA_CG}


def run_mesh_system(torch, match_kernel, bench, timing, loop_seq, voc,
                    mesh):
    """Phase 18, second part: the full system on the mesh over the loop.
    Returns the kernel launches of the run, the four calls of frame
    ``MESH_CAPTURE_FRAME`` and the run's numbers."""
    from torch.profiler import ProfilerActivity, profile
    from orb_slam_2_ros_tpu_torch import profiling
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK
    from orb_slam_2_ros_tpu_torch.solvers import ba

    cfg, ds, grays, depths = loop_seq
    n = N_LOOP_FRAMES
    system = System(cfg, vocab=voc, mesh=mesh)
    lc = system.loop_closer
    if (system.device.type != "cuda" or system.mapper.mesh is not mesh
            or lc.mesh is not mesh):
        raise AssertionError("the mesh did not reach the mapper and the "
                             "loop closer on the card")
    # count the sharded calls of the run, and profile the first GBA chunk
    counted = {"windowed": 0, "gba_chunks": 0}
    gba = {"chunk_ms": []}
    dwba, gstep = loop_closing.dist_ba.distributed_windowed_ba, \
        loop_closing._gba_step
    from orb_slam_2_ros_tpu_torch.pipeline import local_mapping

    def windowed(*args, **kwargs):
        counted["windowed"] += 1
        return dwba(*args, **kwargs)

    def step(g, cfg_, mesh_=None):
        if not isinstance(g, ba.GBAState) or mesh_ is not mesh:
            raise AssertionError("the loop GBA left the mesh path")
        counted["gba_chunks"] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if "launches" in gba:
            out = gstep(g, cfg_, mesh_)
            torch.cuda.synchronize()
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = gstep(g, cfg_, mesh_)
                torch.cuda.synchronize()
            gba["launches"], gba["device_busy_ms"] = \
                profiling.raw_counts(prof)
            gba["edges"] = int(g.prob.cam_idx.shape[0])
        gba["chunk_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    local_mapping.dist_ba.distributed_windowed_ba = windowed
    loop_closing._gba_step = step
    C = system.tracker.CHUNK
    match_kernel.LAUNCHES = 0
    t_run = time.perf_counter()
    try:
        for w0 in range(0, n, C):
            with timing.capture_calls(matcher, "masked_best_two") as calls:
                system.track_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                                   ds.timestamps[w0:w0 + C])
            if w0 == MESH_CAPTURE_FRAME:
                path_args = [(label.replace("path:", "mesh system:"), a)
                             for label, a in bench.label_path_calls(
                                 calls[:4])]
        system.flush()
        torch.cuda.synchronize()
    finally:
        local_mapping.dist_ba.distributed_windowed_ba = dwba
        loop_closing._gba_step = gstep
    run_s = time.perf_counter() - t_run
    launches = match_kernel.LAUNCHES

    recs = system.records
    n_ok = sum(r.state == OK for r in recs)
    steps = system.mapper.n_executed
    ate, live = composed_ate(system, ds)
    expected = (4 * n + 8 * steps + loop_closing.LADDER_LAUNCHES * lc.n_ladders
                + loop_closing.N_FUSE_ROWS * lc.n_corrections)
    gba_started = lc.n_gba_finished + lc.n_gba_aborts
    log(f"mesh system: {n_ok}/{n} frames OK, {lc.n_loops_closed} loops "
        f"closed, {lc.n_ladders} Sim3 ladders, GBAs started {gba_started}, "
        f"finished {lc.n_gba_finished}, rejected {lc.n_gba_rejected}, "
        f"aborted {lc.n_gba_aborts}, composed ATE {ate:.6f} m ({live:.6f} m "
        f"as tracked; limit {MESH_ATE_LIMIT_M:.6f} m; the reference's mesh "
        f"run {REFERENCE_MESH_ATE_M} m), {system.tracker.n_kfs} keyframe "
        f"rows, {steps} mapping steps ({counted['windowed']} windowed BAs on "
        f"the mesh), {counted['gba_chunks']} GBA chunks on the mesh, "
        f"{launches} matcher kernel launches (the path makes {expected})")
    if gba.get("launches") is not None:
        log(f"mesh system: first GBA chunk ({gba['edges']} edges, "
            f"{loop_closing.GBA_CHUNK_ITERS} LM iterations of 100 CG "
            f"iterations): {gba['launches']} kernel launches, "
            f"{gba['device_busy_ms']:.3f} device-busy ms (torch.profiler); "
            f"chunk wall ms {[round(x, 1) for x in gba['chunk_ms']]} (the "
            f"first under the profiler)")
    log(f"mesh system: {n / run_s:.2f} fps over the run and the flush (host "
        f"clock)")
    if n_ok != n:
        bad = [i for i, r in enumerate(recs) if r.state != OK]
        raise AssertionError(f"mesh system: frames not OK: {bad}")
    if lc.n_loops_closed < 1 or lc.n_gba_finished < 1:
        raise AssertionError(f"mesh system: {lc.n_loops_closed} loops, "
                             f"{lc.n_gba_finished} GBAs finished")
    if counted["windowed"] != steps or counted["gba_chunks"] < 1:
        raise AssertionError(f"mesh system: {counted} for {steps} steps")
    if launches != expected:
        raise AssertionError(f"mesh system: matcher kernel launched "
                             f"{launches} times, the path makes {expected}")
    check_pools(system.tracker.map)
    if lc.gba_running or lc._pending_verdict:
        raise AssertionError("mesh system: flush left work behind")
    for f in ("kf_q", "kf_t", "mp_pos"):
        if not bool(torch.isfinite(getattr(system.tracker.map, f)).all()):
            raise AssertionError(f"mesh system: {f} is not finite")
    if not ate < MESH_ATE_LIMIT_M:
        raise AssertionError(f"mesh system: ATE {ate} m >= "
                             f"{MESH_ATE_LIMIT_M} m")
    return launches, path_args, {
        "frames_ok": n_ok, "loops_closed": lc.n_loops_closed,
        "gba_started": gba_started, "gba_finished": lc.n_gba_finished,
        "gba_rejected": lc.n_gba_rejected, "ate_composed_m": ate,
        "ate_tracked_m": live, "mapping_steps": steps,
        "gba_chunk_launches": gba.get("launches"),
        "gba_chunk_device_busy_ms": gba.get("device_busy_ms"),
        "gba_chunk_ms": gba["chunk_ms"], "fps": n / run_s}


def run_mesh_cli():
    """Phase 18, last part: the CLI with ``--mesh`` in its own process."""
    cmd = [sys.executable, "-m", "orb_slam_2_ros_tpu_torch.run", "--dataset",
           "synthetic", "--frames", str(CLI_SYNTHETIC_FRAMES),
           "--render-workers", str(RENDER_WORKERS), "--mesh"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.splitlines()
    mesh_line = [ln for ln in lines if ln.startswith("rank 0: mesh ")]
    log(f"mesh cli: {' '.join(cmd[1:])}: exit {out.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; "
        + (mesh_line[0] if mesh_line else "NO mesh line") + "; "
        + "; ".join(ln for ln in lines if ln.startswith(("done:", "ATE",
                                                          "loops"))))
    if out.returncode != 0 or mesh_line != [
            "rank 0: mesh {'kf': 1, 'mp': 1} over 1 ranks (nccl)"]:
        raise AssertionError(f"the mesh CLI failed: {out.stderr[-2000:]}")


def check_and_time(torch, match_kernel, bench, timing, cases, floor, err,
                   timed):
    """The kernel on captured arguments: equal to the plain version, and
    timed as in phase 4. Returns the largest difference."""
    for label, args in cases:
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        err = max(err, bench.assert_equal(got, want, label))
        timed.append(time_kernel(match_kernel, bench, timing, label, args,
                                 floor))
    return err


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

    # 2. build: the kernel with nvcc and the native host library with g++,
    # both started together
    from orb_slam_2_ros_tpu_torch import native
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        built = [pool.submit(_build.build, "masked_best_two"),
                 pool.submit(native.build)]
        lib, native_lib = (b.result() for b in built)
    log(f"built {os.path.relpath(lib)} and {os.path.relpath(native_lib)} in "
        f"{time.perf_counter() - t0:.2f} s (the native library's PNG "
        f"decoder: {native.DECODER})")

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
    launches, path_args, orbit = run_main_path(torch, match_kernel, bench,
                                               timing)

    # 6. the kernel on the path's own arguments
    for label, args in path_args:
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        err = max(err, bench.assert_equal(got, want, label))
        timed.append(time_kernel(match_kernel, bench, timing, label, args,
                                 floor))

    # 7. the mapping path
    loop_seq = render_loop()
    map_launches, fusion_args = run_mapping_path(torch, match_kernel, timing,
                                                 loop_seq)

    # 8. the kernel on one fusion call's own arguments, both directions
    for label, args in fusion_args:
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        err = max(err, bench.assert_equal(got, want, label))
        timed.append(time_kernel(match_kernel, bench, timing, label, args,
                                 floor))

    # 9. the full system, loop closing on
    full_launches, lc_launches, loop_args, voc = run_full_system(
        torch, match_kernel, timing, loop_seq)

    # 10. the kernel on the loop-closing calls' own arguments
    for label, args in loop_args:
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        err = max(err, bench.assert_equal(got, want, label))
        timed.append(time_kernel(match_kernel, bench, timing, label, args,
                                 floor))

    # 11. relocalization at full size: a forced loss
    (reloc_path_launches, reloc_launches, reloc_ok_ms, reloc_fail_ms,
     reloc_args) = run_relocalization(torch, match_kernel, timing)

    # 12. the kernel on the successful attempt's widening call
    err = check_and_time(torch, match_kernel, bench, timing, reloc_args,
                         floor, err, timed)

    # 13. the stereo sensor at full width, its frame's four calls, and
    # its forced loss
    (stereo_launches, stereo_loss_launches, stereo_attempts,
     stereo_args) = run_stereo(torch, match_kernel, bench, timing)
    err = check_and_time(torch, match_kernel, bench, timing, stereo_args,
                         floor, err, timed)

    # 14. the monocular sensor: the reference bench's mono pass, then the
    # kernel on one mono frame's four calls
    mono_launches, mono_args, mono_init_s = run_mono(
        torch, match_kernel, bench, timing, orbit)
    err = check_and_time(torch, match_kernel, bench, timing, mono_args,
                         floor, err, timed)

    # 15. map I/O, localization-only mode and the merge, then the kernel on
    # one VO search call; 16. the vocabulary at ORBvoc scale
    with tempfile.TemporaryDirectory() as workdir:
        (loc_launches, loc_attempts, vo_args, merge) = run_map_io(
            torch, match_kernel, bench, timing, loop_seq, voc, workdir)
        err = check_and_time(torch, match_kernel, bench, timing, vo_args,
                             floor, err, timed)
        vocab_load_s, vocab_transform_ms = run_vocab_scale(torch, workdir)

        # 17. the CLI on the mini TUM sequence and on a synthetic orbit,
        # then the kernel on one real frame's four calls
        tum_launches, cli_synth_launches, tum_args, cli = run_cli(
            torch, match_kernel, bench, timing, workdir)
        err = check_and_time(torch, match_kernel, bench, timing, tum_args,
                             floor, err, timed)

    # 18. the distributed back end on the card: a world of 1 on NCCL
    import torch.distributed as dist
    from orb_slam_2_ros_tpu_torch.parallel import multihost
    rank = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = multihost.global_mesh()
        log(f"mesh: rank {rank}, {mesh.shape} over {mesh.world} rank(s) on "
            f"{dist.get_backend()}, {mesh.device}")
        if dist.get_backend() != "nccl" or mesh.world != 1:
            raise AssertionError(f"the mesh runs {dist.get_backend()} over "
                                 f"{mesh.world} ranks")
        mesh_numbers = run_dry_mesh(torch, mesh)
        mesh_launches, mesh_args, mesh_run = run_mesh_system(
            torch, match_kernel, bench, timing, loop_seq, voc, mesh)
        mesh_numbers.update(mesh_run)
        err = check_and_time(torch, match_kernel, bench, timing, mesh_args,
                             floor, err, timed)
    finally:
        multihost.shutdown()
    run_mesh_cli()

    log(f"matcher kernel launches: {launches} on the tracking path, "
        f"{map_launches} on the mapping path, {full_launches} on the full "
        f"system's path ({lc_launches} of them by loop closing), "
        f"{reloc_path_launches} on the relocalization path "
        f"({sum(reloc_launches)} by relocalization), {stereo_launches} on "
        f"the stereo paths, {stereo_loss_launches} on the stereo forced "
        f"loss, {mono_launches} on the mono path, {loc_launches} on the "
        f"localization path, {tum_launches} on the CLI's mini TUM run, "
        f"{cli_synth_launches} on the CLI's synthetic run, {mesh_launches} "
        f"on the mesh system's path")
    by_path = {"tracking": launches, "mapping": map_launches,
               "full_system": full_launches,
               "loop_closing_within_full_system": lc_launches,
               "relocalization": reloc_path_launches,
               "relocalization_attempts": reloc_launches,
               "stereo": stereo_launches,
               "stereo_relocalization": stereo_loss_launches,
               "stereo_relocalization_attempts": stereo_attempts,
               "mono": mono_launches, "localization": loc_launches,
               "localization_relocalization_attempts": loc_attempts,
               "cli_mini_tum": tum_launches,
               "cli_synthetic": cli_synth_launches,
               "mesh_system": mesh_launches}
    launches += (map_launches + full_launches + reloc_path_launches
                 + stereo_launches + stereo_loss_launches + mono_launches
                 + loc_launches + tum_launches + cli_synth_launches
                 + mesh_launches)

    # the headline numbers are the local-map search's, the largest call of
    # a frame: random gates at its shape; "cases" holds every case
    main_case = timed[1]
    log(json.dumps({"kernels": [{
        "name": "masked_best_two", "route": "cuda",
        "source": "orb_slam_2_ros_tpu_torch/csrc/masked_best_two.cu",
        "replaces": "orb_slam_2_ros_tpu/ops/pallas_match.py:121",
        "launches": launches, "max_abs_err": err,
        "launches_by_path": by_path,
        "ms": main_case["graph_us"] / 1e3,
        "plain_ms": main_case["plain_us"] / 1e3,
        "bound_ms": main_case["bound_us"] / 1e3,
        "bound_by": main_case["bound_by"], "library_ms": None,
        "bound_us": main_case["bound_us"], "floor_us": floor,
        "host_us_per_call": main_case["host_us_per_call"],
        "relocalization_attempt_ms": {"successful": reloc_ok_ms,
                                      "failed": reloc_fail_ms},
        "mono_init_s": mono_init_s, "merge": merge,
        "orbvoc_load_s": vocab_load_s,
        "orbvoc_transform_ms": vocab_transform_ms, "cli": cli,
        "mesh": mesh_numbers,
        "cases": timed}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
