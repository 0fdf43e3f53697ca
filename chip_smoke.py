#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. card: nvidia-smi's name and power limit; torch, CUDA and nvcc versions;
  2. build: compile every kernel of the port from csrc/ (seconds);
  3. kernel check: the CUDA ``masked_best_two`` against its plain PyTorch
     version on the same CUDA tensors, at the tracking path's shapes
     (1536 x 1536 motion-model search, 4096 x 1536 local-map search), exact
     equality of all four outputs; median times over 20 runs (CUDA events);
  4. main path: ``Tracker(cfg, device="cuda")`` at the reference operating
     point (640x480, 1200 features, 8 levels, map of 256 keyframes by 16384
     points) over the 96-frame synthetic orbit in chunks of 16; every frame
     must be OK, ATE < 0.01 m, the map on the card, and the kernel launched
     exactly as often as the path says (4 per frame: the motion-model
     search and its predicated widened retry, the reference-keyframe
     search, the local-map search).

The last two lines are a JSON summary of the kernels and the JSON result.
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
KERNEL_SHAPES = ((1536, 1536), (4096, 1536))


def log(msg):
    print(msg, flush=True)


def command_output(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def make_case(N, M, seed):
    """Random descriptors and gate metadata, drawn like the reference's
    matcher-kernel oracle (tests/test_pallas_match.py::make_case)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32).view(np.int32)
    b = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32).view(np.int32)
    row_meta = np.zeros((8, N), np.float32)
    row_meta[0] = rng.uniform(0, 640, N)
    row_meta[1] = rng.uniform(0, 480, N)
    row_meta[2] = rng.uniform(30, 300, N)
    row_meta[3] = rng.integers(-1, 2, N)
    row_meta[4] = rng.integers(3, 8, N)
    row_meta[5] = np.where(rng.uniform(0, 1, N) < 0.5, -1.0,
                           rng.uniform(0, 640, N))
    row_meta[6] = rng.uniform(0, 1, N) > 0.15
    col_meta = np.zeros((8, M), np.float32)
    col_meta[0] = rng.uniform(0, 640, M)
    col_meta[1] = rng.uniform(0, 480, M)
    col_meta[2] = rng.integers(0, 8, M)
    col_meta[3] = np.where(rng.uniform(0, 1, M) < 0.5, -1.0,
                           rng.uniform(0, 640, M))
    col_meta[4] = rng.uniform(0, 1, M) > 0.15
    return a, row_meta, b, col_meta


def median_ms(torch, fn, args, n=20):
    fn(*args)                                   # warm up
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernel(torch, match_kernel):
    """Phase 3. Returns (max_abs_err over both shapes, ms, plain_ms at the
    local-map shape)."""
    worst = 0
    ms = plain_ms = None
    for seed, (N, M) in enumerate(KERNEL_SHAPES):
        args = [torch.from_numpy(x).cuda() for x in make_case(N, M, seed)]
        got = match_kernel.masked_best_two_cuda(*args)
        want = match_kernel.masked_best_two_reference(*args)
        torch.cuda.synchronize()
        names = ("best_idx", "best_d", "second_idx", "second_d")
        for name, g, w in zip(names, got, want):
            err = int((g.long() - w.long()).abs().max())
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(
                    f"masked_best_two {N}x{M}: {name} differs from the plain "
                    f"version on {int((g != w).sum())} rows (max |err| {err})")
        has = int((want[1] < 1024).sum())
        ms = median_ms(torch, match_kernel.masked_best_two_cuda, args)
        plain_ms = median_ms(torch, match_kernel.masked_best_two_reference,
                             args)
        log(f"kernel check {N}x{M}: all four outputs equal "
            f"({has}/{N} rows with a candidate); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (median of 20, CUDA events)")
    return worst, ms, plain_ms


def run_main_path(torch, match_kernel):
    """Phase 4. Returns the number of kernel launches on the path."""
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD, ate_rmse
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    t0 = time.perf_counter()
    ds = SyntheticRGBD(cfg, n_frames=N_FRAMES, seed=0, trajectory="orbit")
    grays = np.stack([ds[i][0] for i in range(N_FRAMES)])
    depths = np.stack([ds[i][1] for i in range(N_FRAMES)])
    log(f"rendered {N_FRAMES} frames of {cfg.camera.width}x"
        f"{cfg.camera.height} in {time.perf_counter() - t0:.1f} s (host)")

    tracker = Tracker(cfg, device="cuda")
    C = tracker.CHUNK
    chunk_s = []
    match_kernel.LAUNCHES = 0
    for w0 in range(0, N_FRAMES, C):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.process_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                              ds.timestamps[w0:w0 + C])
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
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
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs only on an NVIDIA card")
    from orb_slam_2_ros_tpu_torch import _build
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
    err, ms, plain_ms = check_kernel(torch, match_kernel)

    # 4. main path
    launches = run_main_path(torch, match_kernel)

    log(json.dumps({"kernels": [{
        "name": "masked_best_two", "route": "cuda",
        "source": "orb_slam_2_ros_tpu_torch/csrc/masked_best_two.cu",
        "replaces": "orb_slam_2_ros_tpu/ops/pallas_match.py:121",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
