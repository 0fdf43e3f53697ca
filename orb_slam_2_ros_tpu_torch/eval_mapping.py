"""What local mapping does to the trajectory on the card, from one run.

    python -m orb_slam_2_ros_tpu_torch.eval_mapping

Runs ``chip_smoke.py``'s 224-frame synthetic loop at the reference operating
point three times on ``cuda``: the tracker alone, then
``System(cfg, enable_loop_closing=False)`` twice. For each pass it prints
the frames tracked, the ATE (rigid alignment) of the poses as tracked and of
the trajectory composed through the keyframes' final poses, the keyframe and
map-point counts, the points culled and the frame rate (host clock around
the pass, synchronised). The two passes of the system must agree in every
count: the mapper's float sums are made in a fixed order
(``ops/segment.py``), so a run repeats. The last line is a JSON summary,
also written to ``chiprun_out/eval_mapping.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
from orb_slam_2_ros_tpu_torch.io import ate_rmse, render_frames
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker

N_FRAMES = 224
OUT = os.path.join("chiprun_out", "eval_mapping.json")


def run_pass(name, make, ds, grays, depths):
    """One pass over the sequence in chunks of 16. ``make`` builds a
    ``Tracker`` or a ``System``; both take chunks the same way."""
    runner = make()
    system = runner if isinstance(runner, System) else None
    tracker = runner.tracker if system else runner
    feed = runner.track_chunk if system else runner.process_chunk
    C = tracker.CHUNK
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w0 in range(0, N_FRAMES, C):
        feed(grays[w0:w0 + C], depths[w0:w0 + C], ds.timestamps[w0:w0 + C])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    recs = tracker.records
    gt = [ds.gt_pose_wc(i)[1] for i in range(N_FRAMES)]
    poses, ts = tracker.composed_trajectory()
    index = {t: i for i, t in enumerate(ds.timestamps)}
    m = tracker.map
    out = {
        "pass": name, "ok_frames": sum(r.state == OK for r in recs),
        "ate_tracked_m": float(ate_rmse(np.stack([r.c_w for r in recs]),
                                        np.stack(gt))),
        "ate_composed_m": float(ate_rmse(
            np.stack([c for _, c in poses]),
            np.stack([gt[index[t]] for t in ts]))),
        "keyframe_rows": tracker.n_kfs,
        "keyframes_valid": int(m.kf_valid.sum()),
        "n_mps": int(m.n_mps), "map_points_valid": int(m.mp_valid.sum()),
        "points_culled": system.n_culled_total if system else 0,
        "mapping_steps": system.mapper.n_executed if system else 0,
        "fps": N_FRAMES / seconds}
    print(json.dumps(out), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("eval_mapping: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    ds, grays, depths = render_frames(cfg, N_FRAMES, workers=6, seed=0,
                                      trajectory="loop")
    passes = [
        run_pass("tracker alone", lambda: Tracker(cfg), ds, grays, depths),
        run_pass("system, first run",
                 lambda: System(cfg, enable_loop_closing=False), ds, grays,
                 depths),
        run_pass("system, second run",
                 lambda: System(cfg, enable_loop_closing=False), ds, grays,
                 depths)]
    counts = ("ok_frames", "keyframe_rows", "keyframes_valid", "n_mps",
              "map_points_valid", "points_culled", "mapping_steps")
    differ = [k for k in counts if passes[1][k] != passes[2][k]]
    if differ:
        raise AssertionError(f"two runs of the system differ in {differ}")
    result = {"card": smi, "frames": N_FRAMES, "passes": passes,
              "system_runs_agree_in": list(counts)}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
