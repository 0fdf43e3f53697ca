"""The stage profiler of the port (``orb_slam_2_ros_tpu_torch.profiling``)
on the CPU, at a small size: its ranges see every stage of the tracking
step as often as the step calls it, nest inside ``frame_step``, and leave
the wrapped functions as they were."""

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch import profiling
from orb_slam_2_ros_tpu_torch.config import (CameraConfig, MapConfig,
                                             OrbConfig, SENSOR_RGBD,
                                             SlamConfig, TrackingConfig)
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD
from orb_slam_2_ros_tpu_torch.pipeline import tracking

N_LEVELS = 3


def test_stage_ranges_count_every_stage():
    cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                       cy=59.5, bf=10.0, th_depth=50.0)
    cfg = SlamConfig(
        sensor=SENSOR_RGBD, camera=cam,
        orb=OrbConfig(n_features=200, n_levels=N_LEVELS, max_kps=256),
        map=MapConfig(max_kfs=4, max_mps=2048, max_kps=256, local_map_cap=256),
        tracking=TrackingConfig(min_init_stereo_kps=50))
    ds = SyntheticRGBD(cfg, n_frames=2, seed=0)
    grays = np.stack([ds[i][0] for i in range(2)])
    depths = np.stack([ds[i][1] for i in range(2)])
    tracker = tracking.Tracker(cfg, device="cpu")
    before = [getattr(mod, attr) for mod, attr, _, _ in profiling.STAGES]
    with profiling.stage_ranges(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracker.process_chunk(grays, depths, ds.timestamps[:2])
    assert [getattr(mod, attr) for mod, attr, _, _ in profiling.STAGES] \
        == before

    s = profiling.summarize(prof.events(), 2)
    per = {row["stage"]: row for row in s["stages"]}
    calls = {name: row["calls_per_frame"] for name, row in per.items()}
    assert calls == {
        "frame_step": 1, "build_frame": 1, "resize_linear": N_LEVELS - 1,
        "fast_score_map": N_LEVELS, "detect": N_LEVELS,
        "budget_cut": N_LEVELS, "gaussian_blur": N_LEVELS,
        "ic_angles": N_LEVELS, "descriptors": N_LEVELS,
        "search_by_projection_pose": 1, "search_reference_kf": 1,
        "pose_optimization": 2, "frustum_check": 1, "search_local_map": 1,
        "bump_visibility": 1, "commit_keyframe": 1}
    # each depth-0 stage encloses the depth-1 stages listed after it
    parts = {}
    for row in s["stages"]:
        if row["depth"] == 0:
            parent = row["stage"]
            parts[parent] = 0.0
        else:
            parts[parent] += row["host_ms_per_frame"]
    assert set(parts) == {"build_frame", "frame_step"}
    for parent, inner in parts.items():
        assert 0 < inner <= per[parent]["host_ms_per_frame"], parent
    # no card: nothing was launched or run on a device
    assert s["launches_per_frame"] == 0 and s["device_busy_ms_per_frame"] == 0
    assert "pose_optimization" in profiling.stage_table(s["stages"])
    assert all(r.state == tracking.OK for r in tracker.records)
