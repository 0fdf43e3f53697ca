"""The stage profiler of the port (``orb_slam_2_ros_tpu_torch.profiling``)
on the CPU, at a small size: its ranges see every stage of the tracking
step as often as the step calls it, nest inside ``frame_step``, and leave
the wrapped functions as they were."""

import numpy as np
import pytest
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


def test_mapping_stage_ranges_count_every_part():
    """The mapping profile's ranges over one executed step on the CPU: each
    part is seen as often as the step calls it, nested under the step."""
    from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import LocalMapper

    cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                       cy=59.5, bf=10.0, th_depth=50.0)
    cfg = SlamConfig(
        sensor=SENSOR_RGBD, camera=cam,
        orb=OrbConfig(n_features=200, n_levels=N_LEVELS, max_kps=256),
        map=MapConfig(max_kfs=4, max_mps=2048, max_kps=256, local_map_cap=256,
                      tri_neighbors=3, fuse_neighbors=2),
        tracking=TrackingConfig(min_init_stereo_kps=50))
    ds = SyntheticRGBD(cfg, n_frames=2, seed=0)
    tracker = tracking.Tracker(cfg, device="cpu")
    tracker.process_chunk(np.stack([ds[i][0] for i in range(2)]),
                          np.stack([ds[i][1] for i in range(2)]),
                          ds.timestamps[:2])
    mapper = LocalMapper(cfg, window=2)
    stages = profiling.MAP_STAGES
    before = [getattr(mod, attr) for mod, attr, _, _ in stages]
    with profiling.stage_ranges(stages), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mapper.run(tracker.carry.m, tracker.carry.last_mp)
    assert [getattr(mod, attr) for mod, attr, _, _ in stages] == before
    assert mapper.n_executed == 1

    s = profiling.summarize(prof.events(), 1, stages, unit="step")
    per = {row["stage"]: row for row in s["stages"]}
    assert {name: row["calls_per_step"] for name, row in per.items()} == {
        "mapping_step": 1, "covisibility": 1, "create_new_map_points": 1,
        "search_for_triangulation": 3, "triangulate_dlt": 3,
        "fuse_duplicates": 1, "search_by_projection_pose": 2 * 2,
        "windowed_bundle_adjustment": 1, "cull_keyframes": 1,
        "compact_points": 1, "refresh_point_stats": 1}
    inner = sum(row["host_ms_per_step"] for row in s["stages"]
                if row["depth"] == 1)
    assert 0 < inner <= per["mapping_step"]["host_ms_per_step"]
    assert s["launches_per_step"] == 0 and s["device_busy_ms_per_step"] == 0
    assert "windowed_bundle_adjustment" in profiling.stage_table(
        s["stages"], unit="step")
    numbers = profiling.step_numbers(mapper.last_step)
    assert all(not isinstance(v, torch.Tensor) for v in numbers.values())
    assert numbers["n_ba_free"] > 0 and len(numbers["ba_iters"]) == 2


def test_kernel_by_name_sums_matching_rows():
    from types import SimpleNamespace as Row
    averages = [
        Row(key="void (anonymous namespace)::masked_best_two_kernel<2, 8, 4, "
                "256>(int const*)", count=12, device_time_total=96.0),
        Row(key="void (anonymous namespace)::masked_best_two_kernel<2, 8, 4, "
                "256>(int const*) [clone]", count=4, device_time_total=64.0),
        Row(key="masked_best_two_kernel", count=3, device_time_total=0),
        Row(key="at::native::vectorized_elementwise_kernel", count=100,
            device_time_total=150.0)]
    got = profiling.kernel_by_name(averages, profiling.MATCHER_KERNEL)
    assert got == {"launches": 16, "mean_device_us": 10.0}
    assert profiling.kernel_by_name(averages, "no_such_kernel") == {
        "launches": 0, "mean_device_us": None}


def test_bench_helpers_on_the_cpu():
    """What chip_smoke.py and the kernel bench share, at sizes the CPU
    takes: the bound's bytes at the path's shapes, the gate modes, the
    equality check and the call recorder."""
    from orb_slam_2_ros_tpu_torch import bench_match_kernel as bench
    from orb_slam_2_ros_tpu_torch import kernel_timing
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.ops import match_kernel

    args = tuple(torch.from_numpy(x) for x in bench.make_case(96, 160, 0))
    w = bench.work(args)
    assert w["bytes"] == 96 * 32 + 160 * 32 + 8 * 96 * 4 + 8 * 160 * 4 + 96 * 16
    assert w["pairs"] == 96 * 160 and 0 < w["passes"] < w["pairs"]
    assert w["ops"] == 15 * w["pairs"] + 25 * w["passes"]
    assert w["bound_by"] == "operations" and w["bound_us"] == w["ops_us"]
    # the path's shapes, from their sizes alone
    assert 2 * 1536 * 32 + 2 * 8 * 1536 * 4 + 1536 * 16 == 221184
    assert (4096 + 1536) * (32 + 32) + 4096 * 16 == 425984
    for gates, expect in (("open", 96 * 160), ("closed", 0)):
        case = tuple(torch.from_numpy(x)
                     for x in bench.make_case(96, 160, 1, gates))
        assert bench.work(case)["passes"] == expect

    want = match_kernel.masked_best_two_reference(*args)
    assert bench.assert_equal(want, want, "same") == 0
    wrong = list(want)
    wrong[1] = wrong[1] + 1
    with pytest.raises(AssertionError, match="best_d differs"):
        bench.assert_equal(wrong, want, "off by one")

    original = matcher.masked_best_two
    with kernel_timing.capture_calls(matcher, "masked_best_two") as calls:
        for _ in range(4):
            out = matcher.masked_best_two(*args)
    assert matcher.masked_best_two is original and len(calls) == 4
    assert all(torch.equal(o, w_) for o, w_ in zip(out, want))
    labelled = bench.label_path_calls(calls)
    assert [name for name, _ in labelled] == [
        "path: motion model", "path: motion model, widened",
        "path: reference keyframe", "path: local map"]
    with pytest.raises(AssertionError):
        bench.label_path_calls(calls[:3])
