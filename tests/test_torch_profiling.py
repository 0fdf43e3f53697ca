"""The stage profiler of the port (``orb_slam_2_ros_tpu_torch.profiling``)
on the CPU, at a small size: the program's own spans, seen as the
profiler's ``slam.*`` ranges, give every stage of the tracking step as often
as the step calls it, each nested inside its parent's row."""

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


def _parts_within_parents(rows, key):
    """Each row's host time against the sum of its parts' (the rows one
    level deeper listed after it, up to the next row at its level)."""
    for i, row in enumerate(rows):
        inner = 0.0
        for child in rows[i + 1:]:
            if child["depth"] <= row["depth"]:
                break
            if child["depth"] == row["depth"] + 1:
                inner += child[key]
        assert inner <= row[key], row["stage"]


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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracker.process_chunk(grays, depths, ds.timestamps[:2])

    s = profiling.summarize(prof.events(), 2)
    per = {row["stage"]: row for row in s["stages"]}
    calls = {name: row["calls_per_frame"] for name, row in per.items()}
    assert calls == {
        "tracking.frame_step": 1, "frontend": 1, "frontend.extract": 1,
        "frontend.resize_linear": N_LEVELS - 1,
        "frontend.fast_score_map": N_LEVELS, "frontend.detect": N_LEVELS,
        "frontend.budget_cut": N_LEVELS, "frontend.gaussian_blur": N_LEVELS,
        "frontend.ic_angles": N_LEVELS, "frontend.descriptors": N_LEVELS,
        "frontend.stereo": 0, "tracking.search": 4,
        "tracking.search_by_projection_pose": 1,
        "tracking.search_reference_kf": 1, "tracking.pose_solve": 2,
        "tracking.frustum_check": 1, "tracking.search_local_map": 1,
        "tracking.map_update": 2, "tracking.bump_visibility": 1,
        "tracking.commit_keyframe": 1, "tracking.fetch": 0.5}
    # each stage encloses the stages one level deeper listed after it
    _parts_within_parents(s["stages"], "host_ms_per_frame")
    for parent in ("frontend", "tracking.frame_step", "tracking.search"):
        assert per[parent]["host_ms_per_frame"] > 0, parent
    # no card: nothing was launched or run on a device
    assert s["launches_per_frame"] == 0 and s["device_busy_ms_per_frame"] == 0
    assert "tracking.pose_solve" in profiling.stage_table(s["stages"])
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mapper.run(tracker.carry.m, tracker.carry.last_mp)
    assert mapper.n_executed == 1

    s = profiling.summarize(prof.events(), 1, stages, unit="step")
    per = {row["stage"]: row for row in s["stages"]}
    assert {name: row["calls_per_step"] for name, row in per.items()} == {
        "mapping.mapping_step": 1, "mapping.covisibility": 1,
        "mapping.create_new_map_points": 1,
        "mapping.search_for_triangulation": 3, "mapping.triangulate_dlt": 3,
        "mapping.fuse_duplicates": 1,
        "mapping.search_by_projection_pose": 2 * 2,
        "mapping.windowed_bundle_adjustment": 1, "mapping.cull_keyframes": 1,
        "mapping.compact_points": 1, "mapping.refresh_point_stats": 1}
    _parts_within_parents(s["stages"], "host_ms_per_step")
    assert per["mapping.mapping_step"]["host_ms_per_step"] > 0
    assert s["launches_per_step"] == 0 and s["device_busy_ms_per_step"] == 0
    assert "mapping.windowed_bundle_adjustment" in profiling.stage_table(
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


def test_loop_stage_ranges_count_every_program():
    """The loop profile's ranges over the port's closer on the drifted ring
    of ``tests/test_loop_closing.py`` (CPU): every program and part is seen
    as often as the closer's own counters say, and the matcher's projection
    search 3 times per ladder and 9 times per correction."""
    import dataclasses

    from orb_slam_2_ros_tpu_torch import convert
    from orb_slam_2_ros_tpu_torch.pipeline.loop_closing import LoopCloser
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    from orb_slam_2_ros_tpu.config import SolverConfig
    from test_loop_closing import N_KF, build_looped_map, small_cfg

    # one structure-only GBA chunk, to keep the profile small
    jcfg = dataclasses.replace(small_cfg(),
                               solver=SolverConfig(global_ba_iters=5))
    jm, _, descs = build_looped_map(jcfg)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    m = convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in jm._asdict().items()}, "cpu")
    voc = vocabulary.train_vocabulary(descs, cfg, seed=0, device="cpu")
    lc = LoopCloser(cfg, voc, min_kfs_between_loops=6)
    stages = profiling.LOOP_STAGES
    n_calls = 8     # the reference's own test closes the ring in 8
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(n_calls):
            m, _ = lc.process(m, defer=False)
    assert lc.n_loops_closed == lc.n_corrections == 1 and lc.n_ladders >= 1

    s = profiling.summarize(prof.events(), 1, stages, unit="call")
    calls = {r["stage"]: r["calls_per_call"] for r in s["stages"]}
    L, X = lc.n_ladders, lc.n_corrections
    # one detection per ingested keyframe (4 a call), then one re-detection
    # per call
    detects = N_KF + n_calls - N_KF // 4
    assert calls == {
        "loop.ingest_and_detect": n_calls, "loop.transform": N_KF,
        "loop.bow_weights": N_KF, "loop.query": detects,
        "loop.detect_candidates": detects,
        # per call of the closer, per ladder (widening) and twice per
        # correction (the graph's edges, the fuse targets)
        "loop.covisibility": n_calls + L + 2 * X,
        "loop.sim3_ladder": L, "loop.search_by_node": L,
        "loop.ransac_sim3": L, "loop.refine_sim3_lm": L,
        "loop.search_by_projection_pose": 3 * L + 9 * X,
        "loop.apply_correction": X, "loop.essential_graph": X,
        "loop.correct_points": X, "loop.gba_start": X, "loop.gba_chunk": X,
        "loop.gba_finish": X}
    assert s["launches_per_call"] == 0
    assert "loop.essential_graph" in profiling.stage_table(s["stages"],
                                                           unit="call")


def test_reloc_stage_ranges_count_every_part():
    """The relocalization profile's spans over one attempt of the port's
    ``System`` (CPU, the small configuration over 16 frames): every part
    seen once, the pose LM twice (the candidates' batch and the final
    one)."""
    import dataclasses

    from orb_slam_2_ros_tpu.config import VocabConfig
    from orb_slam_2_ros_tpu_torch import convert
    from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    from test_torch_tracking import small_cfg

    cfg = convert.config_from_dict(dataclasses.asdict(dataclasses.replace(
        small_cfg(), vocab=VocabConfig(k=6, levels=3))))
    n = 16
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0)
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])
    train = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8),
                                              dtype=np.uint32)
    system = System(cfg, ba_window=8, device="cpu",
                    vocab=vocabulary.train_vocabulary(train, cfg, seed=0,
                                                      device="cpu"))
    system.track_chunk(grays, depths, ds.timestamps)
    stages = profiling.RELOC_STAGES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ok = system._attempt_reloc(*system._to_float_frame(grays[5],
                                                           depths[5]))[0]
    assert ok and system.n_relocalized == 1
    s = profiling.summarize(prof.events(), 1, stages, unit="attempt")
    calls = {r["stage"]: r["calls_per_attempt"] for r in s["stages"]}
    assert calls == {name: (2 if name == "reloc.pose_optimization" else 1)
                     for name, _ in stages}
    assert "reloc.candidate_ladder" in profiling.stage_table(
        s["stages"], unit="attempt")

