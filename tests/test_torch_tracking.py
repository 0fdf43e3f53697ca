"""Port parity of the RGB-D tracking slice: the port's Tracker against the
JAX Tracker on the same synthetic frames (small config of
tests/test_tracking_e2e.py, local-map cap 1024).

- One step from an identical start: the JAX tracker runs 4 frames, its
  TrackCarry crosses over through convert.py, and frame 5 runs on both
  sides: same state code, >= 98% equal kp -> map point associations, pose
  within 1e-4.
- The slice as a whole, 8 frames: identical per-frame state codes, inliers
  within 5%, camera centres within 5 mm, both ATEs below 0.03 m.
"""

import dataclasses

import numpy as np
import jax
import pytest

from orb_slam_2_ros_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                       SENSOR_RGBD, SlamConfig, TrackingConfig)
from orb_slam_2_ros_tpu.io import trajectory
from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.pipeline import tracking as jtrack
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

N_FRAMES = 8
STEP = 4            # frames the JAX tracker runs before the carry crosses


def small_cfg():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    return SlamConfig(
        sensor=SENSOR_RGBD, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640,
                      local_map_cap=1024),
        tracking=TrackingConfig(min_init_stereo_kps=200))


@pytest.fixture(scope="module")
def runs():
    """The JAX run (frames 0-3, then frame 4 alone, then 5-7; padded
    inactive frames are no-ops) with its carry after 4 and after 5 frames,
    and
    the port's run over all 8 frames."""
    cfg = small_cfg()
    ds = SyntheticRGBD(cfg, n_frames=N_FRAMES, seed=0)
    grays = np.stack([ds[i][0] for i in range(N_FRAMES)])
    depths = np.stack([ds[i][1] for i in range(N_FRAMES)])
    ts = list(ds.timestamps)

    jt = jtrack.Tracker(cfg)
    jt.process_chunk(grays[:STEP], depths[:STEP], ts[:STEP])
    carry_before = jax.device_get(jt.carry._asdict())
    jt.process_chunk(grays[STEP:STEP + 1], depths[STEP:STEP + 1],
                     ts[STEP:STEP + 1])
    carry_after = jax.device_get(jt.carry._asdict())
    jt.process_chunk(grays[STEP + 1:], depths[STEP + 1:], ts[STEP + 1:])

    # one configuration, handed to both sides: the port gets its own tree
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tt = ttrack.Tracker(tcfg, device="cpu")
    tt.process_chunk(grays, depths, ts)
    gt = np.stack([ds.gt_pose_wc(i)[1] for i in range(N_FRAMES)])
    return dict(cfg=tcfg, grays=grays, depths=depths, ts=ts, jax=jt, port=tt,
                carry_before=carry_before, carry_after=carry_after, gt=gt)


def test_one_step_from_identical_start(runs):
    cfg = runs["cfg"]
    tt = ttrack.Tracker(cfg, device="cpu")
    tt.carry = convert.track_carry_from_numpy(runs["carry_before"], "cpu")
    rec = tt.process(runs["grays"][STEP], runs["depths"][STEP],
                     runs["ts"][STEP])
    jrec = runs["jax"].records[STEP]
    assert rec.state == jrec.state == ttrack.OK
    after = runs["carry_after"]
    j_mp = np.asarray(after["last_mp"])
    t_mp = tt.carry.last_mp.numpy()
    agree = (j_mp == t_mp).mean()
    print(f"kp -> map point agreement {agree:.4f}; inliers "
          f"{jrec.n_inliers} / {rec.n_inliers}")
    assert agree >= 0.98
    np.testing.assert_allclose(tt.carry.t.numpy(), np.asarray(after["t"]),
                               atol=1e-4)
    np.testing.assert_allclose(tt.carry.q.numpy(), np.asarray(after["q"]),
                               atol=1e-4)
    np.testing.assert_allclose(rec.c_w, jrec.c_w, atol=1e-4)
    assert int(tt.carry.m.n_kfs) == int(after["m"].n_kfs)


def test_slice_matches_reference(runs):
    jrecs, trecs = runs["jax"].records, runs["port"].records
    assert len(jrecs) == len(trecs) == N_FRAMES
    assert [r.state for r in trecs] == [r.state for r in jrecs]
    assert all(r.state == ttrack.OK for r in trecs)
    for j, t in zip(jrecs, trecs):
        assert abs(t.n_inliers - j.n_inliers) <= 0.05 * j.n_inliers, (
            j.frame_id, j.n_inliers, t.n_inliers)
        assert t.is_keyframe == j.is_keyframe
    jc = np.stack([r.c_w for r in jrecs])
    tc = np.stack([r.c_w for r in trecs])
    print(f"max camera-centre difference {np.abs(jc - tc).max():.2e} m")
    np.testing.assert_allclose(tc, jc, atol=5e-3)
    ate_j = trajectory.ate_rmse(jc, runs["gt"])
    ate_t = trajectory.ate_rmse(tc, runs["gt"])
    print(f"ATE reference {ate_j:.5f} m, port {ate_t:.5f} m")
    assert ate_j < 0.03 and ate_t < 0.03
    # the map stays where the tracker was asked to put it
    assert all(v.device.type == "cpu"
               for v in runs["port"].map._asdict().values())


def test_composed_trajectory_and_records(runs):
    tt = runs["port"]
    poses, ts = tt.composed_trajectory()
    assert len(poses) == N_FRAMES and ts == runs["ts"]
    for (R, c), rec in zip(poses, tt.records):
        np.testing.assert_allclose(c, rec.c_w, atol=1e-4)
        np.testing.assert_allclose(R, rec.R_wc, atol=1e-4)
    wc, ts2 = tt.trajectory_wc()
    assert len(wc) == N_FRAMES and ts2 == runs["ts"]
    assert tt.flush() == []
    assert tt.n_kfs == runs["jax"].n_kfs


def test_unported_modes_raise():
    """The monocular sensor and localization-only mode are ported, so the
    tracker raises for neither. Neither initializes a map by itself: a mono
    tracker waits for the System's two-view initializer, and a
    localization-only tracker's map stays frozen."""
    cfg = small_cfg()
    gray, depth = SyntheticRGBD(cfg, n_frames=1, seed=0)[0]
    for c in (cfg.replace(sensor=0), cfg.replace(localization_only=True)):
        tracker = ttrack.Tracker(c, device="cpu")
        rec = tracker.process(gray, depth, 0.0)
        assert rec.state == ttrack.NOT_INITIALIZED and tracker.n_kfs == 0
    assert ttrack.Tracker(cfg.replace(sensor=0), device="cpu").chunk == 8
    assert ttrack.Tracker(cfg, device="cpu").chunk == 16
