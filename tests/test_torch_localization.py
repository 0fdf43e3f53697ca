"""Localization-only mode of the port against the reference (Slice 7a): the
scenario of ``tests/test_localization_vo.py``.

A normal session maps the view straight ahead (two frames, no BA, no loop
closing) and saves its map; a localization-only ``System`` loads it and
tracks a camera that yaws about 80 degrees, so the mapped wall leaves the
frustum and tracking must ride the temporal visual-odometry points
(``UpdateLastFrame``, ``Tracking.cc:893-968``). On the port, as the
reference test asks: every frame OK, no keyframe inserted, the first
frames anchored on the map (> 30 map inliers), the last frame under 10 map
inliers with at least 30 inliers in all, the final orientation within 5
degrees. Against the reference's records of the same run (it loads the
port's map, so both start from identical state): the same states, map
inliers and inliers within 2 of the reference's on every frame (measured:
equal but on the first four frames, 498 against 497), the final
orientations within 0.05 degrees of each other.

The ``Tracker`` frame step in VO mode is also held to the reference's on
one frame from an identical carry (the reference's after the run, the map
out of view): the same state, inliers within 2, the VO flags of the
keypoints and the re-spawned points' validity equal on >= 99% of the
slots, their positions within 1e-2 m where both are valid.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from orb_slam_2_ros_tpu.io.synthetic import make_room, render
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_localization_vo import _cfg, _yaw_pose

torch.set_num_threads(2)


def _angle_deg(R_a, R_b):
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(R_a.T @ R_b) - 1) / 2, -1, 1))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg()
    planes = make_room(0)
    c0 = np.zeros(3, np.float32)
    frames = [render(planes, *_yaw_pose(0.0, c0), cfg.camera)
              for _ in range(2)]
    mapper = tslam.System(convert.config_from_dict(dataclasses.asdict(cfg)),
                          enable_local_ba=False, enable_loop_closing=False,
                          device="cpu")
    recs = mapper.track_chunk(np.stack([f[0] for f in frames]),
                              np.stack([f[1] for f in frames]))
    assert recs[-1].state == ttrack.OK
    path = str(tmp_path_factory.mktemp("loc") / "m.npz")
    mapper.save_map(path)
    yaws = np.concatenate([np.zeros(3), np.linspace(0.0, 1.4, 29)])
    frames = [render(planes, *_yaw_pose(y, c0), cfg.camera) for y in yaws]
    grays = np.stack([f[0] for f in frames])
    depths = np.stack([f[1] for f in frames])
    loc = _cfg(localization_only=True)
    port = tslam.System(convert.config_from_dict(dataclasses.asdict(loc)),
                        enable_local_ba=False, load_map=path, device="cpu")
    trecs = port.track_chunk(grays, depths)
    ref = jslam.System(loc, enable_local_ba=False, load_map=path)
    jrecs = ref.track_chunk(grays, depths)
    return dict(port=port, ref=ref, trecs=trecs, jrecs=jrecs, yaws=yaws,
                c0=c0)


def test_port_survives_leaving_the_map(runs):
    recs = runs["trecs"]
    assert all(r.state == ttrack.OK for r in recs), [r.state for r in recs]
    assert not any(r.is_keyframe for r in recs)
    assert recs[1].n_map_inliers > 30
    assert recs[-1].n_map_inliers < 10 and recs[-1].n_inliers >= 30
    R_gt, _ = _yaw_pose(runs["yaws"][-1], runs["c0"])
    assert _angle_deg(R_gt, recs[-1].R_wc) < 5.0
    # the tracked frames took the temporal VO points
    assert bool(runs["port"].tracker.carry.last_vo.any())


def test_port_records_match_the_reference(runs):
    t, j = runs["trecs"], runs["jrecs"]
    assert [r.state for r in t] == [r.state for r in j]
    np.testing.assert_allclose([r.n_map_inliers for r in t],
                               [r.n_map_inliers for r in j], atol=2)
    np.testing.assert_allclose([r.n_inliers for r in t],
                               [r.n_inliers for r in j], atol=2)
    assert _angle_deg(t[-1].R_wc, j[-1].R_wc) < 0.05
    assert [r.is_keyframe for r in t] == [r.is_keyframe for r in j]
    assert int(runs["port"].tracker.map.n_kfs) == \
        int(np.asarray(runs["ref"].tracker.map.n_kfs))


def test_vo_frame_step_like_the_reference(runs):
    """One VO frame step from the reference's own carry after the run, on
    a frame yawed 0.05 rad further: the records, the VO flags and the
    re-spawned temporal points."""
    from orb_slam_2_ros_tpu.pipeline import tracking as jtrack
    cfg = _cfg(localization_only=True)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    g1, d1 = render(make_room(0), *_yaw_pose(runs["yaws"][-1] + 0.05,
                                             runs["c0"]), cfg.camera)
    jt = jtrack.Tracker(cfg)
    jt.carry = runs["ref"].tracker.carry
    jt.process(g1, d1, 0.0)
    carry0 = runs["ref"].tracker.carry
    want = jt.carry
    tt = ttrack.Tracker(tcfg, device="cpu")
    tt.carry = convert.track_carry_from_numpy(
        jax.device_get(carry0._asdict()), "cpu")
    rec = tt.process(g1, d1, 0.0)
    wrec = jt.records[-1]
    assert rec.state == wrec.state == ttrack.OK
    assert abs(rec.n_inliers - wrec.n_inliers) <= 2
    got = convert.to_numpy(tt.carry)
    w = jax.device_get(want._asdict())
    agree = (got["last_vo"] == np.asarray(w["last_vo"])).mean()
    assert agree > 0.99 and got["last_vo"].sum() > 20
    ok = np.asarray(w["vo_ok"])
    assert (got["vo_ok"] == ok).mean() > 0.99
    both = ok & got["vo_ok"]
    np.testing.assert_allclose(got["vo_pos"][both],
                               np.asarray(w["vo_pos"])[both], atol=1e-2)
