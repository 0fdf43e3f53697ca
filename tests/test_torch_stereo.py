"""Port parity of the stereo sensor: ``frontend/stereo.py``,
``frontend/frame.py::build_stereo``, and ``Tracker`` and ``System`` with
``SENSOR_STEREO``, on ``stereo_cfg()`` of ``tests/test_stereo_tracking.py``
(320x240, 500 features, 3 levels) and its synthetic stereo orbit.

Tolerances:
- ``compute_stereo_matches`` on identical keypoints and pyramids (the
  reference's, carried across): the matched set is the same on >= 99% of
  the keypoints, and u_right and depth agree within 1e-3 on >= 99% of them;
- ``build_stereo`` from the images, by overlap (the two extractors may rank
  a handful of keypoints differently): >= 95% of the reference's keypoints
  found at the same pixel, and on those the matched set the same and the
  depth within 1e-3 on >= 95%;
- ``Tracker`` over 16 pairs: the same per-frame states, every frame OK, the
  ATE within 5e-3 m of the reference's; the right image crosses as u8;
- ``System(enable_loop_closing=False)`` over 24 pairs: the same per-frame
  states and keyframe count as the reference's, camera centres within
  5e-3 m.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam_2_ros_tpu.frontend import extractor as jextractor
from orb_slam_2_ros_tpu.frontend import frame as jframe
from orb_slam_2_ros_tpu.frontend import stereo as jstereo
from orb_slam_2_ros_tpu.io import trajectory as jtraj
from orb_slam_2_ros_tpu.io.synthetic import SyntheticStereo
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.pipeline import tracking as jtrack
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.frontend import frame as tframe
from orb_slam_2_ros_tpu_torch.frontend import stereo as tstereo
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_stereo_tracking import stereo_cfg

torch.set_num_threads(2)

N_TRACK = 16
N_SYSTEM = 24


@pytest.fixture(scope="module")
def seq():
    cfg = stereo_cfg()
    ds = SyntheticStereo(cfg, n_frames=N_SYSTEM, seed=0)
    lefts = np.stack([ds[i][0] for i in range(N_SYSTEM)])
    rights = np.stack([ds[i][1] for i in range(N_SYSTEM)])
    return dict(cfg=cfg, tcfg=convert.config_from_dict(dataclasses.asdict(cfg)),
                ds=ds, lefts=lefts, rights=rights, ts=list(ds.timestamps))


def _kps(k):
    return Keypoints(**{f: convert.to_tensor(np.asarray(v), "cpu")
                        for f, v in k._asdict().items()})


@pytest.mark.parametrize("i", [0, 7])
def test_stereo_matches_on_identical_keypoints(seq, i):
    cfg = seq["cfg"]
    jl, pl = jextractor.extract_with_pyramid(jnp.asarray(seq["lefts"][i]),
                                             cfg.orb)
    jr, pr = jextractor.extract_with_pyramid(jnp.asarray(seq["rights"][i]),
                                             cfg.orb)
    jur, jd = jstereo.compute_stereo_matches(
        jl, jr, jstereo.flatten_pyramid(pl), jstereo.flatten_pyramid(pr), cfg)
    jur, jd = np.asarray(jur), np.asarray(jd)
    tur, td = tstereo.compute_stereo_matches(
        _kps(jl), _kps(jr),
        tstereo.flatten_pyramid([torch.from_numpy(np.array(x)) for x in pl]),
        tstereo.flatten_pyramid([torch.from_numpy(np.array(x)) for x in pr]),
        seq["tcfg"])
    tur, td = tur.numpy(), td.numpy()
    valid = np.asarray(jl.valid)
    assert (jur[valid] > 0).sum() > 150
    assert ((tur > 0) == (jur > 0))[valid].mean() >= 0.99
    assert (np.abs(tur - jur) <= 1e-3)[valid].mean() >= 0.99
    assert (np.abs(td - jd) <= 1e-3)[valid].mean() >= 0.99
    assert ((tur > 0) == (td > 0)).all()


def test_flat_pyramid_gathers_clamp_to_the_border():
    lv = [torch.arange(20.0).reshape(4, 5), torch.arange(6.0).reshape(2, 3)]
    pyr = tstereo.flatten_pyramid(lv)
    assert pyr.data.shape == (26,) and pyr.offset.tolist() == [0, 20]
    got = tstereo._gather_patches(
        pyr, torch.tensor([0, 1]), torch.tensor([0, 2]), torch.tensor([3, 1]),
        torch.tensor([-1, 0, 1]), torch.tensor([0, 0, 1]))
    assert got.tolist() == [[15.0, 15.0, 16.0], [4.0, 5.0, 5.0]]


def test_build_stereo_by_overlap(seq):
    cfg = seq["cfg"]
    i = 3
    jf = jframe.build_stereo(jnp.asarray(seq["lefts"][i]),
                             jnp.asarray(seq["rights"][i]), cfg)
    tf = tframe.build_stereo(torch.from_numpy(seq["lefts"][i]),
                             torch.from_numpy(seq["rights"][i]), seq["tcfg"])
    jxy = np.asarray(jf.kps.xy)[np.asarray(jf.valid)]
    jd = np.asarray(jf.depth)[np.asarray(jf.valid)]
    txy = tf.kps.xy.numpy()
    tv = tf.valid.numpy()
    index = {tuple(p): k for k, p in enumerate(txy[tv])}
    tds = tf.depth.numpy()[tv]
    pairs = [(a, index[tuple(p)]) for a, p in enumerate(jxy)
             if tuple(p) in index]
    assert len(pairs) >= 0.95 * len(jxy)
    a, b = np.array(pairs).T
    assert ((jd[a] > 0) == (tds[b] > 0)).mean() >= 0.95
    assert (np.abs(jd[a] - tds[b]) <= 1e-3).mean() >= 0.95
    assert tf.u_right.shape == (cfg.orb.max_kps,)


def test_stereo_wire_format_keeps_the_right_image(seq):
    tr = ttrack.Tracker(seq["tcfg"], device="cpu")
    g, r = tr.to_wire(seq["lefts"][:2], seq["rights"][:2])
    assert g.dtype == r.dtype == np.uint8
    np.testing.assert_array_equal(
        r, np.clip(np.round(seq["rights"][:2]), 0, 255).astype(np.uint8))
    jt = jtrack.Tracker(seq["cfg"])
    _, jr = jt.to_wire(seq["lefts"][:2], seq["rights"][:2])
    np.testing.assert_array_equal(r, jr)


def test_stereo_tracker_matches_reference(seq):
    n = N_TRACK
    ds = seq["ds"]
    jt = jtrack.Tracker(seq["cfg"])
    jrecs = jt.process_chunk(seq["lefts"][:n], seq["rights"][:n],
                             seq["ts"][:n])
    tt = ttrack.Tracker(seq["tcfg"], device="cpu")
    trecs = tt.process_chunk(seq["lefts"][:n], seq["rights"][:n],
                             seq["ts"][:n])
    assert [r.state for r in trecs] == [r.state for r in jrecs]
    assert all(r.state == ttrack.OK for r in trecs)
    gt = np.stack([ds.gt_pose_wc(i)[1] for i in range(n)])
    jate = jtraj.ate_rmse(np.stack([r.c_w for r in jrecs]), gt)
    tate = jtraj.ate_rmse(np.stack([r.c_w for r in trecs]), gt)
    assert abs(tate - jate) <= 5e-3, (tate, jate)
    assert tate < 0.05
    assert int(tt.map.n_mps) > 200


def test_stereo_system_matches_reference(seq):
    n = N_SYSTEM
    js = jslam.System(seq["cfg"], ba_window=8, enable_loop_closing=False)
    jrecs = js.track_chunk(seq["lefts"], seq["rights"], seq["ts"])
    ts = tslam.System(seq["tcfg"], ba_window=8, enable_loop_closing=False,
                      device="cpu")
    trecs = ts.track_chunk(seq["lefts"], seq["rights"], seq["ts"])
    assert ts.loop_closer is None and ts.relocalizer is None
    assert [r.state for r in trecs] == [r.state for r in jrecs]
    assert all(r.state == ttrack.OK for r in trecs)
    assert ts.tracker.n_kfs == js.tracker.n_kfs >= 2
    assert ts.mapper.n_executed >= 1
    np.testing.assert_allclose(np.stack([r.c_w for r in trecs]),
                               np.stack([r.c_w for r in jrecs]), atol=5e-3)
    assert len(ts.records) == n
