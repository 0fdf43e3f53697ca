"""Stereo relocalization: the port's deliberate divergence from the
reference (``ROADMAP.md``, faults in the reference).

The reference's ``System._attempt_reloc`` builds the frame of a stereo
system's relocalization attempt as RGB-D with the right image as the depth
map (its ``slam.py:512-518``): the right image's intensities (0-255)
become depths in metres. The port builds it with ``build_stereo``.

Both systems (``stereo_cfg()`` of ``tests/test_stereo_tracking.py``, loop
closing on, a 6^3 vocabulary trained on random descriptors) map 32 pairs
of the synthetic stereo orbit, then take the forced loss of
``tests/test_hard_sequences.py``: one chunk of 16 whose first 8 pairs are
blind (zeros) and whose last 8 revisit pairs 8-15.

- The port relocalizes at the first visible pair: 8 LOST then 8 OK, 9
  attempts and 1 success, no reset, each frame recorded once, the
  relocalized centres within 0.08 m of the ground truth.
- The reference on the same input (found by running it): every
  relocalization frame it builds has ``depth`` equal to the right image;
  none of its 9 attempts succeeds, so the first visible pair stays LOST
  and its map, at or under ``min_num_kf_in_map`` keyframes, is reset.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from orb_slam_2_ros_tpu.config import VocabConfig
from orb_slam_2_ros_tpu.frontend import frame as jframe
from orb_slam_2_ros_tpu.io.synthetic import SyntheticStereo
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_stereo_tracking import stereo_cfg

torch.set_num_threads(2)

N_MAP, C, H = 32, 16, 8


@pytest.fixture(scope="module")
def loss():
    cfg = dataclasses.replace(stereo_cfg(), vocab=VocabConfig(k=6, levels=3))
    ds = SyntheticStereo(cfg, n_frames=N_MAP, seed=0)
    lefts = np.stack([ds[i][0] for i in range(N_MAP)])
    rights = np.stack([ds[i][1] for i in range(N_MAP)])
    rng = np.random.default_rng(0)
    voc = jvoc.train_vocabulary(
        rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32), cfg, seed=0)
    lost_l = np.concatenate([np.zeros_like(lefts[:H]), lefts[8:8 + C - H]])
    lost_r = np.concatenate([np.zeros_like(rights[:H]),
                             rights[8:8 + C - H]])
    ts2 = [ds.timestamps[-1] + (i + 1) / 30.0 for i in range(C)]
    return dict(cfg=cfg, ds=ds, lefts=lefts, rights=rights, voc=voc,
                lost=(lost_l, lost_r, ts2))


def test_port_relocalizes_a_stereo_system(loss):
    ds = loss["ds"]
    tcfg = convert.config_from_dict(dataclasses.asdict(loss["cfg"]))
    tvoc = convert.vocabulary_from_numpy(
        jax.device_get(loss["voc"]._asdict()), "cpu")
    system = tslam.System(tcfg, ba_window=8, vocab=tvoc, device="cpu")
    system.track_chunk(loss["lefts"], loss["rights"], list(ds.timestamps))
    system.flush()
    recs = system.track_chunk(*loss["lost"])
    states = [r.state for r in recs]
    assert states == [ttrack.LOST] * H + [ttrack.OK] * (C - H), states
    assert system.n_reloc_attempts == H + 1 and system.n_relocalized == 1
    assert system.n_resets == 0
    assert [r.frame_id for r in system.records] == list(range(N_MAP + C))
    R0, c0 = ds.gt_pose_wc(0)
    for i, r in enumerate(recs[H:]):
        gt = R0.T @ (ds.gt_pose_wc(8 + i)[1] - c0)
        assert np.linalg.norm(r.c_w - gt) < 0.08, i


def test_reference_relocalizes_on_the_right_image_as_depth(loss,
                                                           monkeypatch):
    built = []
    build_rgbd = jframe.build_rgbd

    def recorded(gray, depth, cfg):
        built.append(np.asarray(depth))
        return build_rgbd(gray, depth, cfg)

    monkeypatch.setattr(jframe, "build_rgbd", recorded)
    system = jslam.System(loss["cfg"], ba_window=8, vocab=loss["voc"])
    system.track_chunk(loss["lefts"], loss["rights"],
                       list(loss["ds"].timestamps))
    system.flush()
    recs = system.track_chunk(*loss["lost"])
    lost_r = loss["lost"][1]
    # the chunk's attempts: the 8 blind pairs and the first visible one,
    # each built with the right image as its depth map
    assert len(built) >= H + 1
    for i in range(H + 1):
        np.testing.assert_array_equal(built[i], lost_r[i].astype(np.float32))
    assert recs[H].state != ttrack.OK
    assert system.n_resets == 1
