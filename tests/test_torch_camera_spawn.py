"""The port's last helpers against the reference's on the same inputs:
``geometry/camera.py::distort_normalized`` and ``depth_from_disparity``
(``tests/test_camera.py``'s round trip and disparity cases, on the TUM fr1
camera with its distortion), and ``map/state.py::spawn_points`` on a small
map (the spawned masks, ids and counters equal, positions and normals
within 1e-5, the scale bands within 1e-6 relative).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import tum_fr1_config
from orb_slam_2_ros_tpu.geometry import camera as jcam
from orb_slam_2_ros_tpu.map import state as jstate
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.geometry import camera as tcam
from orb_slam_2_ros_tpu_torch.map import state as tstate

torch.set_num_threads(2)


def _cams():
    cfg = tum_fr1_config()
    return cfg.camera, convert.config_from_dict(
        dataclasses.asdict(cfg)).camera


def test_distort_undistort_roundtrip_matches_reference():
    jc, tc = _cams()
    rng = np.random.default_rng(1)
    xy = np.stack([rng.uniform(-0.4, 0.4, 300), rng.uniform(-0.3, 0.3, 300)],
                  -1).astype(np.float32)
    got = tcam.distort_normalized(tc, torch.from_numpy(xy))
    want = jcam.distort_normalized(jc, jnp.asarray(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    back = tcam.undistort_normalized(tc, got, iters=20)
    np.testing.assert_allclose(back.numpy(), xy, atol=1e-5)


def test_depth_from_disparity_matches_reference():
    jc, tc = _cams()
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-2, 2, 128), rng.uniform(-2, 2, 128),
                    rng.uniform(0.5, 5, 128)], -1).astype(np.float32)
    uvr = tcam.project_stereo(tc, torch.from_numpy(pts))
    # a few non-positive disparities
    ur = uvr[:, 2].clone()
    ur[:8] = uvr[:8, 0] + torch.arange(8, dtype=torch.float32)
    z = tcam.depth_from_disparity(tc, uvr[:, 0], ur)
    want = jcam.depth_from_disparity(jc, jnp.asarray(uvr[:, 0].numpy()),
                                     jnp.asarray(ur.numpy()))
    np.testing.assert_allclose(z.numpy(), np.asarray(want), rtol=1e-6)
    assert (z[:8] == -1.0).all()
    np.testing.assert_allclose(z[8:].numpy(), pts[8:, 2], rtol=1e-4)


def _small_map(cfg, rng):
    """Keyframe 1 of a small map: 256 keypoints, some already associated,
    some without depth, 40 points in the pool."""
    m = jax.device_get(jstate.empty(cfg)._asdict())
    m = {k: np.array(v) for k, v in m.items()}
    K, P = m["kf_uv"].shape[:2]
    k = 1
    m["kf_valid"][:2] = True
    m["kf_q"][k] = np.array([0.99, 0.05, -0.1, 0.02], np.float32) / np.linalg.norm(
        [0.99, 0.05, -0.1, 0.02])
    m["kf_t"][k] = np.array([0.3, -0.1, 0.2], np.float32)
    m["kf_uv"][k] = np.stack([rng.uniform(0, 640, P), rng.uniform(0, 480, P)],
                             -1)
    depth = rng.uniform(0.3, 8.0, P).astype(np.float32)
    depth[rng.uniform(size=P) < 0.15] = -1.0
    depth[5] = depth[6]                  # a tie in the depth order
    m["kf_depth"][k] = depth
    m["kf_octave"][k] = rng.integers(0, 8, P)
    m["kf_desc"][k] = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32)
    m["kf_kp_valid"][k] = rng.uniform(size=P) < 0.9
    assoc = rng.uniform(size=P) < 0.2
    m["kf_mp"][k] = np.where(assoc, rng.integers(0, 40, P), -1)
    m["mp_valid"][:40] = True
    m["n_mps"] = np.int32(40)
    m["n_kfs"] = np.int32(2)
    return m


@pytest.mark.parametrize("close_only,max_spawn", [(True, 512), (False, 64),
                                                  (False, 512)])
def test_spawn_points_matches_reference(close_only, max_spawn):
    from test_loop_closing import small_cfg
    cfg = small_cfg()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    m = _small_map(cfg, np.random.default_rng(3))
    want = jax.device_get(jstate.spawn_points(
        jstate.MapState(**{k: jnp.asarray(v) for k, v in m.items()}), 1,
        cfg, close_only=close_only, max_spawn=max_spawn)._asdict())
    got = convert.to_numpy(tstate.spawn_points(
        convert.map_state_from_numpy(m, "cpu"), 1, tcfg,
        close_only=close_only, max_spawn=max_spawn))
    n_new = int(want["n_mps"]) - 40
    assert n_new > 0
    if max_spawn == 64:
        assert n_new == 64
    for f in ("mp_valid", "kf_mp", "n_mps", "mp_first_kf", "mp_obs_cnt",
              "mp_visible", "mp_found", "mp_obs_tbl", "mp_desc"):
        np.testing.assert_array_equal(got[f], np.asarray(want[f]),
                                      err_msg=f)
    for f in ("mp_pos", "mp_normal", "mp_dir_sum"):
        np.testing.assert_allclose(got[f], np.asarray(want[f]), atol=1e-5,
                                   rtol=0, err_msg=f)
    for f in ("mp_min_dist", "mp_max_dist"):
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=1e-6,
                                   err_msg=f)
