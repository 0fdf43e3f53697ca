"""Port parity: geometry/se3 and geometry/camera against the JAX reference
on the same numpy inputs, atol 1e-5 (float32 transcendental functions
differ between the two libraries in the last bits). Pixel coordinates also
get rtol 2e-7, one float32 ulp: the ulp of a 1000 px coordinate is 6e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import CameraConfig, tum_fr1_config
from orb_slam_2_ros_tpu.geometry import camera as jcam
from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu_torch.geometry import camera as tcam
from orb_slam_2_ros_tpu_torch.geometry import se3 as tse3

ATOL = 1e-5


def _close(j, t, rtol=0.0):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=ATOL, rtol=rtol)


def _poses(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return q, t


@pytest.mark.parametrize("fn", ["quat_normalize", "quat_conj", "quat_to_matrix",
                                "quat_log", "camera_center_unit"])
def test_se3_unary(fn):
    rng = np.random.default_rng(0)
    q, t = _poses(rng, 64)
    q[:4] = [[1, 0, 0, 0], [-1, 0, 0, 0], [0.999999, 1e-4, 0, 0],
             [0, 0, 0, 1]]
    if fn == "camera_center_unit":
        _close(jse3.camera_center(jnp.asarray(q), jnp.asarray(t)),
               tse3.camera_center(torch.from_numpy(q), torch.from_numpy(t)))
        return
    _close(getattr(jse3, fn)(jnp.asarray(q)),
           getattr(tse3, fn)(torch.from_numpy(q)))


def test_se3_binary_and_group_ops():
    rng = np.random.default_rng(1)
    qa, ta = _poses(rng, 32)
    qb, tb = _poses(rng, 32)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    J = [jnp.asarray(v) for v in (qa, ta, qb, tb, x)]
    T = [torch.from_numpy(v) for v in (qa, ta, qb, tb, x)]
    _close(jse3.quat_mul(J[0], J[2]), tse3.quat_mul(T[0], T[2]))
    _close(jse3.quat_rotate(J[0], J[4]), tse3.quat_rotate(T[0], T[4]))
    _close(jse3.apply(J[0], J[1], J[4]), tse3.apply(T[0], T[1], T[4]))
    for jo, to in zip(jse3.compose(*J[:4]), tse3.compose(*T[:4])):
        _close(jo, to)
    for jo, to in zip(jse3.inverse(J[0], J[1]), tse3.inverse(T[0], T[1])):
        _close(jo, to)
    for jo, to in zip(jse3.relative(*J[:4]), tse3.relative(*T[:4])):
        _close(jo, to)
    _close(jse3.to_matrix(J[0], J[1]), tse3.to_matrix(T[0], T[1]))
    m = np.asarray(jse3.quat_to_matrix(J[0]))
    _close(jse3.quat_from_matrix(jnp.asarray(m)),
           tse3.quat_from_matrix(torch.from_numpy(m)))


def test_se3_exp_log():
    rng = np.random.default_rng(2)
    xi = rng.normal(scale=0.5, size=(64, 6)).astype(np.float32)
    xi[:3, 3:] = [[0, 0, 0], [1e-7, 0, 0], [0, 2e-6, -1e-6]]
    jq, jt = jse3.exp(jnp.asarray(xi))
    tq, tt = tse3.exp(torch.from_numpy(xi))
    _close(jq, tq)
    _close(jt, tt)
    _close(jse3.log(jq, jt), tse3.log(tq, tt))
    _close(jse3.quat_exp(jnp.asarray(xi[:, 3:])),
           tse3.quat_exp(torch.from_numpy(xi[:, 3:])))


@pytest.mark.parametrize("distorted", [False, True])
def test_camera(distorted):
    cam = tum_fr1_config().camera if distorted else CameraConfig()
    rng = np.random.default_rng(3)
    uv = rng.uniform([0, 0], [cam.width, cam.height], (128, 2)).astype(np.float32)
    xc = np.concatenate([rng.uniform(-2, 2, (128, 2)),
                         rng.uniform(0.3, 6, (128, 1))], -1).astype(np.float32)
    depth = np.where(rng.uniform(size=128) < 0.2, -1.0,
                     rng.uniform(0.3, 6, 128)).astype(np.float32)
    J = jnp.asarray
    T = torch.from_numpy
    px = 2e-7
    _close(jcam.undistort_pixels(cam, J(uv)), tcam.undistort_pixels(cam, T(uv)),
           rtol=px)
    _close(jcam.project(cam, J(xc)), tcam.project(cam, T(xc)), rtol=px)
    _close(jcam.project_stereo(cam, J(xc)), tcam.project_stereo(cam, T(xc)),
           rtol=px)
    _close(jcam.backproject(cam, J(uv), J(depth)),
           tcam.backproject(cam, T(uv), T(depth)))
    _close(jcam.right_coord_from_depth(cam, J(uv[:, 0]), J(depth)),
           tcam.right_coord_from_depth(cam, T(uv[:, 0]), T(depth)), rtol=px)
    np.testing.assert_array_equal(
        np.asarray(jcam.in_image(cam, J(uv * 1.3 - 50), border=2.0)),
        tcam.in_image(cam, T(uv * 1.3 - 50), border=2.0).numpy())
