"""Port parity: the clamped small SPD solve and ``geometry/triangulate.py``
against the JAX reference on the same numpy inputs.

Tolerances: the solve and the triangulated points within 1e-4 relative
(both sides run the same unrolled f32 operations; sums inside ``einsum`` and
``matmul`` may differ in their last bits), degenerate members finite on
both sides; ``projection_matrix``, ``parallax_cos`` and ``depth_in_camera``
within 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu.geometry import triangulate as jtri
from orb_slam_2_ros_tpu.ops.linalg import solve_spd_unrolled
from orb_slam_2_ros_tpu_torch.geometry import triangulate as ttri
from orb_slam_2_ros_tpu_torch.ops.linalg import solve_spd_clamped

K_INT = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]], np.float32)


def _two_views(seed, n=64):
    """n world points seen by two cameras; the last two pairs are
    degenerate: identical cameras (parallel rays), and a point at the
    first camera's centre line seen from a pure forward motion."""
    rng = np.random.default_rng(seed)
    q1 = np.array(jse3.quat_exp(jnp.asarray(rng.normal(0, 0.05, 3),
                                              jnp.float32)))
    t1 = rng.normal(0, 0.1, 3).astype(np.float32)
    q2 = np.array(jse3.quat_exp(jnp.asarray(rng.normal(0, 0.05, 3),
                                              jnp.float32)))
    t2 = (t1 + np.array([0.3, 0.02, -0.01])).astype(np.float32)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], -1).astype(np.float32)
    P1 = np.asarray(jtri.projection_matrix(jnp.asarray(K_INT),
                                           jnp.asarray(q1), jnp.asarray(t1)))
    P2 = np.asarray(jtri.projection_matrix(jnp.asarray(K_INT),
                                           jnp.asarray(q2), jnp.asarray(t2)))

    def proj(Pm, x):
        h = x @ Pm[:, :3].T + Pm[:, 3]
        return (h[:, :2] / h[:, 2:]).astype(np.float32)

    xy1 = proj(P1, pts) + rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    xy2 = proj(P2, pts) + rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    P1b = np.broadcast_to(P1, (n, 3, 4)).copy()
    P2b = np.broadcast_to(P2, (n, 3, 4)).copy()
    P2b[-1] = P1b[-1]               # the same camera twice,
    xy2[-1] = xy1[-1]               # the same pixel: parallel rays
    P2b[-2] = P1b[-2]
    P2b[-2, 2, 3] -= 0.5            # pure forward motion,
    xy1[-2] = xy2[-2] = (319.5, 239.5)      # point on the axis
    return (q1, t1, q2, t2, pts), (P1b, P2b, xy1, xy2)


@pytest.mark.parametrize("n", [3, 4])
def test_solve_spd_clamped(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(32, n, n)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    H[-1] = 0.0                     # singular members stay finite
    H[-2] = -np.eye(n, dtype=np.float32)
    b = rng.normal(size=(32, n)).astype(np.float32)
    want = np.asarray(solve_spd_unrolled(jnp.asarray(H), jnp.asarray(b)))
    got = solve_spd_clamped(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # and it solves the regular members
    res = np.einsum("bij,bj->bi", H[:-2], got[:-2]) - b[:-2]
    assert np.abs(res).max() < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_dlt(seed):
    (_, _, _, _, pts), args = _two_views(seed)
    want = np.asarray(jtri.triangulate_dlt(*(jnp.asarray(a) for a in args)))
    got = ttri.triangulate_dlt(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got[:-2], want[:-2], rtol=1e-4, atol=1e-5)
    # regular members land on the true points (0.05 px of noise)
    assert np.median(np.linalg.norm(got[:-2] - pts[:-2], axis=-1)) < 0.05


def test_projection_parallax_depth():
    (q1, t1, q2, t2, pts), _ = _two_views(5)
    J, T = jnp.asarray, torch.from_numpy
    np.testing.assert_allclose(
        ttri.projection_matrix(T(K_INT), T(q1), T(t1)).numpy(),
        np.asarray(jtri.projection_matrix(J(K_INT), J(q1), J(t1))), atol=1e-4)
    # batched poses broadcast against one K
    qb, tb = np.stack([q1, q2]), np.stack([t1, t2])
    np.testing.assert_allclose(
        ttri.projection_matrix(T(K_INT), T(qb), T(tb)).numpy(),
        np.asarray(jtri.projection_matrix(J(K_INT), J(qb), J(tb))), atol=1e-4)
    c1 = np.array(jse3.camera_center(J(q1), J(t1)))
    c2 = np.array(jse3.camera_center(J(q2), J(t2)))
    np.testing.assert_allclose(
        ttri.parallax_cos(T(pts), T(c1), T(c2)).numpy(),
        np.asarray(jtri.parallax_cos(J(pts), J(c1), J(c2))), atol=1e-5)
    np.testing.assert_allclose(
        ttri.depth_in_camera(T(q2), T(t2), T(pts)).numpy(),
        np.asarray(jtri.depth_in_camera(J(q2), J(t2), J(pts))), atol=1e-5)
