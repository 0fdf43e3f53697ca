"""The port's trajectory files and metrics (``io/trajectory.py``) against the
reference's, on the same numpy poses.

Tolerances: the TUM and KITTI files are equal byte for byte; ``read_tum``'s
poses equal; ``rpe`` and ``kitti_relative_error`` within 1e-12 (both are
float64 numpy over the same operations). The four cases of
``tests/test_kitti_metric.py`` run on the port with that file's own bounds.
"""

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu.io import trajectory as jtraj
from orb_slam_2_ros_tpu_torch.io import trajectory as ttraj
from orb_slam_2_ros_tpu_torch.geometry.rectify import rodrigues

torch.set_num_threads(2)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        # include near-180-degree rotations: _quat_from_R's second branch
        r = rng.normal(0, 1, 3)
        if i % 5 == 0:
            r = r / np.linalg.norm(r) * (np.pi - 1e-7)
        out.append((rodrigues(r), rng.normal(0, 3, 3)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_files_equal_byte_for_byte(tmp_path, seed):
    poses = _poses(40, seed)
    ts = list(np.cumsum(np.random.default_rng(seed).uniform(0.01, 0.1, 40)))
    for name, write in (("tum", lambda m, p: m.write_tum(p, ts, poses)),
                        ("kitti", lambda m, p: m.write_kitti(p, poses))):
        a, b = tmp_path / f"ref_{name}.txt", tmp_path / f"port_{name}.txt"
        write(jtraj, str(a))
        write(ttraj, str(b))
        assert a.read_bytes() == b.read_bytes(), name
    ts_j, poses_j = jtraj.read_tum(str(tmp_path / "ref_tum.txt"))
    ts_t, poses_t = ttraj.read_tum(str(tmp_path / "ref_tum.txt"))
    np.testing.assert_array_equal(ts_j, ts_t)
    for (Rj, cj), (Rt, ct) in zip(poses_j, poses_t):
        np.testing.assert_array_equal(Rj, Rt)
        np.testing.assert_array_equal(cj, ct)
    # the file keeps the poses to its printed precision
    for (R, c), (Rt, ct) in zip(poses, poses_t):
        np.testing.assert_allclose(Rt, R, atol=1e-6)
        np.testing.assert_allclose(ct, c, atol=1e-6)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_reference(delta):
    gt = _poses(30, 2)
    est = [(R @ rodrigues(np.array([1e-3, 0, 2e-3]) * i), c + 0.01 * i)
           for i, (R, c) in enumerate(gt)]
    want = jtraj.rpe(est, gt, delta)
    got = ttraj.rpe(est, gt, delta)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_kitti_relative_error_matches_reference():
    rng = np.random.default_rng(3)
    gt = [(rodrigues(np.array([0, 0.002 * i, 0])),
           np.array([0.1 * np.sin(0.01 * i), 0.0, 2.0 * i]))
          for i in range(500)]
    est = [(R @ rodrigues(rng.normal(0, 1e-3, 3)), 1.01 * c
            + rng.normal(0, 0.05, 3)) for R, c in gt]
    want = jtraj.kitti_relative_error(est, gt)
    got = ttraj.kitti_relative_error(est, gt)
    assert got[2] == want[2] > 0
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-12)


def _straight_line(n, step=2.0):
    """GT: identity orientation, +z at ``step`` m/frame."""
    return [(np.eye(3), np.array([0.0, 0.0, step * i])) for i in range(n)]


def _rotation_drift(gt, omega):
    est = []
    for R, c in gt:
        th = omega * c[2]
        cy, sy = np.cos(th), np.sin(th)
        est.append((np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]), c))
    return est


@pytest.mark.parametrize("case", ["scale", "rotation", "perfect", "short"])
def test_kitti_metric_cases_on_the_port(case):
    """``tests/test_kitti_metric.py``'s four cases, with its bounds."""
    if case == "short":
        gt = _straight_line(10)   # 18 m < 100 m
        t_rel, r_rel, n = ttraj.kitti_relative_error(gt, gt)
        assert n == 0 and np.isnan(t_rel)
        return
    gt = _straight_line(600)
    if case == "scale":
        t_rel, r_rel, n = ttraj.kitti_relative_error(
            [(R, 1.02 * c) for R, c in gt], gt)
        assert n > 0 and abs(t_rel - 0.02) < 1e-6 and r_rel < 1e-9
    elif case == "rotation":
        t_rel, r_rel, n = ttraj.kitti_relative_error(
            _rotation_drift(gt, 1e-4), gt)
        assert n > 0 and abs(r_rel - 1e-4) < 1e-8
        assert abs(r_rel * 100 * 180 / np.pi - 0.573) < 1e-3
    else:
        t_rel, r_rel, n = ttraj.kitti_relative_error(gt, gt)
        assert n > 0 and t_rel == 0.0 and r_rel == 0.0
