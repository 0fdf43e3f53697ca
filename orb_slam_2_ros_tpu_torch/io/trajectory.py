"""Trajectory export and evaluation: TUM and KITTI files, the absolute
trajectory error after Umeyama alignment (what evo and the TUM benchmark
scripts compute), the relative pose error and the KITTI devkit's relative
error.

The port's own copy of the reference's ``orb_slam_2_ros_tpu/io/trajectory.py``
(host numpy, float64). TUM lines are ``timestamp tx ty tz qx qy qz qw`` of
the camera-to-world pose; KITTI lines are the row-major 3x4 camera-to-world
matrix. Given the same poses the files are byte for byte the reference's;
``tests/test_torch_io_trajectory.py`` holds the two together.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw) (TUM order)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        # fall back to largest diagonal construction
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, R[i, i] - R[j, j] - R[k, k] + 1.0)) * 0.5
        xyz = [0.0, 0.0, 0.0]
        xyz[i] = s
        xyz[j] = (R[j, i] + R[i, j]) / (4 * s)
        xyz[k] = (R[k, i] + R[i, k]) / (4 * s)
        w = (R[k, j] - R[j, k]) / (4 * s)
        x, y, z = xyz
    return np.array([x, y, z, w])


def write_tum(path: str, timestamps: Sequence[float],
              poses_wc: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
    """poses_wc: list of (R_wc, c_w) camera-to-world."""
    with open(path, "w") as f:
        for ts, (R, c) in zip(timestamps, poses_wc):
            q = _quat_from_R(np.asarray(R))
            f.write(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def write_kitti(path: str, poses_wc: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
    with open(path, "w") as f:
        for R, c in poses_wc:
            T = np.hstack([np.asarray(R), np.asarray(c).reshape(3, 1)])
            f.write(" ".join(f"{v:.6e}" for v in T.ravel()) + "\n")


def read_tum(path: str):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    ts = data[:, 0]
    poses = []
    for row in data:
        x, y, z, qx, qy, qz, qw = row[1:8]
        R = _R_from_quat(qx, qy, qz, qw)
        poses.append((R, np.array([x, y, z])))
    return ts, poses


def _R_from_quat(x, y, z, w):
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity aligning est -> gt. est, gt: (N, 3).

    Returns (s, R, t) with gt ~= s * R @ est + t.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment (metres)."""
    s, R, t = umeyama_align(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = aligned - gt_positions
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est: List[Tuple[np.ndarray, np.ndarray]],
        gt: List[Tuple[np.ndarray, np.ndarray]], delta: int = 1):
    """Relative pose error over a frame delta: (trans RMSE, rot RMSE rad)."""
    terr, rerr = [], []
    for i in range(len(est) - delta):
        def rel(poses):
            R1, c1 = poses[i]
            R2, c2 = poses[i + delta]
            Rr = R1.T @ R2
            tr = R1.T @ (c2 - c1)
            return Rr, tr
        Re, te = rel(est)
        Rg, tg = rel(gt)
        Rd = Re.T @ Rg
        terr.append(np.linalg.norm(te - tg))
        ang = np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))
        rerr.append(ang)
    return float(np.sqrt(np.mean(np.square(terr)))), float(np.sqrt(np.mean(np.square(rerr))))


def kitti_relative_error(est: List[Tuple[np.ndarray, np.ndarray]],
                         gt: List[Tuple[np.ndarray, np.ndarray]],
                         lengths: Sequence[float] = (100, 200, 300, 400,
                                                     500, 600, 700, 800),
                         step: int = 10):
    """KITTI odometry devkit relative error: average translational drift
    (fraction, multiply by 100 for %) and rotational drift (rad/m; multiply
    by 100*180/pi for deg/100m) over all subsequences of the given lengths —
    the t_rel / r_rel metric the ORB-SLAM2 paper reports for KITTI 00
    (BASELINE.md). Poses are camera-to-world (R_wc, c_w) per frame.

    Returns (t_rel, r_rel, n_subsequences); NaNs if the trajectory is
    shorter than the smallest length.
    """
    c_gt = np.stack([c for _, c in gt])
    seg = np.linalg.norm(np.diff(c_gt, axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(seg)])

    def rel(poses, i, j):
        Ri, ci = poses[i]
        Rj, cj = poses[j]
        return Ri.T @ Rj, Ri.T @ (cj - ci)

    t_errs, r_errs = [], []
    for i in range(0, len(gt), step):
        for L in lengths:
            j = int(np.searchsorted(dist, dist[i] + L))
            if j >= len(gt):
                break
            Rg, tg = rel(gt, i, j)
            Re, te = rel(est, i, j)
            Rd = Re.T @ Rg
            ang = np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))
            t_errs.append(np.linalg.norm(te - tg) / L)
            r_errs.append(ang / L)
    if not t_errs:
        return float("nan"), float("nan"), 0
    return float(np.mean(t_errs)), float(np.mean(r_errs)), len(t_errs)
