"""The references for the poses the tracker returns and for the map's
points: the harness's own ground truth.

The scene is known exactly (``scene/``): every frame's camera-to-world pose
and the room, a box of half-side ``HALF`` metres centred at the origin. So
a tracked pose is judged by its motion from the previous frame against the
true motion (the relative pose error), which no drift of the map enters,
a map point by its distance along its first keyframe's ray against the
true distance from that keyframe's camera to the wall the ray meets, and a
keypoint's right-image coordinate by the one the wall's true depth along
its ray gives.

The control is the reference put in the program's place in the precision
below the float32 that the port's records and map carry: the true poses,
the true points in their keyframe's camera frame, and the true right-image
coordinates, rounded to bfloat16.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

HALF = 3.0


def to_bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)


def relative_errors(est: Sequence[Tuple[np.ndarray, np.ndarray]],
                    gt: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """Per consecutive pair (i, i + 1) of camera-to-world poses (R_wc, c_w):
    the translation error in metres and the rotation error in radians of the
    estimated motion T_wc(i)^-1 T_wc(i+1) against the true one."""
    t_err, r_err = [], []
    for (Ra, ca), (Rb, cb), (Ga, ga), (Gb, gb) in zip(est, est[1:], gt, gt[1:]):
        Ra, Rb, Ga, Gb = (np.asarray(x, np.float64) for x in (Ra, Rb, Ga, Gb))
        dR_est = Ra.T @ Rb
        dt_est = Ra.T @ (np.asarray(cb, np.float64) - np.asarray(ca, np.float64))
        dR_gt = Ga.T @ Gb
        dt_gt = Ga.T @ (np.asarray(gb, np.float64) - np.asarray(ga, np.float64))
        t_err.append(float(np.linalg.norm(dt_est - dt_gt)))
        r_err.append(rotation_angle(nearest_rotation(dR_gt.T @ dR_est)))
    return t_err, r_err


def nearest_rotation(M: np.ndarray) -> np.ndarray:
    """The rotation closest to ``M`` in the Frobenius norm."""
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def rotation_angle(R: np.ndarray) -> float:
    """The angle of a rotation, accurate near zero."""
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(w) / 2.0,
                            (np.trace(R) - 1.0) / 2.0))


def aligned_errors(est, gt) -> List[float]:
    """Position errors of the estimated camera centres after the rigid
    motion that best aligns them to the true ones (Kabsch)."""
    P = np.array([np.asarray(c, np.float64) for _, c in est])
    Q = np.array([np.asarray(c, np.float64) for _, c in gt])
    if len(P) < 3:
        return []
    mp, mq = P.mean(0), Q.mean(0)
    U, _, Vt = np.linalg.svd((Q - mq).T @ (P - mp))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    return list(np.linalg.norm((P - mp) @ R.T + mq - Q, axis=1))


def rms(x: List[float]) -> float:
    return float(np.sqrt(np.mean(np.square(x)))) if len(x) else float("nan")


def wall_distance(c_w: np.ndarray, dirs_w: np.ndarray) -> np.ndarray:
    """Distance from ``c_w`` (inside the room) along unit rays ``dirs_w``
    (n, 3) to the first wall."""
    c = np.asarray(c_w, np.float64)[None, :]
    d = np.asarray(dirs_w, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d > 0, (HALF - c) / d, np.where(d < 0, (-HALF - c) / d,
                                                    np.inf))
    return t.min(axis=1)


def point_ray_errors(points_cam: np.ndarray, R_wc_gt: np.ndarray,
                     c_gt: np.ndarray) -> np.ndarray:
    """Points given in a keyframe's camera frame: each one's distance from
    the camera less the true distance to the wall along the same ray from
    the keyframe's true pose, in metres."""
    p = np.asarray(points_cam, np.float64)
    r = np.linalg.norm(p, axis=1)
    dirs_w = (p / r[:, None]) @ np.asarray(R_wc_gt, np.float64).T
    return r - wall_distance(c_gt, dirs_w)


def control_points_cam(points_cam: np.ndarray, R_wc_gt: np.ndarray,
                       c_gt: np.ndarray) -> np.ndarray:
    """The control's points: the true wall point on each ray, in the
    keyframe's camera frame (where a point is made from its depth) rounded
    to bfloat16."""
    p = np.asarray(points_cam, np.float64)
    r = np.linalg.norm(p, axis=1)
    dirs_w = (p / r[:, None]) @ np.asarray(R_wc_gt, np.float64).T
    t = wall_distance(c_gt, dirs_w)
    return to_bf16(p / r[:, None] * t[:, None])


def true_u_right(uv: np.ndarray, R_wc: np.ndarray, c_w: np.ndarray,
                 cam: dict) -> np.ndarray:
    """The right-image coordinate of each left keypoint (n, 2) of a
    rectified pair, ``u - bf / z``, with ``z`` the depth of the wall that
    the keypoint's ray from the true pose meets; ``cam`` has fx, fy, cx,
    cy, bf."""
    uv = np.asarray(uv, np.float64)
    dirs_c = np.stack([(uv[:, 0] - cam["cx"]) / cam["fx"],
                       (uv[:, 1] - cam["cy"]) / cam["fy"],
                       np.ones(len(uv))], axis=1)
    n = np.linalg.norm(dirs_c, axis=1)
    dirs_w = (dirs_c / n[:, None]) @ np.asarray(R_wc, np.float64).T
    z = wall_distance(c_w, dirs_w) / n
    return uv[:, 0] - cam["bf"] / z
