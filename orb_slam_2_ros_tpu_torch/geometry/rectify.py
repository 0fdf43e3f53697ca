"""Stereo rectification for unrectified rigs (EuRoC MAV).

The reference's EuRoC path pre-rectifies both cameras with
``cv::stereoRectify`` + ``cv::initUndistortRectifyMap`` from the dataset's
``sensor.yaml`` before frames reach the tracker (ORB-SLAM2's
``stereo_euroc`` example; the row-band stereo matcher,
``Frame::ComputeStereoMatches``, ``Frame.cc:502-676``, and the port's
``frontend/stereo.py`` assume rectified, distortion-free pairs). Bouguet's
algorithm splits the inter-camera rotation evenly between the views, aligns
the new x-axis with the baseline, and builds per-camera remap tables through
the Brown-Conrady (radtan) model.

The port's own copy of ``orb_slam_2_ros_tpu/geometry/rectify.py``: host
numpy, a one-time set-up and a per-frame bilinear remap in the dataset
loader, off the device path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix."""
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def log_so3(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector."""
    cos_th = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = float(np.arccos(cos_th))
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def distort_radtan(xn: np.ndarray, D) -> np.ndarray:
    """Apply Brown-Conrady (k1, k2, p1, p2[, k3]) to normalized points
    (..., 2) — the model of ``cv::projectPoints`` and the reference's
    undistortion source (``Frame.cc:438-469``)."""
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def stereo_rectify(K0, D0, K1, D1, R, t, size: Tuple[int, int]):
    """Bouguet rectification. R, t: cam0 -> cam1 (x1 = R x0 + t).

    Returns (R_rect0, R_rect1, K_new (3,3), baseline): rotations applied to
    each camera's COORDINATES (x_rect = R_rect x_cam), a shared rectified
    pinhole K, and the metric baseline. The rectified convention matches
    the engine's: the right camera sits at +x of the left, so
    uR = uL - fx*b/z (``Frame.cc:504`` mvuRight).
    """
    W, H = size
    om = log_so3(np.asarray(R, np.float64))
    A = rodrigues(om / 2)        # applied to cam0 coords
    B = rodrigues(-om / 2)       # applied to cam1 coords
    t2 = B @ np.asarray(t, np.float64)
    b = float(np.linalg.norm(t2))
    # new x-axis along -t2 so the translation becomes (-b, 0, 0):
    # the right camera center lands at +x of the left (engine convention)
    e1 = -t2 / b
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:                # degenerate: baseline along z
        e2 = np.array([1.0, 0.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3], axis=0)
    R_rect0 = Rw @ A
    R_rect1 = Rw @ B
    f = (K0[0, 0] + K0[1, 1]) / 2.0
    K_new = np.array([[f, 0, (W - 1) / 2.0],
                      [0, f, (H - 1) / 2.0],
                      [0, 0, 1.0]])
    return R_rect0, R_rect1, K_new, b


def rectified_to_source(K_new, R_rect, K, D, uv: np.ndarray) -> np.ndarray:
    """Map rectified pixel coords (..., 2) to SOURCE image coords: the per-
    pixel computation of ``cv::initUndistortRectifyMap``."""
    x = (uv[..., 0] - K_new[0, 2]) / K_new[0, 0]
    y = (uv[..., 1] - K_new[1, 2]) / K_new[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    rays = rays @ R_rect            # == (R_rect^T @ ray^T)^T
    xn = rays[..., :2] / rays[..., 2:3]
    xd = distort_radtan(xn, D)
    us = K[0, 0] * xd[..., 0] + K[0, 2]
    vs = K[1, 1] * xd[..., 1] + K[1, 2]
    return np.stack([us, vs], axis=-1)


def build_rectify_map(K_new, R_rect, K, D, size) -> np.ndarray:
    """(H, W, 2) float32 source-coordinate lookup table."""
    W, H = size
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    return rectified_to_source(K_new, R_rect, K, D,
                               np.stack([u, v], -1)).astype(np.float32)


def remap_bilinear(img: np.ndarray, map_xy: np.ndarray) -> np.ndarray:
    """Bilinear gather; out-of-bounds samples clamp to the border (the
    border pixels never carry keypoints — the extractor's 19 px edge
    margin, ``ORBextractor.cc:73``)."""
    H, W = img.shape
    x = np.clip(map_xy[..., 0], 0, W - 1.001)
    y = np.clip(map_xy[..., 1], 0, H - 1.001)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    fx = x - x0
    fy = y - y0
    im = img.astype(np.float32)
    out = (im[y0, x0] * (1 - fx) * (1 - fy)
           + im[y0, x0 + 1] * fx * (1 - fy)
           + im[y0 + 1, x0] * (1 - fx) * fy
           + im[y0 + 1, x0 + 1] * fx * fy)
    return out
