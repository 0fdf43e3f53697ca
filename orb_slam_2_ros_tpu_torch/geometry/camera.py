"""Pinhole camera with Brown-Conrady distortion, batched over points.

Port of the RGB-D path's part of ``orb_slam_2_ros_tpu/geometry/camera.py``:
pixel tensors are (..., 2), point tensors (..., 3).
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import CameraConfig

_EPS = 1e-9


def intrinsics(cam: CameraConfig, device) -> torch.Tensor:
    """The (3, 3) calibration matrix K on ``device``."""
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def _normalize(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized coords. Intrinsics enter as Python scalars, so no
    host-to-device copy (and no stream sync) happens per call."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def _to_pixels(cam: CameraConfig, xy: torch.Tensor) -> torch.Tensor:
    return torch.stack([xy[..., 0] * cam.fx + cam.cx,
                        xy[..., 1] * cam.fy + cam.cy], dim=-1)


def distort_normalized(cam: CameraConfig, xy: torch.Tensor) -> torch.Tensor:
    """Apply the Brown model to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xt = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yt = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xt, yt], dim=-1)


def undistort_normalized(cam: CameraConfig, xy_d: torch.Tensor,
                         iters: int = 10) -> torch.Tensor:
    """Invert the Brown model by fixed-point iteration (the scheme of
    cv::undistortPoints)."""
    x_d, y_d = xy_d[..., 0], xy_d[..., 1]
    x, y = x_d, y_d
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (x_d - dx) / radial
        y = (y_d - dy) / radial
    return torch.stack([x, y], dim=-1)


def undistort_pixels(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords -> undistorted pixel coords (same K)."""
    if not cam.has_distortion:
        return uv
    return _to_pixels(cam, undistort_normalized(cam, _normalize(cam, uv)))


def project(cam: CameraConfig, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> undistorted pixels (..., 2)."""
    z = torch.clamp(xc[..., 2:3], min=_EPS)
    return _to_pixels(cam, xc[..., :2] / z)


def project_stereo(cam: CameraConfig, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points -> (u, v, uR) with uR = u - bf/z."""
    uv = project(cam, xc)
    z = torch.clamp(xc[..., 2:3], min=_EPS)
    ur = uv[..., :1] - cam.bf / z
    return torch.cat([uv, ur], dim=-1)


def backproject(cam: CameraConfig, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels + depth -> camera-frame 3D points."""
    d = depth[..., None] if depth.dim() == uv.dim() - 1 else depth
    return torch.cat([_normalize(cam, uv) * d, d], dim=-1)


def depth_from_disparity(cam: CameraConfig, u_left: torch.Tensor,
                         u_right: torch.Tensor) -> torch.Tensor:
    """z = bf / (uL - uR); a non-positive disparity gives -1."""
    disp = u_left - u_right
    return torch.where(disp > 0, cam.bf / torch.clamp(disp, min=_EPS),
                       torch.full_like(disp, -1.0))


def right_coord_from_depth(cam: CameraConfig, u: torch.Tensor,
                           depth: torch.Tensor) -> torch.Tensor:
    """RGB-D pseudo-stereo: uR = u - bf/d for valid depth, else -1."""
    return torch.where(depth > 0, u - cam.bf / torch.clamp(depth, min=_EPS),
                       torch.full_like(u, -1.0))


def in_image(cam: CameraConfig, uv: torch.Tensor,
             border: float = 0.0) -> torch.Tensor:
    """Bounds check against the undistorted image rectangle."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= border) & (u < cam.width - border)
            & (v >= border) & (v < cam.height - border))
