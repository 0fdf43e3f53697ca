"""Frame: fixed-shape per-image measurements.

Port of ``orb_slam_2_ros_tpu/frontend/frame.py`` for the three sensors:
ORB keypoints plus undistorted coords, metric depth and the right
coordinate (the pseudo one from depth for RGB-D, the matched one for
stereo, none for mono).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import extractor
from orb_slam_2_ros_tpu_torch.frontend import stereo as stereo_mod
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints
from orb_slam_2_ros_tpu_torch.geometry import camera


class Frame(NamedTuple):
    """One image's measurements (the pose lives in the tracking state)."""

    kps: Keypoints          # raw (distorted) coords + desc + angle + octave
    uv: torch.Tensor        # (max_kps, 2) undistorted pixel coords
    u_right: torch.Tensor   # (max_kps,) right-image u coord, -1 if unavailable
    depth: torch.Tensor     # (max_kps,) metric depth, -1 if unavailable

    @property
    def valid(self):
        return self.kps.valid

    @property
    def desc(self):
        return self.kps.desc


def build_mono(gray: torch.Tensor, cfg: SlamConfig) -> Frame:
    """Monocular frame (``Frame.cc:182-236``): extract + undistort; no
    depth and no right coordinate (both -1)."""
    kps = extractor.extract(gray, cfg.orb)
    uv = camera.undistort_pixels(cfg.camera, kps.xy)
    neg = torch.full((cfg.orb.max_kps,), -1.0, dtype=torch.float32,
                     device=gray.device)
    return Frame(kps=kps, uv=uv, u_right=neg, depth=neg.clone())


def build_stereo(gray_l: torch.Tensor, gray_r: torch.Tensor,
                 cfg: SlamConfig) -> Frame:
    """Rectified stereo frame (``Frame.cc:62-118``): ORB on both images,
    then epipolar-band matching with subpixel SAD disparity
    (``frontend/stereo.py``)."""
    kl, pyr_l = extractor.extract_with_pyramid(gray_l, cfg.orb)
    kr, pyr_r = extractor.extract_with_pyramid(gray_r, cfg.orb)
    uv = camera.undistort_pixels(cfg.camera, kl.xy)
    ur, depth = stereo_mod.compute_stereo_matches(
        kl, kr, stereo_mod.flatten_pyramid(pyr_l),
        stereo_mod.flatten_pyramid(pyr_r), cfg)
    return Frame(kps=kl, uv=uv, u_right=ur, depth=depth)


def build_rgbd(gray: torch.Tensor, depth_img: torch.Tensor,
               cfg: SlamConfig) -> Frame:
    """RGB-D frame (``Frame.cc:62-118`` + ``ComputeStereoFromRGBD``,
    ``Frame.cc:679-701``): depth sampled at the raw keypoint pixel, pseudo
    right coordinate uR = u_undist - bf/d.

    depth_img: (H, W) float32 metres; <= 0 marks missing depth."""
    kps = extractor.extract(gray, cfg.orb)
    uv = camera.undistort_pixels(cfg.camera, kps.xy)
    H, W = depth_img.shape
    xi = torch.round(kps.xy[:, 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(kps.xy[:, 1]).to(torch.int64).clamp(0, H - 1)
    d = depth_img.reshape(-1)[yi * W + xi]
    d = torch.where(kps.valid & (d > 0), d, torch.full_like(d, -1.0))
    ur = camera.right_coord_from_depth(cfg.camera, uv[:, 0], d)
    return Frame(kps=kps, uv=uv, u_right=ur, depth=d)
