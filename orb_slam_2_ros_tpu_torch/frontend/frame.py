"""Frame: fixed-shape per-image measurements.

Port of ``orb_slam_2_ros_tpu/frontend/frame.py`` for the RGB-D sensor:
ORB keypoints plus undistorted coords, metric depth and the pseudo right
coordinate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import extractor
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
