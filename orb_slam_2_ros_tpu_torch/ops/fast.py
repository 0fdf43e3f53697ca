"""FAST-9/16 corner scores as whole-image tensor ops.

Port of ``orb_slam_2_ros_tpu/ops/fast.py``: 16 shifted difference planes and
a log-step minimum over 9-pixel arcs give OpenCV's ``cornerScore`` for every
pixel; the 20 -> 7 per-cell threshold fallback and the strict 3x3 non-max
suppression are mask algebra. Everything runs in float32: scores are
integers no greater than 255, so they match the reference exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from orb_slam_2_ros_tpu_torch.ops.image import max_pool_3x3

# OpenCV 16-pixel Bresenham ring of radius 3, as (dx, dy) offsets
RING_16 = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Corner score for every pixel. img: (H, W) float32 with integral
    values. Pixels within 3 of the edge get wrapped-around garbage; callers
    mask a border >= 3."""
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dx, dy in RING_16])          # (16, H, W)
    d = img[None] - ring                                 # >0 where ring darker

    def max_min_over_9runs(diffs):
        m1 = torch.minimum(diffs, torch.roll(diffs, -1, dims=0))
        m2 = torch.minimum(m1, torch.roll(m1, -2, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -4, dims=0))
        m9 = torch.minimum(m4, torch.roll(diffs, -8, dims=0))
        return torch.amax(m9, dim=0)

    dark = max_min_over_9runs(d)
    bright = max_min_over_9runs(-d)
    return torch.maximum(dark, bright) - 1.0


def detect(score: torch.Tensor, threshold: float, min_threshold: float,
           cell: int, border: int) -> torch.Tensor:
    """Response map with the per-cell threshold fallback and strict
    non-max suppression: score where a corner is kept, 0 elsewhere."""
    H, W = score.shape
    ys = torch.arange(H, device=score.device)[:, None]
    xs = torch.arange(W, device=score.device)[None, :]
    in_border = ((xs >= border) & (xs < W - border)
                 & (ys >= border) & (ys < H - border))

    corner_hi = (score >= threshold) & in_border
    corner_lo = (score >= min_threshold) & in_border

    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    occ = F.pad(corner_hi, (0, Wp - W, 0, Hp - H))
    occ = occ.reshape(Hp // cell, cell, Wp // cell, cell).any(dim=3).any(dim=1)
    occ_full = occ[:, None, :, None].expand(-1, cell, -1, cell).reshape(Hp, Wp)
    occ_full = occ_full[:H, :W]

    mask = corner_hi | (corner_lo & ~occ_full)
    resp = torch.where(mask, score, torch.zeros_like(score))
    keep = mask & (resp > max_pool_3x3(resp))
    return torch.where(keep, score, torch.zeros_like(score))
