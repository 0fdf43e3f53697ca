"""ORB feature extraction on tensors.

Port of ``orb_slam_2_ros_tpu/frontend/extractor.py``: per pyramid level,
FAST scores + cell-threshold fallback + non-max (ops/fast.py), a per-level
budget cut of the response map, then the per-keypoint stage: the IC angle
over the r=15 circular patch and the rotated 256-pair rBRIEF, packed in
OpenCV byte order.

The per-keypoint stage reads pixels with direct gathers. The reference cuts
37x37 patches with one-hot bf16 matmuls only because gathers are slow on a
TPU; on a GPU a gather is the natural form. The IC moments are sums of
integer products below 2^24, so they are exact in float32 in any order.

Every frame yields ``cfg.max_kps`` keypoint slots with a validity mask.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import OrbConfig
from orb_slam_2_ros_tpu_torch.ops import fast as fast_ops
from orb_slam_2_ros_tpu_torch.ops.image import (gaussian_blur_7x7,
                                                quantize_u8, resize_linear)
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span

HALF_PATCH = 15
# the public learned rBRIEF pattern (Rublee et al. 2011, OpenCV's
# bit_pattern_31_): 512 (x, y) int8 offsets, the port's own copy
_PATTERN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "brief_pattern.npy")


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one image; ``xy`` are raw (distorted)
    level-0 pixel coords."""

    xy: torch.Tensor        # (max_kps, 2) float32
    response: torch.Tensor  # (max_kps,) float32 FAST corner score
    angle: torch.Tensor     # (max_kps,) float32 radians
    octave: torch.Tensor    # (max_kps,) int32 pyramid level
    desc: torch.Tensor      # (max_kps, 8) int32 words = 256-bit rBRIEF
    valid: torch.Tensor     # (max_kps,) bool


def level_budgets(cfg: OrbConfig) -> list:
    """Per-level feature budgets, geometric series with the remainder on the
    last level (``ORBextractor.cc:444-455``)."""
    factor = 1.0 / cfg.scale_factor
    n_desired = cfg.n_features * (1 - factor) / (1 - factor ** cfg.n_levels)
    budgets = []
    for i in range(cfg.n_levels - 1):
        budgets.append(int(round(n_desired * factor ** i)))
    budgets.append(max(cfg.n_features - sum(budgets), 0))
    return budgets


@functools.lru_cache()
def umax_table(hp: int = HALF_PATCH) -> tuple:
    """Circular-patch row extents with the ORBextractor constructor's
    symmetry correction (``ORBextractor.cc:452-468``)."""
    umax = [0] * (hp + 2)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2.0 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2.0))
    hp2 = hp * hp
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return tuple(umax[: hp + 1])


@functools.lru_cache()
def _ic_disc_np():
    """Offsets (du, dv) of the r=15 circular patch, as two int64 arrays."""
    um = umax_table()
    du, dv = [], []
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = um[abs(v)]
        for u in range(-d, d + 1):
            du.append(u)
            dv.append(v)
    return np.asarray(du, np.int64), np.asarray(dv, np.int64)


@functools.lru_cache(maxsize=None)
def _ic_disc(device: str):
    du, dv = _ic_disc_np()
    return (torch.as_tensor(du, device=device),
            torch.as_tensor(dv, device=device))


@functools.lru_cache(maxsize=None)
def _brief_pattern(device: str) -> torch.Tensor:
    """(512, 2) float32 sampling offsets."""
    return torch.as_tensor(np.load(_PATTERN_PATH).astype(np.float32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _bit_weights(device: str) -> torch.Tensor:
    return torch.as_tensor(np.int64(1) << np.arange(32, dtype=np.int64),
                           device=device)


def ic_angles_at(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """IC angles at integer keypoint positions (IC_Angle,
    ``ORBextractor.cc:77-104``): the u and v moments of the circular patch,
    gathered directly. Keypoints lie >= 16 px from the border."""
    H, W = img.shape
    du, dv = _ic_disc(str(img.device))
    flat = img.reshape(-1)
    idx = (y[:, None] + dv[None, :]) * W + (x[:, None] + du[None, :])
    vals = flat[idx.clamp(0, H * W - 1)]                 # (n, disc)
    m10 = torch.sum(vals * du.to(vals.dtype)[None, :], dim=1)
    m01 = torch.sum(vals * dv.to(vals.dtype)[None, :], dim=1)
    return torch.atan2(m01, m10)


def _pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words with the bits of the reference's
    uint32 words: byte k of the OpenCV descriptor is
    (word[k//4] >> 8*(k%4)) & 0xFF."""
    b = bits.to(torch.int64).reshape(bits.shape[0], 8, 32)
    words = torch.sum(b * _bit_weights(str(bits.device)), dim=-1)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32)


def _descriptors(blurred: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 angle: torch.Tensor) -> torch.Tensor:
    """Rotated rBRIEF at integer (x, y) on one level (computeOrbDescriptor,
    ``ORBextractor.cc:108-147``): sample i is read at (x + round(px*cos -
    py*sin), y + round(px*sin + py*cos)); bit i = sample(2i) < sample(2i+1)."""
    H, W = blurred.shape
    pat = _brief_pattern(str(blurred.device))
    a = torch.cos(angle)[:, None]
    b = torch.sin(angle)[:, None]
    px, py = pat[:, 0][None, :], pat[:, 1][None, :]
    sx = torch.round(px * a - py * b).to(torch.int64) + x[:, None]
    sy = torch.round(px * b + py * a).to(torch.int64) + y[:, None]
    sx = sx.clamp(0, W - 1)
    sy = sy.clamp(0, H - 1)
    vals = blurred.reshape(-1)[sy * W + sx]              # (n, 512)
    return _pack_bits_u32(vals[:, 0::2] < vals[:, 1::2])


def _top_budget(resp_flat: torch.Tensor, k: int):
    """The k largest responses, lower flat index first among ties — the
    order of ``jax.lax.top_k`` (``torch.topk`` promises none)."""
    vals, idx = torch.sort(resp_flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def extract(img: torch.Tensor, cfg: OrbConfig) -> Keypoints:
    """ORB extraction for one grayscale image (H, W) float32 in [0, 255]."""
    kps, _ = extract_with_pyramid(img, cfg)
    return kps


@span("frontend.extract")
def extract_with_pyramid(img: torch.Tensor, cfg: OrbConfig):
    """extract() that also returns the (unblurred) pyramid level images."""
    budgets = level_budgets(cfg)
    H, W = img.shape
    dev = img.device
    img = quantize_u8(img)

    xs_l, ys_l, rs, octs, angles, descs = [], [], [], [], [], []
    pyramid = []
    level_img = img
    for lvl in range(cfg.n_levels):
        if lvl > 0:
            scale = cfg.scale_factor ** lvl
            sz = (int(round(H / scale)), int(round(W / scale)))
            with span("frontend.resize_linear"):
                level_img = quantize_u8(resize_linear(level_img, sz))
        pyramid.append(level_img)
        Wl = level_img.shape[1]

        with span("frontend.fast_score_map"):
            score = fast_ops.fast_score_map(level_img)
        with span("frontend.detect"):
            resp_map = fast_ops.detect(
                score, threshold=float(cfg.ini_th_fast),
                min_threshold=float(cfg.min_th_fast),
                cell=cfg.fast_cell, border=cfg.edge_threshold)
        with span("frontend.budget_cut"):
            vals, idx = _top_budget(resp_map.reshape(-1), budgets[lvl])
        y = idx // Wl
        x = idx % Wl
        xs_l.append(x)
        ys_l.append(y)
        rs.append(vals)
        octs.append(torch.full((budgets[lvl],), lvl, dtype=torch.int32,
                               device=dev))

        with span("frontend.gaussian_blur"):
            blurred = quantize_u8(gaussian_blur_7x7(level_img))
        with span("frontend.ic_angles"):
            angle_l = ic_angles_at(level_img, x, y)
        angles.append(angle_l)
        with span("frontend.descriptors"):
            descs.append(_descriptors(blurred, x, y, angle_l))

    x = torch.cat(xs_l)
    y = torch.cat(ys_l)
    response = torch.cat(rs)
    octave = torch.cat(octs)
    valid = response > 0.0
    angle = torch.cat(angles)
    desc = torch.cat(descs)

    scale_per = [cfg.scale_factor ** l for l in range(cfg.n_levels)]
    sf = torch.cat([torch.full((n,), s, dtype=torch.float32, device=dev)
                    for n, s in zip(budgets, scale_per)])
    xy = torch.stack([x, y], -1).to(torch.float32) * sf[:, None]

    n = xy.shape[0]
    pad = cfg.max_kps - n
    if pad < 0:
        raise ValueError(f"max_kps={cfg.max_kps} < n_features={n}")
    if pad:
        xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
        response = torch.nn.functional.pad(response, (0, pad))
        angle = torch.nn.functional.pad(angle, (0, pad))
        desc = torch.nn.functional.pad(desc, (0, 0, 0, pad))
        octave = torch.nn.functional.pad(octave, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return Keypoints(xy=xy, response=response, angle=angle,
                     octave=octave, desc=desc, valid=valid), pyramid
