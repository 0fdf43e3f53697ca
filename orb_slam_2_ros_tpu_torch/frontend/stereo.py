"""Stereo matching: rectified left/right ORB association + subpixel disparity.

Port of ``orb_slam_2_ros_tpu/frontend/stereo.py`` (``Frame::
ComputeStereoMatches``, ``Frame.cc:502-676``): the best Hamming match along
the epipolar band, a subpixel disparity by sliding an 11 x 11 SAD window
over +-5 pixels on the left keypoint's pyramid level with a parabola fit,
and the rejection of outliers against the median SAD.

All of it is plain PyTorch, as it is XLA in the reference: one masked
(P x P) Hamming matrix for the band search, and batched gathers from the
pyramid flattened into one buffer for the SAD. It is no case for the matcher
kernel: the band's radius depends on the RIGHT keypoint's octave, a column
quantity, which the kernel's per-row window cannot express. Among equal
distances or SADs the lowest index wins, as ``jnp.argmin`` picks it (an
``argmin`` on CUDA promises no tie order).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints
from orb_slam_2_ros_tpu_torch.ops.hamming import INF_DIST, hamming_matrix
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span

_W = 5           # SAD half-window (Frame.cc:570)
_SLIDE = 5       # disparity slide range L (Frame.cc:579)


class FlatPyramid(NamedTuple):
    """A pyramid flattened into one buffer for octave-indexed gathers."""

    data: torch.Tensor      # (total_pixels,) float32
    offset: torch.Tensor    # (L,) int64 start of each level
    width: torch.Tensor     # (L,) int64
    height: torch.Tensor    # (L,) int64


def flatten_pyramid(levels: Sequence[torch.Tensor]) -> FlatPyramid:
    offs, ws, hs = [], [], []
    o = 0
    for img in levels:
        offs.append(o)
        hs.append(img.shape[0])
        ws.append(img.shape[1])
        o += img.shape[0] * img.shape[1]
    dev = levels[0].device

    def ints(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return FlatPyramid(data=torch.cat([im.reshape(-1) for im in levels]),
                       offset=ints(offs), width=ints(ws), height=ints(hs))


def _gather_patches(pyr: FlatPyramid, octave, xc, yc, dxs, dys):
    """Pyramid values at (xc + dx, yc + dy) on each keypoint's level,
    clamped to the level's border. octave, xc, yc: (N,) integer level
    coordinates; dxs, dys: (K,) offsets. Returns (N, K) float32."""
    oct_l = octave.to(torch.int64)
    off = pyr.offset[oct_l][:, None]
    W = pyr.width[oct_l][:, None]
    H = pyr.height[oct_l][:, None]
    x = torch.minimum(torch.clamp(xc.to(torch.int64)[:, None] + dxs[None, :],
                                  min=0), W - 1)
    y = torch.minimum(torch.clamp(yc.to(torch.int64)[:, None] + dys[None, :],
                                  min=0), H - 1)
    return pyr.data[off + y * W + x]


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the minimum along the last axis, the lowest among ties."""
    return first_argmax(-x)


@span("frontend.stereo")
def compute_stereo_matches(kl: Keypoints, kr: Keypoints,
                           pyr_l: FlatPyramid, pyr_r: FlatPyramid,
                           cfg: SlamConfig):
    """Returns (u_right (P,), depth (P,)) for the left frame, -1 where
    unmatched: the ``mvuRight`` / ``mvDepth`` channels
    (``Frame.cc:504-505``)."""
    cam = cfg.camera
    m = cfg.matcher
    P = kl.xy.shape[0]
    dev = kl.xy.device
    f32, i64 = torch.float32, torch.int64
    sf = cfg.orb.scale_factor

    # ---- 1. coarse Hamming match along the epipolar band
    vL = kl.xy[:, 1]
    vR = kr.xy[None, :, 1]
    r_band = 2.0 * torch.pow(torch.full_like(vL, sf), kr.octave.to(f32))
    row_ok = torch.abs(vL[:, None] - vR) <= r_band[None, :]
    oL = kl.octave[:, None]
    oR = kr.octave[None, :]
    oct_ok = (oR >= oL - 1) & (oR <= oL + 1)
    uL = kl.xy[:, 0]
    min_d, max_d = 0.0, cam.fx           # maxD = bf / minB = fx
    disp = uL[:, None] - kr.xy[None, :, 0]
    disp_ok = (disp > min_d) & (disp <= max_d)
    mask = row_ok & oct_ok & disp_ok & kl.valid[:, None] & kr.valid[None, :]
    D = torch.where(mask, hamming_matrix(kl.desc, kr.desc),
                    torch.full((), INF_DIST, dtype=torch.int32, device=dev))
    # the lowest column among equal distances, by a composite key
    cols = torch.arange(P, dtype=torch.int32, device=dev)
    key = torch.min(D * (1 << 15) + cols, dim=1).values
    best, best_d = (key & ((1 << 15) - 1)).to(i64), key >> 15
    th_orb = (m.th_high + m.th_low) / 2                     # Frame.cc:547
    coarse_ok = best_d < th_orb

    # ---- 2. subpixel SAD refinement on the left keypoint's octave
    scale_inv = torch.pow(torch.full_like(uL, 1.0 / sf), kl.octave.to(f32))
    xL = torch.round(kl.xy[:, 0] * scale_inv).to(i64)
    yL = torch.round(kl.xy[:, 1] * scale_inv).to(i64)
    uR0 = kr.xy[best, 0]
    xR0 = torch.round(uR0 * scale_inv).to(i64)

    def offsets(a):
        return torch.as_tensor(a, dtype=i64, device=dev)

    win = np.arange(-_W, _W + 1)
    n_win = len(win)
    wide = np.arange(-_W - _SLIDE, _W + _SLIDE + 1)
    zero = offsets([0])
    patch_l = _gather_patches(pyr_l, kl.octave, xL, yL,
                              offsets(np.tile(win, n_win)),
                              offsets(np.repeat(win, n_win)))      # (P, 121)
    # centre-normalised SAD as in the reference (IL - IL_centre)
    patch_l = patch_l - _gather_patches(pyr_l, kl.octave, xL, yL, zero, zero)
    patch_r = _gather_patches(pyr_r, kl.octave, xR0, yL,
                              offsets(np.tile(wide, n_win)),
                              offsets(np.repeat(win, len(wide))))
    patch_r = (patch_r - _gather_patches(pyr_r, kl.octave, xR0, yL, zero,
                                         zero)).reshape(P, n_win, len(wide))
    pl = patch_l.reshape(P, n_win, n_win)
    n_slide = 2 * _SLIDE + 1
    sads = torch.stack([torch.sum(torch.abs(pl - patch_r[:, :, i:i + n_win]),
                                  dim=(1, 2))
                        for i in range(n_slide)], dim=1)          # (P, 11)

    best_i = _first_argmin(sads)
    interior = (best_i > 0) & (best_i < n_slide - 1)
    i0 = torch.clamp(best_i, 1, n_slide - 2)
    s_m = torch.gather(sads, 1, (i0 - 1)[:, None])[:, 0]
    s_0 = torch.gather(sads, 1, i0[:, None])[:, 0]
    s_p = torch.gather(sads, 1, (i0 + 1)[:, None])[:, 0]
    delta = (s_m - s_p) / torch.clamp(2.0 * (s_m + s_p - 2.0 * s_0),
                                      min=1e-9)
    delta = torch.clamp(delta, -1.0, 1.0)

    sf_l = torch.pow(torch.full_like(uL, sf), kl.octave.to(f32))
    uR_sub = sf_l * (xR0.to(f32) + (i0 - _SLIDE).to(f32) + delta)
    disparity = uL - uR_sub
    ok = (coarse_ok & interior & (disparity > min_d) & (disparity < max_d)
          & kl.valid)

    # ---- 3. median-SAD outlier rejection (Frame.cc:644-667)
    sad_sorted = torch.sort(torch.where(ok, s_0,
                                        torch.full_like(s_0, float("inf"))))[0]
    n_ok = torch.sum(ok, dtype=torch.int64)
    median = sad_sorted.index_select(
        0, torch.clamp(n_ok // 2, 0, P - 1).reshape(1))[0]
    ok = ok & (s_0 <= 1.5 * 1.4 * median)

    neg = torch.full_like(uR_sub, -1.0)
    u_right = torch.where(ok, uR_sub, neg)
    depth = torch.where(ok, cam.bf / torch.clamp(disparity, min=1e-9), neg)
    return u_right, depth
