"""Plain ORB extraction: the reference for the frontend's keypoints and
descriptors.

ORB-SLAM2's extractor as the port's configuration states it
(``ORBextractor.cc``; 1200 features, 8 levels, scale 1.2, FAST 20/7):
per level a bilinear pyramid image with half-pixel centres rounded to u8,
FAST-9/16 corner scores, the 20 -> 7 threshold fallback per 32-pixel cell,
strict 3x3 non-max suppression, the level's budget of the strongest
responses (ties to the lower raster index), the intensity-centroid angle
over the r = 15 disc, and the rotated 256-pair rBRIEF on the 7x7 (sigma 2)
blurred level, packed into eight 32-bit words. The pattern is the public
one of Rublee et al. (OpenCV's ``bit_pattern_31_``), copied to
``data/brief_pattern.npy``.

Written straight from those rules, one level at a time, on any device.
``dtype`` sets the arithmetic of the image stages (resize, blur, centroid
moments): float32 is the reference; bfloat16 is the control, the precision
a later change might be tempted to use.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

PATTERN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "brief_pattern.npy")
HALF_PATCH = 15
# FAST's 16-pixel Bresenham ring of radius 3, in ring order
RING = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3))


class Params(NamedTuple):
    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    edge_threshold: int = 19
    fast_cell: int = 32


class Keypoints(NamedTuple):
    """The keypoints of one image: level-0 pixel positions, level, angle
    and descriptor words; only corners with a positive response."""
    xy: torch.Tensor       # (n, 2) float32
    octave: torch.Tensor   # (n,) int64
    angle: torch.Tensor    # (n,) float32
    desc: torch.Tensor     # (n, 8) int32


def params_from_config(orb: dict) -> Params:
    return Params(**{k: orb[k] for k in Params._fields})


def budgets(p: Params) -> List[int]:
    """Features per level: a geometric series, the rest on the last level."""
    f = 1.0 / p.scale_factor
    want = p.n_features * (1 - f) / (1 - f ** p.n_levels)
    out = [int(round(want * f ** i)) for i in range(p.n_levels - 1)]
    return out + [max(p.n_features - sum(out), 0)]


def disc_rows() -> List[int]:
    """Half-widths of the r = 15 disc's rows, made symmetric as in the
    ORBextractor constructor."""
    hp = HALF_PATCH
    umax = [0] * (hp + 2)
    vmax = int(math.floor(hp * math.sqrt(2.0) / 2.0 + 1))
    vmin = int(math.ceil(hp * math.sqrt(2.0) / 2.0))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:hp + 1]


def _resize(img: torch.Tensor, H: int, W: int, dtype) -> torch.Tensor:
    """Bilinear resize with half-pixel centres, rows then columns; the tap
    weights computed in float32 and normalised by their sum."""
    def taps(n_src, n_dst):
        f32 = np.float32
        src = ((np.arange(n_dst, dtype=f32) + f32(0.5))
               * f32(1.0 / (n_dst / n_src)) - f32(0.5))
        i0 = np.clip(np.floor(src).astype(np.int64), 0, n_src - 1)
        i1 = np.minimum(i0 + 1, n_src - 1)
        w0 = np.maximum(f32(0), f32(1) - np.abs(src - i0.astype(f32)))
        w1 = np.where(i0 + 1 < n_src,
                      np.maximum(f32(0), f32(1) - np.abs(src - (i0 + 1).astype(f32))),
                      f32(0)).astype(f32)
        tot = (w0 + w1).astype(f32)
        dev = img.device
        return (torch.as_tensor(i0, device=dev), torch.as_tensor(i1, device=dev),
                torch.as_tensor(w0 / tot, device=dev).to(dtype),
                torch.as_tensor(w1 / tot, device=dev).to(dtype))
    Hs, Ws = img.shape
    r0, r1, rw0, rw1 = taps(Hs, H)
    c0, c1, cw0, cw1 = taps(Ws, W)
    x = img.to(dtype)
    rows = rw0[:, None] * x[r0] + rw1[:, None] * x[r1]
    out = cw0[None, :] * rows[:, c0] + cw1[None, :] * rows[:, c1]
    return torch.clamp(torch.round(out.float()), 0, 255)


def _blur(img: torch.Tensor, dtype) -> torch.Tensor:
    """7x7 Gaussian, sigma 2, reflected borders without repeating the edge;
    rows then columns, tap 0 first; rounded to u8 values."""
    x = np.arange(7) - 3.0
    k = np.exp(-(x * x) / 8.0)
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="reflect")[0, 0].to(dtype)
    rows = sum(k[i] * p[:, i:i + W] for i in range(7))
    out = sum(k[i] * rows[i:i + H, :] for i in range(7))
    return torch.clamp(torch.round(out.float()), 0, 255)


def fast_scores(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 score of every pixel: the largest t such that 9 contiguous
    ring pixels are all darker, or all brighter, than the centre by more
    than t (the score is that margin less one)."""
    H, W = img.shape
    p = F.pad(img, (3, 3, 3, 3))
    ring = torch.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dx, dy in RING])
    d = img[None] - ring
    best = torch.full_like(img, -float("inf"))
    for sign in (1.0, -1.0):
        s = sign * d
        for start in range(16):
            arc = torch.stack([s[(start + j) % 16] for j in range(9)])
            best = torch.maximum(best, arc.amin(0))
    return best - 1.0


def detect(score: torch.Tensor, p: Params) -> torch.Tensor:
    """Response map: FAST corners above the high threshold, or above the
    low one in a cell with no high corner; kept where strictly above all
    eight neighbours; the score there, 0 elsewhere."""
    H, W = score.shape
    b = p.edge_threshold
    inside = torch.zeros_like(score, dtype=torch.bool)
    inside[b:H - b, b:W - b] = True
    hi = (score >= p.ini_th_fast) & inside
    lo = (score >= p.min_th_fast) & inside
    c = p.fast_cell
    Hc, Wc = -(-H // c), -(-W // c)
    cells = F.pad(hi, (0, Wc * c - W, 0, Hc * c - H)).reshape(Hc, c, Wc, c)
    cell_has_hi = cells.any(3).any(1).repeat_interleave(c, 0) \
        .repeat_interleave(c, 1)[:H, :W]
    keep = hi | (lo & ~cell_has_hi)
    resp = torch.where(keep, score, torch.zeros_like(score))
    q = F.pad(resp, (1, 1, 1, 1), value=-float("inf"))
    nmax = torch.stack([q[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dy or dx]).amax(0)
    return torch.where(keep & (resp > nmax), score, torch.zeros_like(score))


def _angles(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            dtype) -> torch.Tensor:
    """Intensity-centroid angles: the moments m10 = sum u I and m01 =
    sum v I over the disc (integers below 2^24, so exact in float32)."""
    umax = disc_rows()
    du = [u for v in range(-HALF_PATCH, HALF_PATCH + 1)
          for u in range(-umax[abs(v)], umax[abs(v)] + 1)]
    dv = [v for v in range(-HALF_PATCH, HALF_PATCH + 1)
          for _ in range(-umax[abs(v)], umax[abs(v)] + 1)]
    du = torch.tensor(du, device=img.device)
    dv = torch.tensor(dv, device=img.device)
    vals = img.to(dtype)[y[:, None] + dv[None, :], x[:, None] + du[None, :]]
    m10 = (vals * du.to(dtype)).sum(1)
    m01 = (vals * dv.to(dtype)).sum(1)
    return torch.atan2(m01.float(), m10.float())


def _brief(blurred: torch.Tensor, x, y, angle) -> torch.Tensor:
    H, W = blurred.shape
    pat = torch.as_tensor(np.load(PATTERN).astype(np.float32),
                          device=blurred.device)
    a, b = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    sx = (torch.round(px * a - py * b).long() + x[:, None]).clamp(0, W - 1)
    sy = (torch.round(px * b + py * a).long() + y[:, None]).clamp(0, H - 1)
    vals = blurred[sy, sx]
    bits = (vals[:, 0::2] < vals[:, 1::2]).long().reshape(-1, 8, 32)
    words = (bits << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).int()


def extract(gray: torch.Tensor, p: Params = Params(),
            dtype=torch.float32) -> Keypoints:
    """The keypoints of a gray image (H, W) with integral values."""
    H, W = gray.shape
    level = torch.clamp(torch.round(gray.float()), 0, 255)
    out = {k: [] for k in Keypoints._fields}
    for lvl, k in enumerate(budgets(p)):
        scale = p.scale_factor ** lvl
        if lvl:
            level = _resize(level, int(round(H / scale)),
                            int(round(W / scale)), dtype)
        resp = detect(fast_scores(level), p).reshape(-1)
        order = torch.sort(resp, descending=True, stable=True).indices[:k]
        order = order[resp[order] > 0]
        Wl = level.shape[1]
        y, x = order // Wl, order % Wl
        angle = _angles(level, x, y, dtype)
        out["desc"].append(_brief(_blur(level, dtype), x, y, angle))
        out["angle"].append(angle)
        out["xy"].append(torch.stack([x, y], -1).float()
                         * torch.tensor(scale, dtype=torch.float32))
        out["octave"].append(torch.full_like(x, lvl))
    return Keypoints(**{k: torch.cat(v) for k, v in out.items()})
