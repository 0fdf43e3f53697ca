"""Whole-image primitives matched to the OpenCV calls of the reference.

Port of ``orb_slam_2_ros_tpu/ops/image.py``:
- ``gaussian_blur_7x7``: GaussianBlur(7x7, sigma=2, BORDER_REFLECT_101);
- ``resize_linear``: cv::resize INTER_LINEAR with half-pixel centres, as the
  two-tap form of the reference's ``_resize_weights`` (the rounding rule
  stays visible instead of hiding in ``F.interpolate``);
- ``quantize_u8``: round to the 8-bit values the C++ pipeline stores
  between stages, kept in float32;
- ``max_pool_3x3``: the 8-neighbourhood max for FAST non-max suppression.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """cv::getGaussianKernel equivalent (float path)."""
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_7x7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 blur, sigma 2, with reflect-101 borders. img: (H, W)
    float32.

    Same taps, same order of the f32 sums as the reference (rows, then
    columns, tap 0 first)."""
    k = [float(v) for v in gaussian_kernel(7, 2.0)]
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="reflect")[0, 0]
    rows = sum(k[i] * p[:, i:i + W] for i in range(7))
    return sum(k[i] * rows[i:i + H, :] for i in range(7))


@functools.lru_cache(maxsize=None)
def _resize_taps(n_src: int, n_dst: int, device: str):
    """Two-tap form of the reference's ``_resize_weights``: source indices
    (i0, i1) and weights (w0, w1) per output sample, half-pixel centres.

    The weights are rounded the way ``jax.image.resize`` rounds them: the
    sample position in f32, the triangle kernel 1 - |x| per tap, then
    divided by the taps' f32 sum. Weights from float64 positions differ in
    the last bits and flip about 0.5% of the u8 pixels of the next level;
    these flip a handful per pyramid. Cached per device, so the host to
    device copy happens once."""
    f32 = np.float32
    inv_scale = 1.0 / (n_dst / n_src)
    src = (np.arange(n_dst, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_src - 1)
    i1 = np.minimum(i0 + 1, n_src - 1)
    w0 = np.maximum(f32(0), f32(1) - np.abs(src - i0.astype(f32)))
    w1 = np.where(i0 + 1 < n_src,
                  np.maximum(f32(0), f32(1) - np.abs(src - (i0 + 1).astype(f32))),
                  f32(0)).astype(f32)
    total = (w0 + w1).astype(f32)
    to = functools.partial(torch.as_tensor, device=device)
    return to(i0), to(i1), to((w0 / total).astype(f32)), to((w1 / total).astype(f32))


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (== cv::resize INTER_LINEAR),
    rows first, then columns."""
    Hs, Ws = img.shape
    Hd, Wd = shape
    dev = str(img.device)
    r0, r1, rw0, rw1 = _resize_taps(Hs, Hd, dev)
    c0, c1, cw0, cw1 = _resize_taps(Ws, Wd, dev)
    rows = rw0[:, None] * img[r0] + rw1[:, None] * img[r1]
    return cw0[None, :] * rows[:, c0] + cw1[None, :] * rows[:, c1]


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """Round to integral values in [0, 255], kept as float32."""
    return torch.clamp(torch.round(img), 0.0, 255.0)


def max_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """Max over the 8-neighbourhood (the centre left out), -inf padded at
    the border."""
    H, W = x.shape
    p = F.pad(x[None, None], (1, 1, 1, 1), value=float("-inf"))[0, 0]
    out = torch.full_like(x, float("-inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = torch.maximum(out, p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return out
