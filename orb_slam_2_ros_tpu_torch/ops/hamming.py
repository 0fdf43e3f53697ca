"""Batched Hamming distance over 256-bit ORB descriptors.

Port of ``orb_slam_2_ros_tpu/ops/hamming.py``. Descriptors are (N, 8)
``int32`` words with the bits of the reference's ``uint32`` words. The
popcount widens each word to int64 and masks it to its low 32 bits first,
so ``>>`` never shifts in a sign bit.
"""

from __future__ import annotations

import torch

# sentinel distance for masked-out pairs; real distances are <= 256
INF_DIST = 1 << 10


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Bit population count of 32-bit words (int32 or int64 holding the
    word's bits), the reference's SWAR trick done in int64."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _bits(d: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) float32 bits, 0 or 1."""
    shifts = torch.arange(32, dtype=torch.int64, device=d.device)
    bits = (d.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(d.shape[:-1] + (256,)).to(torch.float32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (N, 8) int32, b: (M, 8) int32 -> (N, M) int32 distances, as
    |a| + |b| - 2 a.b over the unpacked bits: one matrix product instead of
    an (N, M, 8) popcount. Exact: 0/1 products summed 256 at most in
    float32 (even TF32 inputs hold 0 and 1 exactly)."""
    ba, bb = _bits(a), _bits(b)
    d = ba.sum(-1)[:, None] + bb.sum(-1)[None, :] - 2.0 * (ba @ bb.mT)
    return d.to(torch.int32)


def hamming_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise rows: a, b (..., 8) int32 -> (...,) int32."""
    return torch.sum(popcount(a ^ b), dim=-1, dtype=torch.int32)


def best_two(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over a masked distance matrix; ties go
    to the lowest column. Rows with no candidate get best_d = INF_DIST and
    index 0. Returns (best_idx, best_d, second_idx, second_d), (N,) int32."""
    d = torch.where(mask, dist, torch.full_like(dist, INF_DIST))
    best_idx = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], INF_DIST)
    second_idx = torch.argmin(d2, dim=1)
    second_d = torch.gather(d2, 1, second_idx[:, None])[:, 0]
    return (best_idx.to(torch.int32), best_d, second_idx.to(torch.int32),
            second_d)
