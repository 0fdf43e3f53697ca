"""Kernel B1 (``masked_best_two``): the plain reference of its answers and
the count of the work its inputs need.

``gate_mask`` and ``work`` are frozen copies, taken from
``orb_slam_2_ros_tpu_torch/ops/match_kernel.py::gate_mask`` and
``orb_slam_2_ros_tpu_torch/bench_match_kernel.py::work`` (with its constants)
at commit ``b77b5cd74ef9125f0ac89662d885404aa9a6b150``, so that whatever
later implements B1 is read against the same work. ``best_two`` is written
from B1's contract: per query row, the best and second-best candidate by
Hamming distance over 256-bit descriptors among the candidates that pass
the gates, ties to the lowest column, rows with no candidate at distance
1024 and index 0.

    row_meta (8, N) f32 = [u, v, r, oct_lo, oct_hi, ur, ok, 0]
    col_meta (8, M) f32 = [u, v, oct, ur, ok, 0, 0, 0]
"""

from __future__ import annotations

import torch

INF_DIST = 1 << 10
# the assumed peaks (NVIDIA's data sheet for the H100 SXM at 700 W): HBM
# bandwidth, and one simple 32-bit operation per CUDA core per cycle
# (16,896 cores at 1.98 GHz, the f32 rate without FMA)
HBM_BYTES_PER_S = 3.35e12
SIMPLE_OPS_PER_S = 33.5e12
OPS_PER_PAIR = 15       # gates and the fold, for every (row, column) pair
OPS_PER_DISTANCE = 25   # XOR, popcount and compare of 8 words, per passing pair


def gate_mask(row_meta: torch.Tensor, col_meta: torch.Tensor) -> torch.Tensor:
    """(N, M) bool: the kernel's candidate gates, in the same f32 ops."""
    ru, rv, rr = row_meta[0][:, None], row_meta[1][:, None], row_meta[2][:, None]
    rlo, rhi, rur = row_meta[3][:, None], row_meta[4][:, None], row_meta[5][:, None]
    rok = row_meta[6][:, None] > 0
    cu, cv, co = col_meta[0][None, :], col_meta[1][None, :], col_meta[2][None, :]
    cur, cok = col_meta[3][None, :], col_meta[4][None, :] > 0
    ok = (rok & cok
          & (torch.abs(ru - cu) <= rr) & (torch.abs(rv - cv) <= rr)
          & (co >= rlo) & (co <= rhi))
    return ok & ((cur <= 0) | (torch.abs(rur - cur) <= rr))


def work(args):
    """What one call on ``args`` has to do, and the least time the card
    could take for it: every input byte read once and every output byte
    written once at the memory rate, against ``OPS_PER_PAIR`` simple
    operations for every pair and ``OPS_PER_DISTANCE`` more for every pair
    that passes these gates, at the f32 rate of the CUDA cores."""
    desc_rows, row_meta, desc_cols, col_meta = args
    N, M = desc_rows.shape[0], desc_cols.shape[0]
    passes = int(gate_mask(row_meta, col_meta).sum())
    nbytes = sum(x.numel() * x.element_size() for x in args) + 4 * N * 4
    ops = OPS_PER_PAIR * N * M + OPS_PER_DISTANCE * passes
    bytes_us = 1e6 * nbytes / HBM_BYTES_PER_S
    ops_us = 1e6 * ops / SIMPLE_OPS_PER_S
    return {"N": N, "M": M, "pairs": N * M, "passes": passes,
            "bytes": nbytes, "ops": ops, "bytes_us": bytes_us,
            "ops_us": ops_us, "bound_us": max(bytes_us, ops_us),
            "bound_by": "bytes" if bytes_us > ops_us else "operations"}


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int64 bit differences."""
    x = (a.long()[:, None, :] ^ b.long()[None, :, :]) & 0xFFFFFFFF
    total = torch.zeros(x.shape[:2], dtype=torch.int64, device=x.device)
    for s in range(32):
        total += ((x >> s) & 1).sum(-1)
    return total


def best_two(desc_rows, row_meta, desc_cols, col_meta, fp8: bool = False):
    """(best_idx, best_d, second_idx, second_d), each (N,) int32. With
    ``fp8`` the distances are rounded to float8 e4m3 before the choice:
    the control, the precision below the bfloat16 of the TPU kernel that
    B1 was ported from."""
    M = desc_cols.shape[0]
    col = torch.arange(M, device=desc_rows.device)
    outs = [[], [], [], []]
    block = max(1, (1 << 22) // (8 * M))
    for r0 in range(0, desc_rows.shape[0], block):
        r1 = min(r0 + block, desc_rows.shape[0])
        d = hamming(desc_rows[r0:r1], desc_cols)
        if fp8:
            d = d.float().to(torch.float8_e4m3fn).float().round().long()
        d = torch.where(gate_mask(row_meta[:, r0:r1], col_meta), d,
                        torch.full_like(d, INF_DIST))
        key = d * M + col[None, :]          # ties to the lowest column
        bi = key.argmin(1)
        bd = d.gather(1, bi[:, None])[:, 0]
        key2 = key.scatter(1, bi[:, None], INF_DIST * M + M)
        d2 = d.scatter(1, bi[:, None], INF_DIST)
        si = torch.where(d2.amin(1) < INF_DIST, key2.argmin(1),
                         torch.zeros_like(bi))
        sd = d2.gather(1, si[:, None])[:, 0]
        for o, v in zip(outs, (bi, bd, si, sd)):
            o.append(v.int())
    return tuple(torch.cat(o) for o in outs)


def wrong_entries(got, want) -> int:
    """How many of the four outputs' entries differ."""
    return int(sum((g.long() != w.long()).sum() for g, w in zip(got, want)))
