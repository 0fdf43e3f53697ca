"""Small SPD solves for the pose LM.

Replaces ``orb_slam_2_ros_tpu/ops/linalg.py::solve_spd_unrolled``, which
unrolls a Cholesky at trace time because the TPU's solvers are slow and
approximate. Here the batched 6x6 system goes through ``torch.linalg`` in
float64, with no host synchronisation.
"""

from __future__ import annotations

import torch


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H (..., n, n), b (..., n); float64 Cholesky,
    result in b's dtype. A system that is not positive definite gives NaN,
    which the LM's finite guard rejects."""
    L, info = torch.linalg.cholesky_ex(H.to(torch.float64))
    # two triangular solves (cuBLAS trsm on the card: asynchronous)
    y = torch.linalg.solve_triangular(L, b.to(torch.float64)[..., None],
                                      upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    x = torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))
    return x.to(b.dtype)
