"""Small SPD solves for the pose LM and the triangulation.

Replaces ``orb_slam_2_ros_tpu/ops/linalg.py::solve_spd_unrolled``, which
unrolls a Cholesky at trace time because the TPU's solvers are slow and
approximate. The pose LM's 6x6 system goes through ``torch.linalg`` in
float64 (``solve_spd``: a system that is not positive definite gives NaN,
which the LM rejects). The triangulation's batched 3x3 and 4x4 systems need
the other contract, finite values on a degenerate member, and keep the
reference's clamped, unrolled Cholesky in float32 (``solve_spd_clamped``).
Neither synchronises with the host.
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


def solve_spd_clamped(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for small SPD H (..., n, n), b (..., n), in H's dtype,
    by a Cholesky factorisation unrolled over n whose pivots are clamped at
    1e-12 before the square root: a batch member that is not positive
    definite (parallel rays in a triangulation) gives large but finite
    values instead of NaN or an exception. The operations and their order
    are the reference's ``solve_spd_unrolled``."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = H[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = H[..., j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    y = [None] * n                  # forward solve L y = b
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n                  # back solve L^T x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
