"""Two-view triangulation and related geometric checks, batched.

Port of ``orb_slam_2_ros_tpu/geometry/triangulate.py``
(``Initializer::Triangulate``, ``Initializer.cc:844-859``, and the gates of
``LocalMapping::CreateNewMapPoints``, ``LocalMapping.cc:366-479``):
parallax, positive depth, reprojection chi2 and scale consistency are masks
over batches of candidate pairs.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.ops.linalg import solve_spd_clamped

_EPS = 1e-9


def _unit(v: torch.Tensor, floor: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=floor)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. P1, P2: (..., 3, 4) projection matrices (K [R|t] or
    normalized [R|t]); xy1, xy2: (..., 2) measurements in the same frame as
    P.

    The original takes the smallest right-singular vector of the 4x4 DLT
    system. The reference's algorithm is kept, because the plain w=1
    solution degrades the points enough to flip a loop-closure accept:
    inverse iteration on the 4x4 Gram matrix A^T A with clamped Cholesky
    solves, seeded from the closed-form w=1 (inhomogeneous) solution; the
    null direction sits orders of magnitude below the next eigenvalue, so
    two damped solves reach the accuracy of the SVD.

    Returns (..., 3) world points, free of NaN: a degenerate system
    (parallel rays) gives large but finite values.
    """
    rows = [
        xy1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        xy1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        xy2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        xy2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = torch.cat(rows, dim=-2)                         # (..., 4, 4)
    # row-normalize to keep the f32 system well conditioned
    A = _unit(A, _EPS)
    G = A.mT @ A                                        # (..., 4, 4)
    # seed: inhomogeneous (w=1) closed-form solution [x, 1]
    x0 = solve_spd_clamped(G[..., :3, :3], -G[..., :3, 3])
    v = _unit(torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1), _EPS)
    # damped inverse iteration toward the smallest eigenvector of G
    trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    H = G + (1e-5 * trace)[..., None, None] * torch.eye(
        4, dtype=G.dtype, device=G.device)
    for _ in range(2):
        v = _unit(solve_spd_clamped(H, v), 1e-20)
    w = v[..., 3:4]
    # |w| < 1e-9 is a point at infinity. The reference divides by
    # sign(w) * 1e-9 + 1e-9 there, which is 0 for a tiny negative w; the
    # port divides by -1e-9 in that one case, so the result stays finite
    tiny = torch.where(w < 0, torch.full_like(w, -_EPS),
                       torch.sign(w) * _EPS + _EPS)
    return v[..., :3] / torch.where(torch.abs(w) < _EPS, tiny, w)


def projection_matrix(K: torch.Tensor, q: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """K @ [R | t] for world-to-camera (q, t); shapes broadcast."""
    Rt = torch.cat([se3.quat_to_matrix(q), t[..., :, None]], dim=-1)
    return K @ Rt


def parallax_cos(x_w: torch.Tensor, c1: torch.Tensor,
                 c2: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray parallax angle at world point x_w seen from camera
    centers c1, c2 (``LocalMapping.cc:302-313``)."""
    r1 = x_w - c1
    r2 = x_w - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=_EPS)


def depth_in_camera(q: torch.Tensor, t: torch.Tensor,
                    x_w: torch.Tensor) -> torch.Tensor:
    """z-coordinate of world points in camera (q, t)."""
    return se3.apply(q, t, x_w)[..., 2]
