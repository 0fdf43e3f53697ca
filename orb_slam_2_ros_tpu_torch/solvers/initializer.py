"""Monocular two-view bootstrap: batched H/F RANSAC + reconstruction.

Port of ``orb_slam_2_ros_tpu/solvers/initializer.py`` (``Initializer.cc``):
the 200 RANSAC hypotheses of BOTH models (a homography and a fundamental
matrix from 8-point sets, ``Initializer.cc:129-140``) are solved as one
batch of small null-space problems, scored with the symmetric-transfer
truncated chi2 (``:369-559``), the model picked by RH = SH / (SH + SF)
(``:142-151``), refitted with Sampson (F) or projective-depth (H) IRLS
over its inliers, and decomposed (E from F: 4 candidates, ``:561-678``;
Faugeras' 8 solutions for H, ``:680-842``) with a cheirality vote by
batched triangulation of every match.

The null spaces and the 3x3 SVDs run in float64 (``ops/linalg.py``), the
rest in float32 as in the reference. Nothing reads the device: a
degenerate hypothesis (collinear or repeated samples) gets finite values
and loses the vote, and the maxima take the lower index among ties, as
``jnp.argmax`` does. The RANSAC sets are drawn from ``generator``, or
injected as ``sample_idx`` to reproduce another draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.geometry import triangulate as tri
from orb_slam_2_ros_tpu_torch.ops.linalg import null_vector, svd3
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax

_EPS = 1e-12
SIGMA = 1.0
TH_F = 3.841          # chi2 gate, 1 dof (Initializer.cc:472)
TH_H = 5.991          # chi2 gate, 2 dof (:404)
TH_SCORE = 5.991      # truncation for scoring both models
N_HYPOTHESES = 200


class InitResult(NamedTuple):
    ok: torch.Tensor        # () bool
    q: torch.Tensor         # (4,) world->cam2 rotation (cam1 = identity)
    t: torch.Tensor         # (3,) unit-norm translation
    points: torch.Tensor    # (N, 3) triangulated in cam1 frame
    good: torch.Tensor      # (N,) bool triangulation accepted
    used_h: torch.Tensor    # () bool which model won


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _mat3(rows) -> torch.Tensor:
    """A 3x3 matrix from nine 0-d tensors or numbers, row by row, on the
    device of the first tensor among them."""
    like = next(v for r in rows for v in r if isinstance(v, torch.Tensor))
    return torch.stack([torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                                     device=like.device)
                                     for v in r]) for r in rows])


def _normalize(pts, valid):
    """Mean/abs-dev normalization (``Initializer.cc:861-907``)."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(pts - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-6)
    zero = torch.zeros_like(s[0])
    T = _mat3([[s[0], zero, -mean[0] * s[0]],
               [zero, s[1], -mean[1] * s[1]],
               [zero, zero, zero + 1.0]])
    return (pts - mean) * s, T


def _h_rows(p1, p2):
    """The two DLT rows of each correspondence (..., n, 2) x 2 ->
    ((..., n, 9), (..., n, 9)) (``Initializer.cc:280-324``)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    return r1, r2


def _f_rows(p1, p2):
    """The epipolar row of each correspondence (``Initializer.cc:327-367``)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                        x1, y1, o], -1)


def _rank2(F):
    """F with its smallest singular value zeroed."""
    U, D, Vt = svd3(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return U @ torch.diag_embed(D) @ Vt


def _solve_h(p1, p2):
    """(..., 8, 2) x 2 -> (..., 3, 3) homography via DLT."""
    r1, r2 = _h_rows(p1, p2)
    A = torch.cat([r1, r2], dim=-2)                     # (..., 16, 9)
    return null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _solve_f(p1, p2):
    """(..., 8, 2) x 2 -> (..., 3, 3) rank-2 fundamental matrix."""
    A = _f_rows(p1, p2)
    return _rank2(null_vector(A).reshape(A.shape[:-2] + (3, 3)))


def _score_h(H, H_inv, uv1, uv2, valid):
    """Symmetric transfer score (``CheckHomography``,
    ``Initializer.cc:369-437``). H (..., 3, 3); returns ((...,), (..., N))."""
    def transfer(Hm, a, b):
        x, y = a[:, 0], a[:, 1]

        def h(i, j):
            return Hm[..., i, j, None]
        w = h(2, 0) * x + h(2, 1) * y + h(2, 2)
        iw = 1.0 / torch.where(torch.abs(w) < _EPS,
                               torch.full_like(w, _EPS), w)
        u = (h(0, 0) * x + h(0, 1) * y + h(0, 2)) * iw
        v = (h(1, 0) * x + h(1, 1) * y + h(1, 2)) * iw
        return (b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2

    inv_s2 = 1.0 / (SIGMA * SIGMA)
    c1 = transfer(H_inv, uv2, uv1) * inv_s2
    c2 = transfer(H, uv1, uv2) * inv_s2
    ok = (c1 <= TH_H) & (c2 <= TH_H) & valid
    zero = torch.zeros_like(c1)
    score = torch.sum(torch.where(valid & (c1 <= TH_H), TH_SCORE - c1, zero)
                      + torch.where(valid & (c2 <= TH_H), TH_SCORE - c2, zero),
                      dim=-1)
    return score, ok


def _score_f(F, uv1, uv2, valid):
    """Epipolar distance score (``CheckFundamental``,
    ``Initializer.cc:440-559``). F (..., 3, 3)."""
    o = torch.ones_like(uv1[:, :1])
    x1 = torch.cat([uv1, o], -1)
    x2 = torch.cat([uv2, o], -1)
    l2 = x1 @ F.mT                                  # line in image 2
    l1 = x2 @ F                                     # line in image 1
    inv_s2 = 1.0 / (SIGMA * SIGMA)
    d2 = (torch.sum(l2 * x2, -1) ** 2) / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=_EPS) * inv_s2
    d1 = (torch.sum(l1 * x1, -1) ** 2) / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=_EPS) * inv_s2
    ok = (d1 <= TH_F) & (d2 <= TH_F) & valid
    zero = torch.zeros_like(d1)
    score = torch.sum(torch.where(valid & (d2 <= TH_F), TH_SCORE - d2, zero)
                      + torch.where(valid & (d1 <= TH_F), TH_SCORE - d1, zero),
                      dim=-1)
    return score, ok


def _check_rt(R, t, uv1, uv2, valid, K):
    """Cheirality check (``CheckRT``, ``Initializer.cc:561-678``) of C
    candidates at once, R (C, 3, 3), t (C, 3): triangulate every match,
    count the points in front of both cameras with a bounded reprojection
    error and enough parallax. Returns (n_good (C,), good (C, N),
    points (C, N, 3), cos_parallax (C, N))."""
    C, N = R.shape[0], uv1.shape[0]
    q = se3.quat_from_matrix(R)
    q0, t0 = se3.identity(device=R.device)
    P1 = tri.projection_matrix(K, q0, t0).expand(C, 1, 3, 4)
    P2 = tri.projection_matrix(K, q, t)[:, None]
    X = tri.triangulate_dlt(P1, P2, uv1.expand(C, N, 2),
                            uv2.expand(C, N, 2))            # (C, N, 3)
    z1 = X[..., 2]
    Xc2 = se3.apply(q[:, None], t[:, None], X)
    z2 = Xc2[..., 2]

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pr1 = torch.stack([fx * X[..., 0] / torch.clamp(z1, min=_EPS) + cx,
                       fy * X[..., 1] / torch.clamp(z1, min=_EPS) + cy], -1)
    pr2 = torch.stack([fx * Xc2[..., 0] / torch.clamp(z2, min=_EPS) + cx,
                       fy * Xc2[..., 1] / torch.clamp(z2, min=_EPS) + cy], -1)
    e1 = torch.sum((pr1 - uv1) ** 2, -1)
    e2 = torch.sum((pr2 - uv2) ** 2, -1)

    c2 = se3.camera_center(q, t)[:, None]
    cosp = tri.parallax_cos(X, torch.zeros_like(c2), c2)
    th2 = 4.0 * SIGMA * SIGMA
    good = (valid & (z1 > 0) & (z2 > 0) & (e1 < th2) & (e2 < th2)
            & (cosp < 0.99998))
    return torch.sum(good, dim=-1, dtype=torch.int32), good, X, cosp


def draw_samples(valid: torch.Tensor, generator: torch.Generator = None,
                 n_hypotheses: int = N_HYPOTHESES) -> torch.Tensor:
    """(n_hypotheses, 8) int64 sets: per hypothesis the 8 valid matches
    with the smallest uniform keys (the reference's ``argsort(uniform)``
    draw; invalid matches sort last)."""
    r = torch.rand((n_hypotheses, valid.shape[0]), generator=generator,
                   device=valid.device)
    r = torch.where(valid, r, torch.full_like(r, 2.0))
    return torch.argsort(r, dim=-1, stable=True)[:, :8]


def _refit_f(p1n, p2n, inl, T1, T2):
    """Sampson-IRLS DLT of F over the RANSAC inliers: the algebraic fit,
    then 3 rounds with rows divided by their epipolar gradient norm."""
    rows = _f_rows(p1n, p2n)
    w0 = inl.to(torch.float32)
    Fn = null_vector(rows * w0[:, None]).reshape(3, 3)
    o = torch.ones_like(p1n[:, :1])
    h1 = torch.cat([p1n, o], -1)
    h2 = torch.cat([p2n, o], -1)
    for _ in range(3):
        Fx1 = h1 @ Fn.T
        Ftx2 = h2 @ Fn
        den = (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2
               + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)
        sw = w0 / torch.sqrt(torch.clamp(den, min=1e-12))
        Fn = null_vector(rows * sw[:, None]).reshape(3, 3)
    return T2.T @ _rank2(Fn) @ T1


def _refit_h(p1n, p2n, inl, T1, T2):
    """IRLS DLT of H: rows weighted by inverse projective depth, 2 rounds."""
    r1, r2 = _h_rows(p1n, p2n)
    x1, y1 = p1n[:, 0], p1n[:, 1]
    w0 = inl.to(torch.float32)
    Hn = null_vector(torch.cat([r1 * w0[:, None], r2 * w0[:, None]],
                               dim=0)).reshape(3, 3)
    for _ in range(2):
        wp = torch.abs(Hn[2, 0] * x1 + Hn[2, 1] * y1 + Hn[2, 2])
        sw = w0 / torch.clamp(wp, min=1e-6)
        Hn = null_vector(torch.cat([r1 * sw[:, None], r2 * sw[:, None]],
                                   dim=0)).reshape(3, 3)
    return torch.linalg.inv_ex(T2)[0] @ Hn @ T1


def _inv(M):
    """Inverse without a singularity check (a singular member gives
    non-finite values that score nothing, as in the reference)."""
    return torch.linalg.inv_ex(M)[0]


def initialize(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
               K: torch.Tensor, generator: torch.Generator = None,
               sample_idx: torch.Tensor = None,
               n_hypotheses: int = N_HYPOTHESES,
               min_triangulated: int = 50) -> InitResult:
    """Two-view reconstruction from matched undistorted pixels.

    uv1, uv2: (N, 2) matched coordinates (pairs aligned by index); valid:
    (N,) mask; K (3, 3). The 8-point sets come from ``sample_idx``
    (n_hypotheses, 8) if given, else from ``draw_samples(valid,
    generator)``. Returns the pose of camera 2 and the points in the
    camera-1 frame at the initializer's unit baseline."""
    dev = uv1.device
    n_valid = torch.sum(valid, dtype=torch.int32)
    p1n, T1 = _normalize(uv1, valid)
    p2n, T2 = _normalize(uv2, valid)

    sets = (draw_samples(valid, generator, n_hypotheses)
            if sample_idx is None else sample_idx.to(dev, torch.int64))
    a1, a2 = p1n[sets], p2n[sets]                        # (B, 8, 2)
    T2inv = _inv(T2)
    Hs = T2inv @ _solve_h(a1, a2) @ T1                   # de-normalize
    Fs = T2.T @ _solve_f(a1, a2) @ T1
    sHs, _ = _score_h(Hs, _inv(Hs), uv1, uv2, valid)
    sFs, _ = _score_f(Fs, uv1, uv2, valid)
    bh, bf = first_argmax(sHs), first_argmax(sFs)
    H_best, F_best = _pick(Hs, bh), _pick(Fs, bf)
    _, inl_h = _score_h(H_best, _inv(H_best), uv1, uv2, valid)
    _, inl_f = _score_f(F_best, uv1, uv2, valid)

    # model selection on the RANSAC (minimal-set) scores, like the
    # reference: a refit F can score deceptively well on a planar scene
    sh_b, sf_b = _pick(sHs, bh), _pick(sFs, bf)
    use_h = sh_b / torch.clamp(sh_b + sf_b, min=_EPS) > 0.40

    # three refit -> rescore rounds, each widening the inlier sets
    for _ in range(3):
        F_best = _refit_f(p1n, p2n, inl_f, T1, T2)
        H_best = _refit_h(p1n, p2n, inl_h, T1, T2)
        _, inl_h = _score_h(H_best, _inv(H_best), uv1, uv2, valid)
        _, inl_f = _score_f(F_best, uv1, uv2, valid)

    # E = K^T F K -> 4 candidates (DecomposeE, Initializer.cc:1075-1100),
    # padded to 8 with zero-baseline entries that the parallax gate zeroes
    Kinv = _inv(K)
    U, _, Vt = svd3(K.T @ F_best @ K)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], device=dev)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tE = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=_EPS)
    eye, zero3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    Rf = torch.stack([R1, R1, R2, R2, eye, eye, eye, eye])
    tf = torch.stack([tE, -tE, tE, -tE, zero3, zero3, zero3, zero3])

    # Faugeras' 8 solutions for H (ReconstructH, Initializer.cc:680-842)
    Ua, Da, Vta = svd3(Kinv @ H_best @ K)
    s = torch.linalg.det(Ua) * torch.linalg.det(Vta)
    d1, d2, d3 = Da[0], Da[1], Da[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=_EPS)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=_EPS)
    ct_p = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=_EPS)
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=_EPS)
    ct_n = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=_EPS)
    zero = torch.zeros_like(d1)
    Rh, th = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # d' > 0, then d' < 0
            for Rm, tv in (
                    (_mat3([[ct_p, zero, -e1 * e3 * aux_st],
                            [zero, zero + 1.0, zero],
                            [e1 * e3 * aux_st, zero, ct_p]]),
                     torch.stack([e1 * aux1, zero, -e3 * aux3]) * (d1 - d3)),
                    (_mat3([[ct_n, zero, e1 * e3 * aux_sp],
                            [zero, zero - 1.0, zero],
                            [e1 * e3 * aux_sp, zero, -ct_n]]),
                     torch.stack([e1 * aux1, zero, e3 * aux3]) * (d1 + d3))):
                tw = Ua @ tv
                Rh.append(s * Ua @ Rm @ Vta)
                th.append(tw / torch.clamp(torch.linalg.norm(tw), min=_EPS))
    Rs = torch.where(use_h, torch.stack(Rh), Rf)
    ts = torch.where(use_h, torch.stack(th), tf)
    inliers = torch.where(use_h, inl_h, inl_f)

    n_goods, goods, Xs, _ = _check_rt(Rs, ts, uv1, uv2, inliers, K)
    best = first_argmax(n_goods)
    n_best = _pick(n_goods, best).to(torch.float32)
    # the winner must dominate (secondBestGood < 0.75 * bestGood, :627-644)
    second = torch.sort(n_goods).values[-2].to(torch.float32)
    ok = ((n_best > min_triangulated) & (second < 0.75 * n_best)
          & (n_best > 0.5 * n_valid.to(torch.float32) * 0.5))
    return InitResult(ok=ok, q=se3.quat_from_matrix(_pick(Rs, best)),
                      t=_pick(ts, best), points=_pick(Xs, best),
                      good=_pick(goods, best), used_h=use_h)
