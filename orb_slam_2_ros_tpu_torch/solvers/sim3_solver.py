"""Sim(3) estimation for loop closing: Horn closed form + batched RANSAC.

Port of ``orb_slam_2_ros_tpu/solvers/sim3_solver.py`` (``Sim3Solver``): all
hypotheses are drawn up front and solved in one batch (one batched 4x4
eigendecomposition and one (H, N) inlier matrix, then the best by count),
followed by a Huber-robust LM refinement with forward and inverse
projection edges (``Optimizer::OptimizeSim3``).

The RANSAC draw comes from an explicit ``torch.Generator``; a caller that
must reproduce another implementation's draw hands the (H, 3) sample
indices in instead. Nothing here waits for the device.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import camera, se3
from orb_slam_2_ros_tpu_torch.geometry import sim3 as sim3_mod
from orb_slam_2_ros_tpu_torch.ops.linalg import solve_spd_clamped
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax


def horn_sim3(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor = None,
              fix_scale: bool = False):
    """Closed-form similarity from matched 3D point sets: returns (q, t, s)
    with ``x1 ~ s * R @ x2 + t`` (``ComputeSim3`` estimates T12 mapping
    camera-2 points into camera 1, ``Sim3Solver.cc:226-337``).

    x1, x2: (..., N, 3); w: optional (..., N) weights (mask). Horn 1987:
    centroids -> M = sum (x1-c1)(x2-c2)^T -> 4x4 N matrix -> eigenvector of
    the largest eigenvalue as quaternion; scale from the symmetric ratio;
    the translation closes the loop. Leading axes are a batch of problems.
    """
    if w is None:
        w = torch.ones_like(x1[..., 0])
    w = w.to(torch.float32)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c1 = torch.sum(x1 * w[..., None], dim=-2) / wsum
    c2 = torch.sum(x2 * w[..., None], dim=-2) / wsum
    r1 = (x1 - c1[..., None, :]) * w[..., None]
    r2 = x2 - c2[..., None, :]

    M = r1.mT @ r2                                        # (..., 3, 3)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]                                 # max eigenvalue
    # this N layout yields the set1->set2 rotation; we want set2->set1
    q = se3.quat_conj(q * torch.sign(q[..., :1] + 1e-12))  # wxyz, w >= 0

    if fix_scale:
        s = torch.ones_like(wsum)
    else:
        # symmetric scale: dot(r1, R r2) / |r2|^2 (Horn's closed form)
        nom = torch.sum(r1 * se3.quat_rotate(q[..., None, :], r2),
                        dim=(-2, -1))
        den = torch.sum((r2 * r2) * w[..., None], dim=(-2, -1))
        s = (nom / torch.clamp(den, min=1e-9))[..., None]
    t = c1 - s * se3.quat_rotate(q, c2)
    return q, t, s


def _sim3_inv(q, t, s):
    qi = se3.quat_conj(q)
    si = 1.0 / torch.clamp(s, min=1e-9)
    ti = -si * se3.quat_rotate(qi, t)
    return qi, ti, si


def _mutual_project(q, t, s, x1, x2, cfg: SlamConfig):
    """Forward/inverse Sim3 projection pair shared by the RANSAC scoring
    and the LM refinement: returns (x2_in1, x1_in2, p1, p2). q, t, s may
    carry leading batch axes (..., 4), (..., 3), (..., 1) against x (N, 3).
    """
    qb, tb, sb = q[..., None, :], t[..., None, :], s[..., None, :]
    x2_in1 = sb * se3.quat_rotate(qb, x2) + tb
    qi, ti, si = _sim3_inv(q, t, s)
    x1_in2 = (si[..., None, :] * se3.quat_rotate(qi[..., None, :], x1)
              + ti[..., None, :])
    p1 = camera.project(cfg.camera, x2_in1)
    p2 = camera.project(cfg.camera, x1_in2)
    return x2_in1, x1_in2, p1, p2


def ransac_sim3(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                uv1: torch.Tensor, uv2: torch.Tensor, cfg: SlamConfig,
                generator: torch.Generator = None, n_hyp: int = 256,
                fix_scale: bool = False, th2_1: float = 9.210,
                th2_2: float = 9.210, sample_idx: torch.Tensor = None):
    """RANSAC over 3-point sets with the mutual reprojection inlier check.

    x1/x2: (N, 3) matched 3D points in camera frames 1 and 2; uv1/uv2
    their observed pixels; valid: (N,) match mask. th2_* are the chi2(0.01,
    2-dof) gates of ``Sim3Solver.cc:80-84``. The (n_hyp, 3) samples are
    drawn among the valid pairs with replacement from ``generator`` (on
    the tensors' device), unless ``sample_idx`` gives them.

    Returns (q12, t12, s12, inlier_mask (N,), n_inliers). The hypothesis
    with most inliers wins, the lowest index among equal counts
    (``iterate``, ``Sim3Solver.cc:140-223``)."""
    if sample_idx is None:
        pw = valid.to(torch.float32)
        # no valid pair at all: draw uniformly (the verdict rejects on the
        # pair count; a multinomial over zeros would fault on the device)
        pw = pw + (torch.sum(pw) == 0).to(torch.float32)
        sample_idx = torch.multinomial(pw, n_hyp * 3, replacement=True,
                                       generator=generator).reshape(n_hyp, 3)
    idx = sample_idx.to(torch.int64)

    qs, ts, ss = horn_sim3(x1[idx], x2[idx], fix_scale=fix_scale)

    def count_inliers(q, t, s):
        # project x2 through S12 into camera 1 and x1 through S21 into 2
        x2_in1, x1_in2, p1, p2 = _mutual_project(q, t, s, x1, x2, cfg)
        e1 = torch.sum((p1 - uv1) ** 2, -1)
        e2 = torch.sum((p2 - uv2) ** 2, -1)
        return (valid & (e1 < th2_1) & (e2 < th2_2)
                & (x2_in1[..., 2] > 0) & (x1_in2[..., 2] > 0))

    inls = count_inliers(qs, ts, ss)                       # (H, N)
    counts = torch.sum(inls, dim=1)
    best = first_argmax(counts).reshape(1)
    q, t, s = (qs.index_select(0, best)[0], ts.index_select(0, best)[0],
               ss.index_select(0, best)[0])
    inl = inls.index_select(0, best)[0]
    # refine once on the best inlier set (closed form on all inliers)
    q2, t2, s2 = horn_sim3(x1, x2, w=inl.to(torch.float32),
                           fix_scale=fix_scale)
    inl2 = count_inliers(q2, t2, s2)
    better = torch.sum(inl2) >= torch.sum(inl)
    q = torch.where(better, q2, q)
    t = torch.where(better, t2, t)
    s = torch.where(better, s2, s)
    inl = torch.where(better, inl2, inl)
    return q, t, s, inl, torch.sum(inl, dtype=torch.int32)


def refine_sim3_lm(q, t, s, x1, x2, uv1, uv2, valid, cfg: SlamConfig,
                   fix_scale: bool = False, n_iters: int = 10,
                   huber2: float = 10.0):
    """Huber-robust Sim3 refinement with forward + inverse projection edges
    (``Optimizer::OptimizeSim3``, ``Optimizer.cc:1177-1414``): one Sim3
    vertex, per pair the projection of S12(x2) into camera 1 and of
    S12^-1(x1) into camera 2, Huber kernel, LM with accept/reject. The
    Jacobians are forward-mode through the left-multiplicative local update
    ``S <- exp(d) * S`` (d in sim3, the scale row zeroed when fix_scale).

    Gross outliers (beyond 100x the gate at the initial transform) are
    trimmed first; then, as in the reference, ``cfg.solver.sim3_iters``
    iterations over all pairs with the Huber kernel, hard removal of pairs
    with chi2 above the gate in either view, and ``n_iters`` more on the
    survivors.

    Returns (q, t, s, inlier_mask, n_inliers) with inliers by the same
    chi2 gate."""
    dev = x1.device
    f32 = torch.float32

    def residuals(d, q, t, s):
        q2, t2, s2 = sim3_mod.compose(*sim3_mod.exp(d), q, t, s)
        _, _, p1, p2 = _mutual_project(q2, t2, s2, x1, x2, cfg)
        return torch.cat([p1 - uv1, p2 - uv2], dim=-1)      # (N, 4)

    z7 = torch.zeros((7,), dtype=f32, device=dev)
    scale_mask = torch.ones((7,), dtype=f32, device=dev)
    if fix_scale:
        scale_mask[6] = 0.0
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def chi2_of(e):
        return torch.sum(e[:, :2] ** 2, -1), torch.sum(e[:, 2:] ** 2, -1)

    def robust_err(e, keep):
        c1, c2 = chi2_of(e)
        rho1 = torch.where(c1 <= huber2, c1,
                           2 * torch.sqrt(huber2 * torch.clamp(c1, min=0))
                           - huber2)
        rho2 = torch.where(c2 <= huber2, c2,
                           2 * torch.sqrt(huber2 * torch.clamp(c2, min=0))
                           - huber2)
        return torch.sum(torch.where(keep, rho1 + rho2,
                                     torch.zeros_like(rho1)))

    def system(q, t, s, mask):
        e = residuals(z7, q, t, s)
        J = torch.func.jacfwd(residuals)(z7, q, t, s)        # (N, 4, 7)
        c1, c2 = chi2_of(e)
        one = torch.ones_like(c1)
        w1 = torch.where(c1 <= huber2, one,
                         torch.sqrt(huber2 / torch.clamp(c1, min=1e-12)))
        w2 = torch.where(c2 <= huber2, one,
                         torch.sqrt(huber2 / torch.clamp(c2, min=1e-12)))
        w = torch.stack([w1, w1, w2, w2], -1) * mask[:, None]   # (N, 4)
        H = torch.einsum("nia,ni,nib->ab", J, w, J)
        b = torch.einsum("nia,ni->a", J, w * e)
        return H, b

    def lm_phase(q, t, s, keep, n):
        mask = keep.to(f32)
        lam = torch.full((), 1e-4, dtype=f32, device=dev)
        err = robust_err(residuals(z7, q, t, s), keep)
        for _ in range(n):
            H, b = system(q, t, s, mask)
            H = H * scale_mask[:, None] * scale_mask[None, :] \
                + torch.diag(1.0 - scale_mask)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            d = -torch.nan_to_num(solve_spd_clamped(Hd, b * scale_mask))
            d = d * scale_mask
            q2, t2, s2 = sim3_mod.compose(*sim3_mod.exp(d), q, t, s)
            # error-only candidate evaluation (no Jacobian)
            err_new = robust_err(residuals(z7, q2, t2, s2), keep)
            improved = err_new < err
            q = torch.where(improved, q2, q)
            t = torch.where(improved, t2, t)
            s = torch.where(improved, s2, s)
            lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                              1e-9, 1e6)
            err = torch.where(improved, err_new, err)
        return q, t, s

    c1, c2 = chi2_of(residuals(z7, q, t, s))
    trim = valid & (c1 <= 100.0 * huber2) & (c2 <= 100.0 * huber2)
    n1 = min(cfg.solver.sim3_iters, n_iters)
    q, t, s = lm_phase(q, t, s, trim, n1)
    c1, c2 = chi2_of(residuals(z7, q, t, s))
    keep = trim & (c1 <= huber2) & (c2 <= huber2)
    q, t, s = lm_phase(q, t, s, keep, n_iters)

    c1, c2 = chi2_of(residuals(z7, q, t, s))
    inl = keep & (c1 <= huber2) & (c2 <= huber2)
    return q, t, s, inl, torch.sum(inl, dtype=torch.int32)
