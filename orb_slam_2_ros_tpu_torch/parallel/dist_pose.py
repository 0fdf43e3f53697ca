"""Pose-only LM with its edges split over a mesh axis.

Port of ``orb_slam_2_ros_tpu/parallel/dist_pose.py``: the small instance
of the distributed-BA pattern. The pose is the same on every rank; each
rank's share of the observation edges gives a partial 6x6 H, 6-vector b
and error, summed over the ``mp`` axis (``cfg.mesh.mp_axis``), and the LM
then runs identically on every rank. The edge count need not divide by
the axis size: the last edges are padded with invalid ones.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.parallel.mesh import (Mesh, all_sum,
                                                    gather_rows, pad_rows,
                                                    shard_rows)
from orb_slam_2_ros_tpu_torch.solvers import pose_opt as po

_EPS = 1e-9


def distributed_pose_optimization(mesh: Mesh, q0, t0, pts, obs_uv, obs_ur,
                                  octave, valid, cfg: SlamConfig):
    """The contract of the reference's ``distributed_pose_optimization``:
    ``pose_rounds`` rounds of ``pose_iters`` LM iterations (the Huber
    kernel in all rounds but the last, chi2 re-gating after each), without
    the single-device solver's early exit. Returns (q, t, inlier (E,) bool,
    n_inliers), the inlier mask gathered whole."""
    sc = cfg.solver
    axis = cfg.mesh.mp_axis
    n = mesh.shape[axis]
    g = mesh.group(axis)
    E = pts.shape[0]
    pts, obs_uv, obs_ur, octave, valid = (
        shard_rows(pad_rows(x, n), mesh, axis)
        for x in (pts, obs_uv, obs_ur, octave, valid))
    is_stereo = obs_ur > 0
    inv_sigma2 = torch.pow(torch.full_like(obs_ur, cfg.orb.scale_factor),
                           -2.0 * octave.to(torch.float32))
    obs = torch.cat([obs_uv, obs_ur[:, None]], dim=-1)
    delta2 = torch.where(is_stereo, torch.full_like(obs_ur, sc.huber_stereo2),
                         torch.full_like(obs_ur, sc.huber_mono2))
    delta = torch.sqrt(delta2)
    ones = torch.ones_like(obs_ur)
    comp_w = torch.stack([ones, ones, is_stereo.to(torch.float32)], dim=-1)
    eye6 = torch.eye(6, dtype=torch.float32, device=pts.device)

    def system(q, t, edge_mask, use_kernel):
        e, J, z = po._residual_jacobian(q, t, pts, obs, cfg)
        chi2 = po._edge_chi2(e, is_stereo, inv_sigma2)
        live = edge_mask & (z > _EPS)
        root = torch.sqrt(chi2)
        if use_kernel:
            w_rob = torch.where(chi2 <= delta2, ones,
                                delta / torch.clamp(root, min=_EPS))
            rho = torch.where(chi2 <= delta2, chi2,
                              2.0 * delta * root - delta2)
        else:
            w_rob, rho = ones, chi2
        w = torch.where(live, inv_sigma2 * w_rob, torch.zeros_like(chi2))
        Wc = comp_w * w[:, None]
        # this rank's partial normal equations, then their sum over the axis
        H = torch.einsum("mik,mi,mij->kj", J, Wc, J)
        b = torch.einsum("mik,mi->k", J, e * Wc)
        err = torch.sum(torch.where(live, rho, torch.zeros_like(rho)))
        return all_sum(H, g), all_sum(b, g), all_sum(err, g)

    def lm_round(q, t, edge_mask, use_kernel, n_iters):
        _, _, err = system(q, t, edge_mask, use_kernel)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=pts.device)
        for _ in range(n_iters):
            H, b, _ = system(q, t, edge_mask, use_kernel)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            xi = -torch.linalg.solve(Hd, b)
            dq, dt = se3.exp(xi)
            q_new, t_new = se3.compose(dq, dt, q, t)
            _, _, err_new = system(q_new, t_new, edge_mask, use_kernel)
            improved = err_new < err
            q = torch.where(improved, q_new, q)
            t = torch.where(improved, t_new, t)
            lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                              1e-9, 1e6)
            err = torch.where(improved, err_new, err)
        return q, t

    q, t = q0, t0
    inlier = valid
    for rnd in range(sc.pose_rounds):
        use_kernel = rnd < sc.pose_rounds - 1
        q, t = lm_round(q, t, inlier, use_kernel, sc.pose_iters)
        e, _, z = po._residual_jacobian(q, t, pts, obs, cfg)
        chi2 = po._edge_chi2(e, is_stereo, inv_sigma2)
        inlier = valid & (chi2 <= delta2) & (z > _EPS)
    n_in = all_sum(torch.sum(inlier, dtype=torch.int32), g)
    return q, t, gather_rows(inlier, g)[:E], n_in
