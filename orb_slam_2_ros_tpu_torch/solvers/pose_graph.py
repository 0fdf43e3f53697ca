"""Sim(3) pose-graph (essential graph) optimisation for loop closing.

Port of ``orb_slam_2_ros_tpu/solvers/pose_graph.py``
(``Optimizer::OptimizeEssentialGraph``, ``Optimizer.cc:902-1165``): all edge
residuals ``r = log(S_meas * S_i * S_j^-1)`` and their 7x7 Jacobians
(forward-mode, batched over edges) are computed in one pass, summed into
the dense (7K x 7K) normal equations and solved through an
eigendecomposition with the eigenvalues clamped, 20 times with a tiny
damping (the reference's 1e-16 lambda is effectively Gauss-Newton).

The block sums have duplicate targets (several edges between one pair of
vertices, every edge on its endpoints' diagonal blocks); they go through
``ops/segment.segment_sum`` so that the result is the same on every run.

Conventions: vertex i stores S_i = world->keyframe_i Sim3 (q wxyz, t, s).
Edge (i, j) measures S_ji = S_j * S_i^-1; left-multiplicative local
updates S <- exp(d) * S.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import sim3
from orb_slam_2_ros_tpu_torch.ops.segment import segment_sum


def edge_residual(qi, ti, si, qj, tj, sj, rq, rt, rs):
    """r = log(S_ji_meas * (S_j * S_i^-1)^-1), (..., 7): zero when the
    current vertices reproduce the measured relative transform."""
    q_ji, t_ji, s_ji = sim3.compose(qj, tj, sj, *sim3.inverse(qi, ti, si))
    qe, te, se = sim3.compose(rq, rt, rs, *sim3.inverse(q_ji, t_ji, s_ji))
    return sim3.log(qe, te, se)


def _residual_local(d_i, d_j, qi, ti, si, qj, tj, sj, rq, rt, rs):
    """Residual after left-multiplicative perturbations exp(d) * S."""
    qi2, ti2, si2 = sim3.compose(*sim3.exp(d_i), qi, ti, si)
    qj2, tj2, sj2 = sim3.compose(*sim3.exp(d_j), qj, tj, sj)
    return edge_residual(qi2, ti2, si2, qj2, tj2, sj2, rq, rt, rs)


_edge_jacobians = torch.func.vmap(
    torch.func.jacfwd(_residual_local, argnums=(0, 1)),
    in_dims=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))


def optimize_essential_graph(q, t, s, edges_i, edges_j, rel_q, rel_t, rel_s,
                             edge_w, fixed, cfg: SlamConfig,
                             iters: int = None):
    """Batched Gauss-Newton over the Sim3 pose graph.

    q (K, 4), t (K, 3), s (K, 1): current world->KF Sim3 per vertex.
    edges_*: (E,) endpoint indices; rel_*: measured S_ji per edge; edge_w:
    (E,) weights (0 disables an edge); fixed: (K,) bool, vertices held
    constant (the loop keyframe, ``Optimizer.cc:957``).

    Returns (q, t, s, chi2s (iters,)): the optimised vertices and the
    weighted squared residual at the start of each iteration."""
    K = q.shape[0]
    dev = q.device
    f32 = torch.float32
    n_it = cfg.solver.essential_iters if iters is None else iters
    ei = edges_i.to(torch.int64)
    ej = edges_j.to(torch.int64)
    z7 = torch.zeros((7,), dtype=f32, device=dev)
    free = ~fixed
    free_f = free.to(f32)
    # flattened (row vertex, column vertex) block targets of the four sums
    blk_idx = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    vec_idx = torch.cat([ei, ej])
    diag_fix = fixed.repeat_interleave(7)

    def build_normal(qc, tc, sc):
        qi, ti, si = qc[ei], tc[ei], sc[ei]
        qj, tj, sj = qc[ej], tc[ej], sc[ej]
        r = edge_residual(qi, ti, si, qj, tj, sj, rel_q, rel_t, rel_s)
        Ji, Jj = _edge_jacobians(z7, z7, qi, ti, si, qj, tj, sj,
                                 rel_q, rel_t, rel_s)          # (E, 7, 7)
        w = edge_w[:, None, None]
        # gauge: zero out columns of fixed vertices
        Ji = Ji * w * free_f[ei][:, None, None]
        Jj = Jj * w * free_f[ej][:, None, None]
        rw = r * edge_w[:, None]

        HiTj = Ji.mT @ Jj
        blocks = torch.cat([Ji.mT @ Ji, Jj.mT @ Jj, HiTj, HiTj.mT])
        H = segment_sum(blk_idx, blocks.reshape(-1, 49), K * K)
        H = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        bvec = torch.cat([torch.einsum("eab,ea->eb", Ji, rw),
                          torch.einsum("eab,ea->eb", Jj, rw)])
        b = segment_sum(vec_idx, bvec, K).reshape(7 * K)
        return H, b, torch.sum(rw * r)

    lam = 1e-8
    chi2s = []
    for _ in range(n_it):
        H, b, chi2 = build_normal(q, t, s)
        # fixed and unconstrained rows get identity so the system stays PD
        dH = torch.diagonal(H)
        pad = diag_fix | (dH <= 0)
        H = H + torch.diag(torch.where(
            pad, torch.ones_like(dH), lam * torch.clamp(dH, min=1e-12)))
        w_e, V_e = torch.linalg.eigh(H)
        d = -(V_e @ ((V_e.T @ b) / torch.clamp(w_e, min=1e-8)))
        d = d.reshape(K, 7) * free_f[:, None]
        q, t, s = sim3.compose(*sim3.exp(d), q, t, s)
        chi2s.append(chi2)
    return q, t, s, torch.stack(chi2s)


def correct_points(mp_pos, owner_kf, q_old, t_old, s_old, q_new, t_new, s_new,
                   mp_mask):
    """Re-express map points through their owner keyframe's corrected pose:
    ``p' = S_new_i^-1 ( S_old_i (p) )`` (``LoopClosing::CorrectLoop`` point
    propagation, ``LoopClosing.cc:567-588``).

    owner_kf: (M,) keyframe id owning each point (its reference keyframe);
    *_old/_new: (K, ...) Sim3 pools; mp_mask: (M,) apply-mask."""
    o = owner_kf.to(torch.int64)
    qn, tn, sn = sim3.inverse(q_new[o], t_new[o], s_new[o])
    cam = sim3.apply(q_old[o], t_old[o], s_old[o], mp_pos)
    fixed_pos = sim3.apply(qn, tn, sn, cam)
    return torch.where(mp_mask[:, None], fixed_pos, mp_pos)
