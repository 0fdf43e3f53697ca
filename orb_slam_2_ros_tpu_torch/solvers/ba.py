"""Bundle adjustment: masked LM with a dense Schur complement.

Port of ``orb_slam_2_ros_tpu/solvers/ba.py::windowed_bundle_adjustment``,
the local-mapping workhorse (``Optimizer::LocalBundleAdjustment``,
``Optimizer.cc:517-890``), and of its chunked dense global BA
(``dense_gba_init`` / ``dense_gba_chunk``, the post-loop
``RunGlobalBundleAdjustment``), for one device. Each LM step eliminates the 3x3
landmark blocks in closed form and solves the reduced camera system
S = Hcc - Hcp Hpp^-1 Hpc of the W free cameras as one dense (6W x 6W)
system. Fixed cameras still constrain landmarks through the point-side
normal equations.

Kept from the original: Huber kernel (delta^2 = 5.991 mono / 7.815 stereo),
per-octave invSigma2 weighting, two phases (5 iterations with the kernel ->
chi2 outlier pruning -> 10 without, ``Optimizer.cc:760-813``), gauge fixed
by the cameras outside the window.

The landmark-side sums (gradient, Hpp, the camera-landmark cross blocks)
are segment sums of per-edge blocks over a compact axis of at most
``cfg.solver.local_ba_max_points`` free landmarks (``ops/segment.py``:
the same result on every run).

``bundle_adjustment`` is the reference's general edge-list LM with a
matrix-free CG solve of the reduced camera system
(``build_problem``, ``_edge_terms``, ``_weights``, ``_make_lm_step``,
without ``axis_name``): the monocular initializer runs it with both
cameras fixed. Its edge sums are segment sums too. The chunked edge-list
global BA (``gba_init``, ``gba_chunk``) and the sharded variants are not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.ops.segment import segment_sum

_EPS = 1e-9


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det). A determinant
    below 1e-12 in magnitude is replaced by 1e-12, so a singular block
    (an unfilled landmark slot) gives finite values where a batched
    ``torch.linalg.inv`` raises."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co10, co11, co12], -1),
        torch.stack([co20, co21, co22], -1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class BAProblem(NamedTuple):
    """Static-shape BA instance. E edges reference C cameras and M points."""

    cam_idx: torch.Tensor    # (E,) int64 -> camera slot
    mp_idx: torch.Tensor     # (E,) int64 -> point slot
    obs: torch.Tensor        # (E, 3) (u, v, uR); uR masked for mono edges
    is_stereo: torch.Tensor  # (E,) bool
    inv_sigma2: torch.Tensor  # (E,) float32
    valid: torch.Tensor      # (E,) bool


def build_problem(kf_uv, kf_ur, kf_octave, kf_mp, kf_kp_valid,
                  cfg: SlamConfig) -> BAProblem:
    """Edges from C rows of the observation table ((C, P) slices of the
    MapState keyframe pools), one per (row, keypoint)."""
    C, P = kf_mp.shape
    dev = kf_mp.device
    mp_idx = kf_mp.reshape(-1)
    ur = kf_ur.reshape(-1)
    octv = kf_octave.reshape(-1).to(torch.float32)
    return BAProblem(
        cam_idx=torch.arange(C, device=dev).repeat_interleave(P),
        mp_idx=torch.clamp(mp_idx, min=0).to(torch.int64),
        obs=torch.cat([kf_uv.reshape(-1, 2), ur[:, None]], dim=-1),
        is_stereo=ur > 0,
        inv_sigma2=torch.pow(torch.full_like(octv, cfg.orb.scale_factor),
                             -2.0 * octv),
        valid=(mp_idx >= 0) & kf_kp_valid.reshape(-1))


def _edge_terms(prob: BAProblem, q, t, pos, cfg: SlamConfig):
    """Residuals e (E, 3), camera Jacobians Jc (E, 3, 6), point Jacobians
    Jp (E, 3, 3), depth z (E,): left-multiplied exp(xi) * T camera update,
    additive world-frame point update (g2o's EdgeSE3ProjectXYZ /
    EdgeStereoSE3ProjectXYZ)."""
    cam = cfg.camera
    qc = q[prob.cam_idx]
    xc = se3.apply(qc, t[prob.cam_idx], pos[prob.mp_idx])
    x, y = xc[:, 0], xc[:, 1]
    z = torch.clamp(xc[:, 2], min=_EPS)
    iz = 1.0 / z
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    e = torch.stack([u, v, u - cam.bf * iz], dim=-1) - prob.obs
    zeros = torch.zeros_like(z)
    du = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], -1)
    dv = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * iz2], -1)
    dpred = torch.stack([du, dv, dur], dim=1)               # (E, 3, 3)
    nskew = torch.stack([
        torch.stack([zeros, xc[:, 2], -xc[:, 1]], -1),
        torch.stack([-xc[:, 2], zeros, xc[:, 0]], -1),
        torch.stack([xc[:, 1], -xc[:, 0], zeros], -1),
    ], dim=1)                                               # -[xc]x
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand_as(nskew)
    Jc = dpred @ torch.cat([eye, nskew], dim=-1)            # (E, 3, 6)
    Jp = dpred @ se3.quat_to_matrix(qc)                     # (E, 3, 3)
    return e, Jc, Jp, z


def _weights(prob: BAProblem, e, z, edge_mask, cfg: SlamConfig,
             use_kernel: bool):
    """Per-edge-component weights W (E, 3) = invSigma2 * huber * component
    mask, and the robust total error."""
    sc = cfg.solver
    delta2 = torch.where(prob.is_stereo, sc.huber_stereo2, sc.huber_mono2)
    ones = torch.ones_like(z)
    comp_w = torch.stack([ones, ones, prob.is_stereo.to(z.dtype)], -1)
    chi2 = torch.sum(e * e * comp_w, dim=-1) * prob.inv_sigma2
    if use_kernel:
        delta = torch.sqrt(delta2)
        sq = torch.sqrt(chi2)
        w_rob = torch.where(chi2 <= delta2, ones,
                            delta / torch.clamp(sq, min=_EPS))
        rho = torch.where(chi2 <= delta2, chi2, 2 * delta * sq - delta2)
    else:
        w_rob, rho = ones, chi2
    ok = edge_mask & (z > _EPS)
    w = torch.where(ok, prob.inv_sigma2 * w_rob, torch.zeros_like(z))
    err = torch.sum(torch.where(ok, rho, torch.zeros_like(rho)))
    return w[:, None] * comp_w, err


def _make_lm_step(prob: BAProblem, cfg: SlamConfig, cam_free, mp_free,
                  cg_iters: int):
    """One damped LM iteration of the Schur-complement BA, with the reduced
    camera system solved by preconditioned CG, every S-product evaluated
    edge-wise (gather -> 3x6/3x3 products -> segment sum). ``cam_free``
    None means every camera fixed: the CG's answer is then exactly zero
    (its right-hand side and every product are masked to zero), so it is
    not run, and neither are the camera-side sums."""
    ci, pi = prob.cam_idx, prob.mp_idx
    M = mp_free.shape[0]
    mpf = mp_free.to(torch.float32)[:, None]                # (M, 1)
    eye3 = torch.eye(3, device=mpf.device)
    if cam_free is not None:
        C = cam_free.shape[0]
        camf = cam_free.to(torch.float32)[:, None]          # (C, 1)
        eye6 = torch.eye(6, device=mpf.device)

    def cam_sum(vals):
        return segment_sum(ci, vals, C)

    def pt_sum(vals):
        return segment_sum(pi, vals, M)

    def lm_step(q, t, pos, edge_mask, use_kernel, lam, err):
        e, Jc, Jp, z = _edge_terms(prob, q, t, pos, cfg)
        W, _ = _weights(prob, e, z, edge_mask, cfg, use_kernel)
        We = W * e
        JpT = Jp.mT
        bp = -pt_sum((JpT @ We[..., None])[..., 0]) * mpf
        Hpp = pt_sum(JpT @ (W[..., None] * Jp))             # (M, 3, 3)
        Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1)
                       + 1e-8)[..., None] * eye3
        # fixed points: a zero inverse takes them out of the Schur term
        Hpp_inv = _inv3x3(Hpp_d) * mpf[..., None]

        if cam_free is None:
            xc = None
            xp = (Hpp_inv @ bp[..., None])[..., 0]
        else:
            JcT = Jc.mT
            bc = -cam_sum((JcT @ We[..., None])[..., 0]) * camf
            Hcc_d = cam_sum(JcT @ (W[..., None] * Jc))      # (C, 6, 6)
            dampC = lam * torch.diagonal(Hcc_d, dim1=-2, dim2=-1) + 1e-8

            def Hpc_mv(x):
                jx = (Jc @ (x * camf)[ci][..., None])[..., 0]
                return pt_sum((JpT @ (W * jx)[..., None])[..., 0])

            def Hcp_mv(x):
                jx = (Jp @ (x * mpf)[pi][..., None])[..., 0]
                return cam_sum((JcT @ (W * jx)[..., None])[..., 0]) * camf

            def Hcc_mv(x):
                jx = (Jc @ (x * camf)[ci][..., None])[..., 0]
                y = cam_sum((JcT @ (W * jx)[..., None])[..., 0])
                return y * camf + dampC * x * camf

            def S_mv(x):
                tp = (Hpp_inv @ Hpc_mv(x)[..., None])[..., 0]
                return Hcc_mv(x) - Hcp_mv(tp)

            bc_red = (bc - Hcp_mv((Hpp_inv @ bp[..., None])[..., 0])) * camf
            # block-Jacobi preconditioner: damped Hcc blocks of the free
            # cameras, identity rows for the fixed ones
            Pmat = ((Hcc_d + torch.diag_embed(dampC)) * camf[..., None]
                    + eye6 * (1.0 - camf[..., None]) + eye6 * 1e-6)
            P_inv = torch.linalg.inv_ex(Pmat)[0]

            def precond(r):
                return (P_inv @ r[..., None])[..., 0] * camf

            x = torch.zeros_like(bc_red)
            r = bc_red
            p = precond(r)
            rz = torch.sum(r * p)
            for _ in range(cg_iters):
                Ap = S_mv(p)
                alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
                x = x + alpha * p
                r = r - alpha * Ap
                zz = precond(r)
                rz_new = torch.sum(r * zz)
                p = zz + rz_new / torch.clamp(rz, min=1e-20) * p
                rz = rz_new
            # the f32 Schur system can make CG diverge at tiny damping:
            # sanitize, then trust-region each camera's step, so that the
            # error comparison below decides
            xc = _finite(x)
            nrm = torch.linalg.norm(xc, dim=-1, keepdim=True)
            xc = xc * torch.clamp(10.0 / torch.clamp(nrm, min=1e-20),
                                  max=1.0)
            xp = (Hpp_inv @ (bp - Hpc_mv(xc))[..., None])[..., 0]

        if xc is None:
            q_new, t_new = q, t
        else:
            dq, dt = se3.exp(xc)
            q_new, t_new = se3.compose(dq, dt, q, t)
            q_new = torch.where(cam_free[:, None], q_new, q)
            t_new = torch.where(cam_free[:, None], t_new, t)
        pos_new = torch.where(mp_free[:, None], pos + xp, pos)
        e2, _, _, z2 = _edge_terms(prob, q_new, t_new, pos_new, cfg)
        _, err_new = _weights(prob, e2, z2, edge_mask, cfg, use_kernel)
        improved = err_new < err
        q = torch.where(improved, q_new, q)
        t = torch.where(improved, t_new, t)
        pos = torch.where(improved, pos_new, pos)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                          1e-10, 1e8)
        err = torch.where(improved, err_new, err)
        return q, t, pos, lam, err

    return lm_step


def bundle_adjustment(q, t, cam_free, pos, mp_free, prob: BAProblem,
                      cfg: SlamConfig, phases=(5, 10), cg_iters: int = 100,
                      robust: bool = True):
    """Schur-LM bundle adjustment over an edge list.

    q (C, 4), t (C, 3): world->camera poses; cam_free (C,) bool (False =
    gauge-fixed), or None when every camera is fixed (the CG is skipped,
    with the same result); pos (M, 3) points; mp_free (M,) bool. phases:
    LM iteration counts with chi2 edge pruning between phases; the Huber
    kernel in the first phase only (when ``robust``). Every iteration is
    predicated on the device: nothing is read on the host.

    Returns (q, t, pos, edge_inlier (E,) bool)."""
    sc = cfg.solver
    delta2 = torch.where(prob.is_stereo, sc.huber_stereo2, sc.huber_mono2)
    lm_step = _make_lm_step(prob, cfg, cam_free, mp_free, cg_iters)
    edge_mask = prob.valid
    for i, n_iters in enumerate(phases):
        use_kernel = robust and i == 0
        e, _, _, z = _edge_terms(prob, q, t, pos, cfg)
        _, err = _weights(prob, e, z, edge_mask, cfg, use_kernel)
        lam = torch.full_like(err, 1e-4)
        for _ in range(n_iters):
            q, t, pos, lam, err = lm_step(q, t, pos, edge_mask, use_kernel,
                                          lam, err)
        # chi2 pruning between phases (Optimizer.cc:781-812)
        e, _, _, z = _edge_terms(prob, q, t, pos, cfg)
        ones = torch.ones_like(z)
        comp_w = torch.stack([ones, ones, prob.is_stereo.to(z.dtype)], -1)
        chi2 = torch.sum(e * e * comp_w, -1) * prob.inv_sigma2
        edge_mask = prob.valid & (chi2 <= delta2) & (z > _EPS)
    return q, t, pos, edge_mask


def windowed_bundle_adjustment(kf_q, kf_t, window_rows, kf_uv, kf_ur,
                               kf_octave, kf_mp, kp_valid, mp_pos, mp_free,
                               cfg: SlamConfig, phases=(5, 10), stats=None):
    """Local BA with an explicitly materialized reduced camera system.

    kf_q (K, 4), kf_t (K, 3): the poses of the K rows of the observation
    table; window_rows (W,) int32 rows that are free (-1 padding);
    kf_uv/kf_ur/kf_octave/kf_mp/kp_valid: the (K, P) observation table;
    mp_pos (M, 3); mp_free (M,) bool.

    The free landmarks are compacted to a dense axis of MW =
    ``cfg.solver.local_ba_max_points`` slots. When the free set overflows
    MW the newest pool rows stay free (the window's freshly spawned
    landmarks, which need refinement most) and the oldest are frozen for
    the step.

    Each phase leaves its loop as soon as the step is tiny, the error
    stalls or the damping has blown up; that test is read on the host once
    per iteration. ``stats``, if a dict, receives ``iters`` (iterations
    used per phase) and ``cost`` (per phase, the cost at its start and at
    its end, as the LM tracks it).

    Returns (kf_q, kf_t, mp_pos, edge_inlier (K, P) bool, edge_loose (K, P)
    bool, n_free_total () int32)."""
    K, P = kf_mp.shape
    M = mp_pos.shape[0]
    Wn = window_rows.shape[0]
    sc = cfg.solver
    cam = cfg.camera
    MW = min(sc.local_ba_max_points, M)
    dev = kf_q.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    win_valid = window_rows >= 0
    # local window index per keyframe row (-1 = fixed): the first window
    # slot that names the row, taken as a minimum so that no tie order of
    # an argmax enters
    eq = (window_rows[None, :] == torch.arange(K, dtype=i32, device=dev)[:, None]) \
        & win_valid[None, :]
    slots_w = torch.arange(Wn, dtype=i32, device=dev)
    first = torch.min(torch.where(eq, slots_w, torch.full_like(slots_w, Wn)),
                      dim=1).values
    loc = torch.where(first < Wn, first, torch.full_like(first, -1))
    row_free = (loc >= 0)[:, None]                              # (K, 1)
    cam_on = row_free.to(f32)[..., None]                        # (K, 1, 1)
    tgt_w = torch.where(loc >= 0, loc, torch.full_like(loc, Wn)).to(i64)

    mp_idx = torch.clamp(kf_mp, min=0).to(i64)
    edge_valid0 = kp_valid & (kf_mp >= 0)
    obs = torch.cat([kf_uv, kf_ur[..., None]], dim=-1)          # (K, P, 3)
    is_stereo = kf_ur > 0
    inv_sigma2 = torch.pow(torch.full_like(kf_ur, cfg.orb.scale_factor),
                           -2.0 * kf_octave.to(f32))
    delta2 = torch.where(is_stereo, torch.full_like(kf_ur, sc.huber_stereo2),
                         torch.full_like(kf_ur, sc.huber_mono2))
    delta = torch.sqrt(delta2)
    ones = torch.ones_like(kf_ur)
    comp_w0 = torch.stack([ones, ones, is_stereo.to(f32)], -1)  # (K, P, 3)

    # ---- compact free-landmark table: free pool row -> [0, MW) slot,
    # newest rows first when the free set overflows
    rank_from_end = torch.flip(torch.cumsum(
        torch.flip(mp_free, [0]).to(i32), 0, dtype=i32), [0]) - 1
    in_compact = mp_free & (rank_from_end < MW)
    slot_asc = torch.cumsum(in_compact.to(i32), 0, dtype=i32) - 1
    cid_of_mp = torch.where(in_compact, slot_asc,
                            torch.full_like(slot_asc, MW)).to(i64)  # (M,)
    # compacted rows land on distinct slots; the rest go to the spare one
    free_ids = torch.zeros((MW + 1,), dtype=i64, device=dev).index_put(
        (cid_of_mp,), torch.arange(M, dtype=i64, device=dev))[:MW]
    n_free = torch.sum(in_compact, dtype=i32)
    cmask = torch.arange(MW, device=dev) < n_free               # filled slots
    cmask_f = cmask.to(f32)[:, None]
    edge_cid = cid_of_mp[mp_idx]                                # (K, P)
    edge_free = edge_cid < MW
    edge_cid_c = torch.clamp(edge_cid, max=MW - 1)
    pw_fix = mp_pos[mp_idx]            # (K, P, 3) frozen non-free positions
    cpos0 = mp_pos[free_ids] * cmask_f

    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def edge_terms(q, t, cpos, jacobians=True):
        """Residuals (and Jacobians) over the (K, P) table; cameras
        broadcast per row, free-landmark positions come from the compact
        table, fixed ones from the frozen snapshot."""
        pw = torch.where(edge_free[..., None], cpos[edge_cid_c], pw_fix)
        xc = se3.apply(q[:, None, :], t[:, None, :], pw)
        x, y = xc[..., 0], xc[..., 1]
        z = torch.clamp(xc[..., 2], min=_EPS)
        iz = 1.0 / z
        u = cam.fx * x * iz + cam.cx
        v = cam.fy * y * iz + cam.cy
        ur = u - cam.bf * iz
        e = torch.stack([u, v, ur], dim=-1) - obs
        if not jacobians:
            return e, None, None, z
        iz2 = iz * iz
        zeros = torch.zeros_like(z)
        du = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], -1)
        dv = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], -1)
        dur = du + torch.stack([zeros, zeros, cam.bf * iz2], -1)
        dpred = torch.stack([du, dv, dur], dim=-2)           # (K, P, 3, 3)
        nskew = torch.stack([
            torch.stack([zeros, xc[..., 2], -xc[..., 1]], -1),
            torch.stack([-xc[..., 2], zeros, xc[..., 0]], -1),
            torch.stack([xc[..., 1], -xc[..., 0], zeros], -1),
        ], dim=-2)
        dxc = torch.cat([eye3.expand_as(nskew), nskew], dim=-1)  # (K,P,3,6)
        Jc = dpred @ dxc
        R = se3.quat_to_matrix(q)                            # (K, 3, 3)
        Jp = dpred @ R[:, None]
        return e, Jc, Jp, z

    def chi2_of(e):
        return torch.sum(e * e * comp_w0, dim=-1) * inv_sigma2

    def weights(e, z, edge_mask, use_kernel):
        chi2 = chi2_of(e)
        if use_kernel:
            root = torch.sqrt(chi2)
            inside = chi2 <= delta2
            w_rob = torch.where(inside, ones,
                                delta / torch.clamp(root, min=_EPS))
            rho = torch.where(inside, chi2, 2 * delta * root - delta2)
        else:
            w_rob = ones
            rho = chi2
        ok = edge_mask & (z > _EPS)
        # edge_w: bounded-influence entry weight of fixed-row edges (set
        # once per call, below); cost and gradient stay consistent
        w = torch.where(ok, inv_sigma2 * w_rob, torch.zeros_like(chi2)) * edge_w
        err = torch.sum(torch.where(ok, rho * edge_w, torch.zeros_like(rho)))
        return w[..., None] * comp_w0, err

    def cost(q, t, cpos, edge_mask, use_kernel):
        e, _, _, z = edge_terms(q, t, cpos, jacobians=False)
        return weights(e, z, edge_mask, use_kernel)[1]

    def lm_step(q, t, cpos, edge_mask, use_kernel, lam, err):
        e, Jc, Jp, z = edge_terms(q, t, cpos)
        Wt, _ = weights(e, z, edge_mask, use_kernel)         # (K, P, 3)
        Wc = Wt * cam_on                                     # cam-side weights
        We = Wt * e

        # camera side: per-row reductions placed into the window arrays
        # (loc is injective over window slots)
        gc_k = torch.einsum("kpin,kpi->kn", Jc, We * cam_on)  # (K, 6)
        JcW = Jc * Wc[..., None]                              # (K, P, 3, 6)
        Hcc_k = torch.einsum("kpin,kpim->knm", JcW, Jc)       # (K, 6, 6)
        gc = torch.zeros((Wn + 1, 6), dtype=f32, device=dev).index_add(
            0, tgt_w, gc_k)[:Wn]
        Hcc = torch.zeros((Wn + 1, 6, 6), dtype=f32, device=dev).index_add(
            0, tgt_w, Hcc_k)[:Wn]

        # point side: segment sums of the per-edge (12,) and (18,) blocks
        # over the compact landmark axis. Edges whose landmark is fixed,
        # invalid or masked out go to a spare row.
        JpW = Jp * Wt[..., None]                              # (K, P, 3, 3)
        pv = torch.cat([
            torch.einsum("kpin,kpi->kpn", Jp, We),
            (JpW.mT @ Jp).reshape(K, P, 9)], dim=-1)          # (K, P, 12)
        Bv = (JcW.mT @ Jp).reshape(K, P, 18)                  # (K, P, 6*3)
        cid_masked = torch.where(edge_mask, edge_cid,
                                 torch.full_like(edge_cid, MW))
        acc_p = segment_sum(cid_masked.reshape(-1), pv.reshape(-1, 12),
                            MW + 1)[:MW]
        t_idx = torch.where((cid_masked < MW) & row_free,
                            cid_masked * Wn + tgt_w[:, None],
                            torch.full_like(cid_masked, MW * Wn))
        acc_t = segment_sum(t_idx.reshape(-1), Bv.reshape(-1, 18),
                            MW * Wn + 1)[:MW * Wn]
        gp = acc_p[:, :3]                                     # (MW, 3)
        Hpp = acc_p[:, 3:].reshape(MW, 3, 3)
        T = acc_t.reshape(MW, Wn, 6, 3)

        # damped landmark inverses (unfilled slots excluded from Schur)
        diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_d = Hpp + (lam * diag_p + 1e-8)[..., None] * eye3
        Hpp_inv = _inv3x3(Hpp_d) * cmask_f[..., None]

        bp = -gp
        bc = -gc
        TH = torch.einsum("manj,mjk->mank", T, Hpp_inv)       # (MW, Wn, 6, 3)
        S_cross = torch.einsum("mank,mblk->anbl", TH, T)
        dampC = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8
        S = -S_cross
        w_all = torch.arange(Wn, device=dev)
        S[w_all, :, w_all, :] += Hcc + dampC[..., None] * eye6
        bc_red = bc - torch.einsum("mank,mk->an", TH, bp)

        # pad unused window slots with identity rows. LU solve, not
        # Cholesky: the explicitly formed Schur complement can go slightly
        # indefinite under f32 cancellation; a NaN step is sanitized and
        # then rejected by the accept test, whose growing damping restores
        # definiteness on the retry
        pad = (~win_valid).to(f32).repeat_interleave(6)
        Sm = S.reshape(6 * Wn, 6 * Wn) + torch.diag(pad)
        bvec = (bc_red * win_valid[:, None]).reshape(-1)
        xc = _finite(torch.linalg.solve(Sm, bvec)).reshape(Wn, 6)
        xc = xc * win_valid[:, None]

        # back-substitute landmarks: xp = Hpp_inv (bp - T^T xc)
        tx = torch.einsum("mwnj,wn->mj", T, xc)
        xp = _finite(torch.einsum("mjk,mk->mj", Hpp_inv, bp - tx))

        # candidate update: each row composes its own window slot's step
        dq, dt = se3.exp(xc)
        l0 = torch.clamp(loc, min=0).to(i64)
        qi_new, ti_new = se3.compose(dq[l0], dt[l0], q, t)
        q_new = torch.where(row_free, qi_new, q)
        t_new = torch.where(row_free, ti_new, t)
        cpos_new = cpos + xp * cmask_f

        err_new = cost(q_new, t_new, cpos_new, edge_mask, use_kernel)
        improved = err_new < err
        q = torch.where(improved, q_new, q)
        t = torch.where(improved, t_new, t)
        cpos = torch.where(improved, cpos_new, cpos)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                          1e-10, 1e8)
        # convergence exit: a tiny camera step, a stalled error or
        # blown-up damping all mean further iterations buy nothing
        done = ((torch.sum(xc * xc) < 1e-8)
                | (improved & (err - err_new < 1e-5 * err))
                | (~improved & (lam > 1e4)))
        err = torch.where(improved, err_new, err)
        return q, t, cpos, lam, err, done

    def lm_phase(q, t, cpos, edge_mask, use_kernel, n_iters):
        err0 = cost(q, t, cpos, edge_mask, use_kernel)
        err = err0
        lam = torch.full((), 1e-4, dtype=f32, device=dev)
        used = 0
        for _ in range(n_iters):
            q, t, cpos, lam, err, done = lm_step(q, t, cpos, edge_mask,
                                                 use_kernel, lam, err)
            used += 1
            if bool(done):          # one host read per iteration
                break
        return q, t, cpos, used, (err0, err)

    q, t, cpos = kf_q, kf_t, cpos0
    # Fixed rows' edges enter the cost with a bounded-influence weight from
    # their entry residual: their poses are not optimized this step, so
    # gross stale observations would otherwise drag the free window every
    # step, while cutting them outright removes the gauge anchor whenever
    # the entry state is far from converged. Edges within 3 sigma keep
    # weight 1; beyond that the weight decays as 9*delta^2/chi2, a constant
    # per step. The association itself is not pruned here.
    e0, _, _, _ = edge_terms(q, t, cpos, jacobians=False)
    chi2_0 = chi2_of(e0)
    edge_w = torch.where(row_free | (chi2_0 <= 9.0 * delta2), ones,
                         (9.0 * delta2) / torch.clamp(chi2_0, min=1e-9))
    edge_mask = edge_valid0
    iters, costs = [], []
    for i, n_iters in enumerate(phases):
        q, t, cpos, used, c = lm_phase(q, t, cpos, edge_mask, i == 0, n_iters)
        iters.append(used)
        costs.append(c)
        e, _, _, z = edge_terms(q, t, cpos, jacobians=False)
        chi2 = chi2_of(e)
        edge_mask = edge_valid0 & (chi2 <= delta2) & (z > _EPS)
    # the 3-sigma variant of the final gate, for callers that prune
    # fixed-row edges less strictly
    edge_loose = edge_valid0 & (chi2 <= 9.0 * delta2) & (z > _EPS)
    # write the optimized free landmarks back into the full pool
    back = torch.where(cmask, free_ids, torch.full_like(free_ids, M))
    pos = torch.cat([mp_pos, torch.zeros_like(mp_pos[:1])]).index_put(
        (back,), cpos)[:M]
    if stats is not None:
        stats["iters"] = tuple(iters)
        stats["cost"] = tuple((float(a), float(b)) for a, b in costs)
    # the total free count lets callers see an overflow of the compact
    # axis: above MW the landmarks ranked past the cap stayed frozen
    return q, t, pos, edge_mask, edge_loose, torch.sum(mp_free, dtype=i32)


# --------------------------------------------------------------------------
# Dense chunked global BA: the background refinement after a loop closure.
# --------------------------------------------------------------------------

class DenseGBAState(NamedTuple):
    """Table-layout GBA snapshot. ``loop_*``: measured loop-edge relative
    SE3s entering the camera system as priors (see ``_loop_prior_terms``);
    all-zero weights when the caller has no seams."""

    q: torch.Tensor          # (K, 4)
    t: torch.Tensor          # (K, 3)
    pos: torch.Tensor        # (M, 3)
    lam: torch.Tensor        # ()
    err: torch.Tensor        # ()
    kf_uv: torch.Tensor      # (K, P, 2) snapshot observations
    kf_ur: torch.Tensor      # (K, P)
    inv_sigma2: torch.Tensor  # (K, P)
    kf_mp: torch.Tensor      # (K, P) int32
    edge_valid: torch.Tensor  # (K, P) bool
    cam_free: torch.Tensor   # (K,) bool
    mp_free: torch.Tensor    # (M,) bool
    n0: torch.Tensor         # () int32 keyframes at snapshot time
    nm0: torch.Tensor        # () int32 map points at snapshot time
    loop_i: torch.Tensor     # (L,) int32 keyframe c of each seam
    loop_j: torch.Tensor     # (L,) int32 keyframe k
    loop_q: torch.Tensor     # (L, 4) measured T_kc rotation (SE3 part)
    loop_t: torch.Tensor     # (L, 3) measured translation (already /s)
    loop_w: torch.Tensor     # (L,) float32 prior weight (0 = unused slot)


def dense_gba_init(kf_uv, kf_ur, kf_octave, kf_mp, kp_valid, kf_q, kf_t,
                   cam_free, mp_pos, mp_free, n_kfs, n_mps, cfg: SlamConfig,
                   loop_i=None, loop_j=None, loop_q=None, loop_t=None,
                   loop_w=None, n_loop_slots: int = 16) -> DenseGBAState:
    """Snapshot the map's (K, P) observation table for the dense GBA and
    evaluate the starting error. Every valid keyframe's edges constrain the
    landmarks, whether its camera is free or fixed (callers pass kp_valid
    already masked by kf_valid)."""
    dev = kf_q.device
    f32, i32 = torch.float32, torch.int32
    inv_sigma2 = torch.pow(torch.full_like(kf_ur, cfg.orb.scale_factor),
                           -2.0 * kf_octave.to(f32))
    edge_valid = kp_valid & (kf_mp >= 0)
    if loop_i is None:
        L = n_loop_slots
        loop_i = torch.zeros((L,), dtype=i32, device=dev)
        loop_j = torch.zeros((L,), dtype=i32, device=dev)
        loop_q = se3.quat_identity((L,), dev)
        loop_t = torch.zeros((L, 3), dtype=f32, device=dev)
        loop_w = torch.zeros((L,), dtype=f32, device=dev)
    st = DenseGBAState(
        q=kf_q, t=kf_t, pos=mp_pos,
        lam=torch.full((), 1e-4, dtype=f32, device=dev),
        err=torch.full((), float("inf"), dtype=f32, device=dev),
        kf_uv=kf_uv, kf_ur=kf_ur, inv_sigma2=inv_sigma2, kf_mp=kf_mp,
        edge_valid=edge_valid, cam_free=cam_free, mp_free=mp_free,
        n0=torch.as_tensor(n_kfs, dtype=i32, device=dev),
        nm0=torch.as_tensor(n_mps, dtype=i32, device=dev),
        loop_i=loop_i, loop_j=loop_j, loop_q=loop_q, loop_t=loop_t,
        loop_w=loop_w.to(f32))
    return st._replace(err=_dense_gba_error(st, st.q, st.t, st.pos, cfg))


def _loop_prior_residual(xi, qk, tk, qc, tc, qm, tm):
    """``log_se3(T_meas^-1 (T_k T_c^-1))`` (6,) of one seam after the
    left-multiplied increments xi = [xi_k (6), xi_c (6)]."""
    qk, tk = se3.compose(*se3.exp(xi[:6]), qk, tk)
    qc, tc = se3.compose(*se3.exp(xi[6:]), qc, tc)
    qr, tr = se3.relative(qk, tk, qc, tc)           # T_k T_c^-1
    qe, te = se3.compose(*se3.inverse(qm, tm), qr, tr)
    return se3.log(qe, te)


_loop_prior_jacobians = torch.func.vmap(
    torch.func.jacfwd(_loop_prior_residual), in_dims=(None,) + (0,) * 6)


def _loop_prior_terms(st: DenseGBAState, q, t):
    """Residuals (L, 6) and Jacobians (L, 6, 6) w.r.t. the increments of
    T_k and of T_c of the seam priors: each accepted loop stores its
    measured relative pose T_kc, and the GBA holds the refined poses to it
    (the reference's documented deviation from a pure-reprojection GBA:
    on sparse maps the drift-consistent majority of observations can
    otherwise relax the loop correction away)."""
    li, lj = st.loop_i.to(torch.int64), st.loop_j.to(torch.int64)
    args = (q[lj], t[lj], q[li], t[li], st.loop_q, st.loop_t)
    zero = torch.zeros((12,), dtype=torch.float32, device=q.device)
    r0 = _loop_prior_residual(zero, *args)
    J = _loop_prior_jacobians(zero, *args)
    return r0, J[..., :6], J[..., 6:]


def _loop_prior_error(st: DenseGBAState, q, t):
    """Sum of weighted squared seam-prior residuals."""
    li, lj = st.loop_i.to(torch.int64), st.loop_j.to(torch.int64)
    qr, tr = se3.relative(q[lj], t[lj], q[li], t[li])
    qe, te = se3.compose(*se3.inverse(st.loop_q, st.loop_t), qr, tr)
    r = se3.log(qe, te)
    return torch.sum(st.loop_w * torch.sum(r * r, dim=-1))


def _dense_gba_terms(st: DenseGBAState, q, t, pos, cfg: SlamConfig,
                     jacobians: bool = True):
    """Residuals (and Jacobians) over the (K, P) table: cameras broadcast
    per row, landmark positions gathered once."""
    cam = cfg.camera
    mp_idx = torch.clamp(st.kf_mp, min=0).to(torch.int64)
    xc = se3.apply(q[:, None, :], t[:, None, :], pos[mp_idx])
    x, y = xc[..., 0], xc[..., 1]
    z = torch.clamp(xc[..., 2], min=_EPS)
    iz = 1.0 / z
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e = torch.stack([u, v, ur], dim=-1) - torch.cat(
        [st.kf_uv, st.kf_ur[..., None]], dim=-1)
    if not jacobians:
        return e, None, None, z
    iz2 = iz * iz
    zeros = torch.zeros_like(z)
    du = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], -1)
    dv = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * iz2], -1)
    dpred = torch.stack([du, dv, dur], dim=-2)               # (K, P, 3, 3)
    nskew = torch.stack([
        torch.stack([zeros, xc[..., 2], -xc[..., 1]], -1),
        torch.stack([-xc[..., 2], zeros, xc[..., 0]], -1),
        torch.stack([xc[..., 1], -xc[..., 0], zeros], -1),
    ], dim=-2)
    eye3 = torch.eye(3, dtype=z.dtype, device=z.device)
    dxc = torch.cat([eye3.expand_as(nskew), nskew], dim=-1)  # (K, P, 3, 6)
    Jc = dpred @ dxc
    Jp = dpred @ se3.quat_to_matrix(q)[:, None]
    return e, Jc, Jp, z


def _dense_gba_weights(st: DenseGBAState, e, z):
    """Per-edge-component weights + raw chi2 error (no robust kernel, as
    the reference's ``GlobalBundleAdjustemnt(bRobust=false)`` after loops,
    ``LoopClosing.cc:763``)."""
    ones = torch.ones_like(z)
    comp_w = torch.stack([ones, ones, (st.kf_ur > 0).to(z.dtype)], -1)
    ok = st.edge_valid & (z > _EPS)
    w = torch.where(ok, st.inv_sigma2, torch.zeros_like(z))
    chi2 = torch.sum(e * e * comp_w, dim=-1) * st.inv_sigma2
    err = torch.sum(torch.where(ok, chi2, torch.zeros_like(chi2)))
    return w[..., None] * comp_w, err


def _dense_gba_error(st: DenseGBAState, q, t, pos, cfg: SlamConfig):
    """The error the LM's accept test compares: reprojection chi2 plus the
    seam priors (a constant while every camera is fixed)."""
    e, _, _, z = _dense_gba_terms(st, q, t, pos, cfg, jacobians=False)
    return _dense_gba_weights(st, e, z)[1] + _loop_prior_error(st, q, t)


def dense_gba_chunk(st: DenseGBAState, cfg: SlamConfig, n_iters: int,
                    structure_only: bool = None) -> DenseGBAState:
    """Advance the GBA by ``n_iters`` LM iterations.

    Two bodies, one result. With every camera fixed (what the loop closer
    asks for under ``cfg.solver.gba_structure_only``) the step is one damped
    3x3 solve per landmark, ``xp = Hpp_inv @ (-gp)``, and nothing of the
    camera system is built. Otherwise the full body eliminates the landmark
    blocks and solves the dense (6K x 6K) reduced camera system, with the
    seam priors as camera-camera terms; its (M, K, 6, 3) cross blocks are
    materialised. The landmark-side sums are segment sums of per-edge (12,)
    and (18,) blocks (``ops/segment.py``).

    ``structure_only`` picks the body; it is a fact of the configuration
    that the caller knows on the host, so choosing costs no device read.
    True holds EVERY camera where it is and refines the landmarks alone,
    whatever ``cam_free`` says: a caller that wants a camera to move passes
    False. False or None takes the full body, which moves the cameras of
    ``cam_free`` and gives the structure-only step when that is all false."""
    K, P = st.kf_mp.shape
    M = st.pos.shape[0]
    dev = st.q.device
    f32, i64 = torch.float32, torch.int64
    camf = st.cam_free.to(f32)
    mp_idx = torch.clamp(st.kf_mp, min=0).to(i64)
    edge_cid = torch.where(st.edge_valid & st.mp_free[mp_idx], mp_idx,
                           torch.full_like(mp_idx, M))
    cmask_f = st.mp_free.to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    cam_on = camf[:, None, None]
    kk = torch.arange(K, device=dev)

    def point_side(Jp, Wt, We, lam):
        JpW = Jp * Wt[..., None]
        pv = torch.cat([torch.einsum("kpin,kpi->kpn", Jp, We),
                        (JpW.mT @ Jp).reshape(K, P, 9)], dim=-1)
        acc_p = segment_sum(edge_cid.reshape(-1), pv.reshape(-1, 12),
                            M + 1)[:M]
        gp = acc_p[:, :3]
        Hpp = acc_p[:, 3:].reshape(M, 3, 3)
        diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_d = Hpp + (lam * diag_p + 1e-8)[..., None] * eye3
        return gp, _inv3x3(Hpp_d) * cmask_f[:, None, None]

    def full_step(q, t, pos, lam):
        e, Jc, Jp, z = _dense_gba_terms(st, q, t, pos, cfg)
        Wt, _ = _dense_gba_weights(st, e, z)                 # (K, P, 3)
        Wc = Wt * cam_on
        We = Wt * e
        gc = torch.einsum("kpin,kpi->kn", Jc, We * cam_on)   # (K, 6)
        JcW = Jc * Wc[..., None]
        Hcc = torch.einsum("kpin,kpim->knm", JcW, Jc)        # (K, 6, 6)
        gp, Hpp_inv = point_side(Jp, Wt, We, lam)
        Bv = (JcW.mT @ Jp).reshape(K, P, 18)
        t_idx = torch.where(edge_cid < M, edge_cid * K + kk[:, None],
                            torch.full_like(edge_cid, M * K))
        T = segment_sum(t_idx.reshape(-1), Bv.reshape(-1, 18),
                        M * K + 1)[:M * K].reshape(M, K, 6, 3)

        bp = -gp
        tp = torch.einsum("makj,mjl->makl", T, Hpp_inv)      # (M, K, 6, 3)
        S = -torch.einsum("manj,mblj->anbl", tp, T)
        dampC = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8
        S[kk, :, kk, :] += Hcc + dampC[..., None] * eye6
        bc_red = -gc - torch.einsum("manj,mj->an", tp, bp)

        # seam priors: camera-camera terms from the measured loop edges;
        # fixed cameras' factors are masked so the gauge rows stay as
        # they are
        r0, Jk, Jc2 = _loop_prior_terms(st, q, t)
        li, lj = st.loop_i.to(i64), st.loop_j.to(i64)
        Jk = Jk * camf[lj][:, None, None]
        Jc2 = Jc2 * camf[li][:, None, None]
        wJk = st.loop_w[:, None, None] * Jk
        wJc = st.loop_w[:, None, None] * Jc2
        blocks = torch.cat([wJk.mT @ Jk, wJc.mT @ Jc2, wJk.mT @ Jc2,
                            wJc.mT @ Jk])
        blk_idx = torch.cat([lj * K + lj, li * K + li, lj * K + li,
                             li * K + lj])
        Sp = segment_sum(blk_idx, blocks.reshape(-1, 36), K * K)
        S = S + Sp.reshape(K, K, 6, 6).permute(0, 2, 1, 3)
        bvec = -torch.cat([torch.einsum("lij,li->lj", wJk, r0),
                           torch.einsum("lij,li->lj", wJc, r0)])
        bc_red = bc_red + segment_sum(torch.cat([lj, li]), bvec, K)

        # fixed-camera rows get identity so the dense solve stays
        # nonsingular; their right-hand side is zeroed
        Sm = S.reshape(6 * K, 6 * K) + torch.diag(
            (1.0 - camf).repeat_interleave(6))
        bflat = (bc_red * camf[:, None]).reshape(-1)
        xc = _finite(torch.linalg.solve_ex(Sm, bflat)[0]).reshape(K, 6)
        xc = xc * camf[:, None]

        tx = torch.einsum("mknj,kn->mj", T, xc)
        xp = _finite(torch.einsum("mjk,mk->mj", Hpp_inv, bp - tx))
        dq, dt = se3.exp(xc)
        q_new, t_new = se3.compose(dq, dt, q, t)
        q_new = torch.where(st.cam_free[:, None], q_new, q)
        t_new = torch.where(st.cam_free[:, None], t_new, t)
        return q_new, t_new, pos + xp * cmask_f[:, None]

    def structure_step(q, t, pos, lam):
        e, _, Jp, z = _dense_gba_terms(st, q, t, pos, cfg)
        Wt, _ = _dense_gba_weights(st, e, z)
        gp, Hpp_inv = point_side(Jp, Wt, Wt * e, lam)
        xp = _finite(torch.einsum("mjk,mk->mj", Hpp_inv, -gp))
        return q, t, pos + xp * cmask_f[:, None]

    step = structure_step if structure_only else full_step
    q, t, pos, lam, err = st.q, st.t, st.pos, st.lam, st.err
    for _ in range(n_iters):
        q_new, t_new, pos_new = step(q, t, pos, lam)
        err_new = _dense_gba_error(st, q_new, t_new, pos_new, cfg)
        improved = err_new < err
        q = torch.where(improved, q_new, q)
        t = torch.where(improved, t_new, t)
        pos = torch.where(improved, pos_new, pos)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                          1e-10, 1e8)
        err = torch.where(improved, err_new, err)
    return st._replace(q=q, t=t, pos=pos, lam=lam, err=err)
