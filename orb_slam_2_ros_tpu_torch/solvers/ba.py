"""Windowed bundle adjustment: masked LM with a dense Schur complement.

Port of ``orb_slam_2_ros_tpu/solvers/ba.py::windowed_bundle_adjustment``,
the local-mapping workhorse (``Optimizer::LocalBundleAdjustment``,
``Optimizer.cc:517-890``), for one device. Each LM step eliminates the 3x3
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
the same result on every run). The matrix-free CG solver, the global BA
and the sharded variants of the reference's file are not ported yet.
"""

from __future__ import annotations

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
