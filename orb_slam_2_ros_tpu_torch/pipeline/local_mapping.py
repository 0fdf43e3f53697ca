"""Local mapping: triangulation, fusion, windowed bundle adjustment, culling.

Port of ``orb_slam_2_ros_tpu/pipeline/local_mapping.py`` (the
``LocalMapping`` thread, ``LocalMapping.cc``) for the three sensors on one
device. Mono differs in three places, as in the reference: twice the
triangulation neighbours, a baseline gate relative to the median scene
depth, and a cull threshold of 2 observations. The host runs one mapping step after each tracking chunk that
inserted a keyframe. The step:

1. new-landmark triangulation against covisible keyframes
   (``CreateNewMapPoints``, ``LocalMapping.cc:239-500``);
2. duplicate-landmark fusion (``SearchInNeighbors``, ``:502-582``);
3. local BA (``Optimizer::LocalBundleAdjustment``, ``Optimizer.cc:517-890``):
   the last ``window`` keyframes are free, the ``window`` before them are
   fixed observers, points observed by the window are free;
4. outlier observation removal (edge chi2 gates, ``Optimizer.cc:781-860``);
5. map-point culling (``LocalMapping::MapPointCulling``,
   ``LocalMapping.cc:197-236``);
6. redundant-keyframe culling (``KeyFrameCulling``, ``:686-767``);
7. point-pool compaction and a full point-stat refresh.

Where the reference predicates with ``lax.cond`` on device scalars, the
gate here is a Python ``if`` on the host's keyframe count; everything
inside a step stays on the device and predicated, so a step reads the
device only for the BA's exit tests.

With a mesh, step 3's observation rows are split over the mesh's ``kf``
axis (``parallel/dist_ba.distributed_windowed_ba``); the rest of the step
runs the same on every rank.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import SENSOR_MONOCULAR, SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame
from orb_slam_2_ros_tpu_torch.geometry import camera, se3
from orb_slam_2_ros_tpu_torch.geometry import triangulate as tri
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.map.state import (pad_row, row, set_row,
                                                set_rows)
from orb_slam_2_ros_tpu_torch.parallel import dist_ba
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span
from orb_slam_2_ros_tpu_torch.pipeline.mono_init import median_or_one
from orb_slam_2_ros_tpu_torch.solvers import ba

_BIG = 0x7FFFFFFF


def _best_covisible(covis: torch.Tensor, k: torch.Tensor, n: int):
    """The n best covisibility weights of keyframe k and their rows, lower
    row first among equal weights (most weights are 0 early in a sequence),
    as ``jax.lax.top_k`` orders them."""
    w, idx = torch.sort(row(covis, k), descending=True, stable=True)
    return w[:n], idx[:n]


def _sum_i32(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask, dtype=torch.int32)


def create_new_map_points(m: map_state.MapState, cfg: SlamConfig,
                          covis=None):
    """Triangulate new landmarks between the newest keyframe and its best
    covisible neighbours (``LocalMapping::CreateNewMapPoints``,
    ``LocalMapping.cc:239-500``): epipolar-gated descriptor matching of
    unmatched keypoints, batched DLT triangulation, then the gate stack
    (cheirality, parallax, reprojection chi2 in both views, scale-ratio
    consistency) as one mask.

    All ``cfg.map.tri_neighbors`` neighbours are matched and gated, one
    after another (each pass holds one (P, P) Hamming matrix); a
    scatter-min then picks, per keypoint of the new keyframe, the surviving
    pair from the best-covisible neighbour, which is what the original's
    sequential first-claim gives. One spawn pass in total.

    Returns (m, n_spawned)."""
    dev = m.kf_q.device
    i32, i64 = torch.int32, torch.int64
    K_int = camera.intrinsics(cfg.camera, dev)
    R = cfg.map.tri_neighbors
    if cfg.sensor == SENSOR_MONOCULAR:
        R *= 2                      # nn=20 for mono (LocalMapping.cc:247)
    R = min(R, m.K)
    P, M = m.P, m.M
    k = torch.clamp(m.n_kfs - 1, min=0)
    if covis is None:
        with span("mapping.covisibility"):
            covis = map_state.covisibility(m)
    w_top, idx_top = _best_covisible(covis, k, R)

    q_k, t_k = row(m.kf_q, k), row(m.kf_t, k)
    mono = cfg.sensor == SENSOR_MONOCULAR
    if mono:
        # median scene depth of the new keyframe for the baseline gate
        # (ComputeSceneMedianDepth, KeyFrame.cc:767-817). As in the
        # reference the array is NaN wherever a keypoint has no point, so
        # the median is NaN and the gate reads baseline / 1.0 whenever one
        # keypoint of the keyframe is unmatched (pipeline/mono_init.py)
        mp_k = row(m.kf_mp, k)
        z_k = se3.apply(q_k, t_k, m.mp_pos[torch.clamp(mp_k, min=0).to(i64)])
        med_depth = median_or_one(torch.where(
            mp_k >= 0, z_k[:, 2], torch.full_like(z_k[:, 2], float("nan"))))
    uv_k_all, oct_k_all = row(m.kf_uv, k), row(m.kf_octave, k)
    desc_k = row(m.kf_desc, k)
    valid_k = row(m.kf_valid, k)
    ratio_factor = 1.5 * cfg.orb.scale_factor
    ck = se3.camera_center(q_k, t_k)
    free_k = row(m.kf_kp_valid, k) & (row(m.kf_mp, k) < 0)
    Kinv = torch.linalg.inv(K_int)
    P1 = tri.projection_matrix(K_int, q_k, t_k)
    sf = cfg.orb.scale_factor

    def scale_of(octave):
        return torch.pow(torch.full_like(octave, sf, dtype=torch.float32),
                         octave.to(torch.float32))

    def per_neighbor(n, w):
        """Match + triangulate + gate against one neighbour; returns per
        keypoint of n (good, index of k's keypoint, world point) and n's
        centre."""
        q_n, t_n = row(m.kf_q, n), row(m.kf_t, n)
        cn = se3.camera_center(q_n, t_n)
        baseline = torch.linalg.norm(ck - cn)
        if mono:
            base_ok = baseline / torch.clamp(med_depth, min=1e-6) > 0.01
        else:
            base_ok = baseline > cfg.camera.bf / cfg.camera.fx
        neigh_ok = ((w >= cfg.map.covis_th) & (n != k) & row(m.kf_valid, n)
                    & valid_k & base_ok)

        # F12: x_n^T F x_k = 0 (ComputeF12, LocalMapping.cc:585-602)
        rq, rt = se3.relative(q_n, t_n, q_k, t_k)
        zero = torch.zeros_like(rt[0])
        tx = torch.stack([torch.stack([zero, -rt[2], rt[1]]),
                          torch.stack([rt[2], zero, -rt[0]]),
                          torch.stack([-rt[1], rt[0], zero])])
        F12 = Kinv.T @ (tx @ se3.quat_to_matrix(rq)) @ Kinv

        uv_n, oct_n = row(m.kf_uv, n), row(m.kf_octave, n)
        free_n = row(m.kf_kp_valid, n) & (row(m.kf_mp, n) < 0) & neigh_ok
        with span("mapping.search_for_triangulation"):
            n_to_k, _ = matcher.search_for_triangulation(
                desc_k, uv_k_all, free_k, row(m.kf_desc, n), uv_n, oct_n,
                free_n, F12, cfg)

        pair = n_to_k >= 0                          # aligned on n's kp axis
        i_idx = torch.clamp(n_to_k, min=0)
        i_l = i_idx.to(i64)
        uv_k = uv_k_all[i_l]
        P2 = tri.projection_matrix(K_int, q_n, t_n)
        with span("mapping.triangulate_dlt"):
            xw = tri.triangulate_dlt(P1, P2, uv_k, uv_n)

        # ---- gate stack (LocalMapping.cc:366-479)
        z1 = tri.depth_in_camera(q_k, t_k, xw)
        z2 = tri.depth_in_camera(q_n, t_n, xw)
        cosp = tri.parallax_cos(xw, ck, cn)
        uv_pk = camera.project(cfg.camera, se3.apply(q_k, t_k, xw))
        uv_pn = camera.project(cfg.camera, se3.apply(q_n, t_n, xw))
        s1 = scale_of(oct_k_all[i_l])
        s2 = scale_of(oct_n)
        e1 = torch.sum((uv_pk - uv_k) ** 2, -1)
        e2 = torch.sum((uv_pn - uv_n) ** 2, -1)
        d1 = torch.linalg.norm(xw - ck, dim=-1)
        d2 = torch.linalg.norm(xw - cn, dim=-1)
        ratio = d2 / torch.clamp(d1, min=1e-9)
        ratio_oct = s1 / s2
        good = (pair & (z1 > 0) & (z2 > 0) & (cosp < 0.9998)
                & (e1 < 5.991 * s1 * s1) & (e2 < 5.991 * s2 * s2)
                & (ratio < ratio_oct * ratio_factor)
                & (ratio * ratio_factor > ratio_oct))
        return good, i_idx, xw, cn

    per = [per_neighbor(idx_top[r], w_top[r]) for r in range(R)]
    good_r = torch.stack([p[0] for p in per])       # (R, P) on n's kp axis
    i_r = torch.stack([p[1] for p in per])          # (R, P) k-kp targets
    xw_r = torch.stack([p[2] for p in per])         # (R, P, 3)
    cn_r = torch.stack([p[3] for p in per])         # (R, 3)

    # ---- winner per k-keypoint: lowest (rank, j) key; rank-major order
    # reproduces the original's sequential first-claim
    key = torch.arange(R * P, dtype=i32, device=dev)
    good_f = good_r.reshape(-1)
    slot = torch.where(good_f, i_r.reshape(-1).to(i64),
                       torch.full_like(good_f, P, dtype=i64))
    win_key = torch.full((P + 1,), _BIG, dtype=i32, device=dev).scatter_reduce(
        0, slot, torch.where(good_f, key, torch.full_like(key, _BIG)),
        reduce="amin")[:P]
    won = win_key != _BIG                           # (P,) per k-kp
    r_w = torch.clamp(win_key // P, 0, R - 1).to(i64)
    j_w = torch.clamp(win_key % P, 0, P - 1)

    # ---- gather winner data onto k's keypoint axis
    i_k = torch.arange(P, dtype=i32, device=dev)
    xw = xw_r[r_w, j_w.to(i64)]                     # (P, 3)
    cn = cn_r[r_w]                                  # (P, 3)
    n_row = idx_top[r_w].to(i32)                    # (P,) neighbour kf row

    # ---- predicated spawn into the point pool
    rank_i = torch.cumsum(won.to(i32), 0, dtype=i32) - 1
    spawn = won & (rank_i < M - m.n_mps)
    new_id = torch.where(spawn, m.n_mps + rank_i, torch.full_like(rank_i, -1))
    tgt = torch.where(spawn, new_id.to(i64), torch.full_like(rank_i, M,
                                                            dtype=i64))

    d1 = torch.linalg.norm(xw - ck, dim=-1)
    d2 = torch.linalg.norm(xw - cn, dim=-1)
    dir1 = (xw - ck) / torch.clamp(d1[:, None], min=1e-9)
    dir2 = (xw - cn) / torch.clamp(d2[:, None], min=1e-9)
    nrm = dir1 + dir2
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-9)
    max_d = d1 * scale_of(oct_k_all)
    min_d = max_d / (sf ** (cfg.orb.n_levels - 1))

    def scat(pool, vals):
        return pad_row(pool).index_put((tgt,), vals)[:M]

    ones = torch.ones((P,), dtype=i32, device=dev)
    k32 = k.to(i32)
    obs_tbl_new = torch.full((P, map_state.NOBS_DESC), -1, dtype=i32,
                             device=dev)
    obs_tbl_new[:, 0] = k32 * P + i_k
    obs_tbl_new[:, 1] = n_row * P + j_w
    # observations in both keyframes: k's row by keypoint index, the
    # winning neighbour's by flat (row, kp) index; a winner names one
    # keypoint of one neighbour, so no flat index repeats
    kf_mp = set_row(
        m.kf_mp, k, torch.where(spawn, new_id, row(m.kf_mp, k)))
    flat = torch.where(spawn, (n_row * P + j_w).to(i64),
                       torch.full_like(tgt, m.K * P))
    kf_mp = pad_row(kf_mp.reshape(-1)).index_put((flat,), new_id)[:m.K * P]
    n_spawned = _sum_i32(spawn)
    m = m._replace(
        mp_pos=scat(m.mp_pos, xw),
        mp_valid=scat(m.mp_valid, spawn),
        mp_desc=scat(m.mp_desc, desc_k),
        mp_normal=scat(m.mp_normal, nrm),
        mp_min_dist=scat(m.mp_min_dist, 0.8 * min_d),
        mp_max_dist=scat(m.mp_max_dist, 1.2 * max_d),
        mp_first_kf=scat(m.mp_first_kf, ones * k32),
        mp_dir_sum=scat(m.mp_dir_sum, dir1 + dir2),
        mp_obs_cnt=scat(m.mp_obs_cnt, 2 * ones),
        mp_visible=scat(m.mp_visible, ones),
        mp_found=scat(m.mp_found, ones),
        mp_obs_tbl=scat(m.mp_obs_tbl, obs_tbl_new),
        kf_mp=kf_mp.reshape(m.K, P),
        n_mps=m.n_mps + n_spawned,
    )
    return m, n_spawned


def _kf_as_frame(m: map_state.MapState, r: torch.Tensor) -> Frame:
    """Keyframe row r's features as a Frame for the matcher."""
    uv = row(m.kf_uv, r)
    kps = Keypoints(
        xy=uv, response=torch.zeros_like(uv[:, 0]), angle=row(m.kf_angle, r),
        octave=row(m.kf_octave, r), desc=row(m.kf_desc, r).contiguous(),
        valid=row(m.kf_kp_valid, r) & row(m.kf_valid, r))
    return Frame(kps=kps, uv=uv, u_right=row(m.kf_ur, r),
                 depth=row(m.kf_depth, r))


def fuse_duplicates(m: map_state.MapState, cfg: SlamConfig, covis=None):
    """Merge duplicate landmarks between the newest keyframe and its best
    covisible neighbours (``LocalMapping::SearchInNeighbors`` +
    ``ORBmatcher::Fuse``, ``LocalMapping.cc:502-582``,
    ``ORBmatcher.cc:827-977``): project each keyframe's points into the
    other, match by window + descriptor (two launches of the matcher kernel
    per neighbour), and where a keypoint already references a different
    landmark, keep the one with more observations (``MapPoint::Replace``,
    ``MapPoint.cc:213-259``) via a replacement table applied to the whole
    observation table; free matched keypoints gain the observation instead.

    Returns (m, n_fused)."""
    n_neigh = cfg.map.fuse_neighbors
    M = m.M
    i64 = torch.int64
    dev = m.kf_q.device
    k = torch.clamp(m.n_kfs - 1, min=0)
    if covis is None:
        with span("mapping.covisibility"):
            covis = map_state.covisibility(m)
    w_top, idx_top = _best_covisible(covis, k, n_neigh)
    obs_cnt = map_state.observation_count(m)
    ids = torch.arange(M, dtype=torch.int32, device=dev)
    repl = ids                      # landmark -> the landmark replacing it

    for rank in range(n_neigh):
        n = idx_top[rank]
        pair_ok = (w_top[rank] >= cfg.map.covis_th) & (n != k)
        for src, dst in ((k, n), (n, k)):
            # project src's landmarks into dst and match
            src_mp = row(m.kf_mp, src)
            src_c = torch.clamp(src_mp, min=0).to(i64)
            with span("mapping.search_by_projection_pose"):
                kp_to_i, _ = matcher.search_by_projection_pose(
                    m.mp_pos[src_c], m.mp_desc[src_c], row(m.kf_octave, src),
                    (src_mp >= 0) & pair_ok & m.mp_valid[src_c],
                    row(m.kf_q, dst), row(m.kf_t, dst), _kf_as_frame(m, dst),
                    cfg, th=3.0, check_rotation=False)
            # kp j of dst matched to src keypoint i -> landmark src_mp[i]
            none = torch.full_like(src_mp, -1)
            cand = torch.where(
                kp_to_i >= 0,
                src_mp[torch.clamp(kp_to_i, min=0).to(i64)], none)
            dst_mp = row(m.kf_mp, dst)
            # case 1: dst keypoint free -> gain the observation
            gain = (cand >= 0) & (dst_mp < 0)
            m = m._replace(kf_mp=set_row(
                m.kf_mp, dst, torch.where(gain, cand, dst_mp)))
            # case 2: conflict -> replace the weaker landmark everywhere
            conflict = (cand >= 0) & (dst_mp >= 0) & (cand != dst_mp)
            a = torch.clamp(cand, min=0)
            b = torch.clamp(dst_mp, min=0)
            cnt_a, cnt_b = obs_cnt[a.to(i64)], obs_cnt[b.to(i64)]
            # winner: more observations, ties broken toward the lower id so
            # both sweep directions agree (no replacement 2-cycles)
            keep_a = (cnt_a > cnt_b) | ((cnt_a == cnt_b) & (a < b))
            loser = torch.where(keep_a, b, a)
            winner = torch.where(keep_a, a, b)
            # two keypoints can lose to different winners for one landmark:
            # the last of them is kept, by an explicit choice
            repl = set_rows(repl, torch.where(
                conflict, loser.to(i64), torch.full_like(loser, M, dtype=i64)),
                winner)

    # squash two-level replacement chains, then apply across the
    # observation table; invalidate losers
    repl = repl[repl.to(i64)]
    replaced = repl != ids
    n_fused = _sum_i32(replaced)
    kf_mp = torch.where(m.kf_mp >= 0,
                        repl[torch.clamp(m.kf_mp, min=0).to(i64)],
                        torch.full_like(m.kf_mp, -1))
    # Replace merges the loser's found/visible counters into the winner
    # (MapPoint::Replace, MapPoint.cc:229-233)
    wtgt = torch.where(replaced, repl.to(i64), torch.full_like(repl, M,
                                                              dtype=i64))
    zero = torch.zeros_like(m.mp_visible)
    vis = pad_row(m.mp_visible).index_add(
        0, wtgt, torch.where(replaced, m.mp_visible, zero))[:M]
    fnd = pad_row(m.mp_found).index_add(
        0, wtgt, torch.where(replaced, m.mp_found, zero))[:M]
    m = m._replace(kf_mp=kf_mp, mp_valid=m.mp_valid & ~replaced,
                   mp_visible=vis, mp_found=fnd)
    return m, n_fused


def cull_keyframes(m: map_state.MapState, cfg: SlamConfig, window: int = 20):
    """Remove redundant keyframes: >= 90% of a keyframe's landmarks observed
    by >= 3 other keyframes at the same or finer scale
    (``LocalMapping::KeyFrameCulling``, ``LocalMapping.cc:686-767``: an
    observation counts as redundant support only when the other keyframe
    sees the point at scale level <= own level + 1, ``:728-737``).

    Only keyframes inside the recent window, excluding the newest and
    keyframe 0. Returns (m, n_culled)."""
    K, P, M = m.K, m.P, m.M
    dev = m.kf_q.device
    i64 = torch.int64
    rows = torch.arange(K, dtype=torch.int32, device=dev)
    n = m.n_kfs
    has_mp = (m.kf_mp >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    # per-point octave histogram -> cumulative count of observations at
    # level <= l, so the scale gate is one gather per observation
    L = cfg.orb.n_levels
    flat_mp = torch.where(has_mp, m.kf_mp.to(i64),
                          torch.full_like(m.kf_mp, M, dtype=i64)).reshape(-1)
    flat_oct = torch.clamp(m.kf_octave, 0, L - 1).to(i64).reshape(-1)
    cnt_oct = torch.zeros(((M + 1) * L,), dtype=torch.int32, device=dev)
    cnt_oct = cnt_oct.index_add(0, flat_mp * L + flat_oct,
                                (flat_mp < M).to(torch.int32))
    cnt_le = torch.cumsum(cnt_oct.reshape(M + 1, L)[:M], dim=-1,
                          dtype=torch.int32)                  # (M, L)
    mp_idx = torch.clamp(m.kf_mp, min=0).to(i64)
    lvl_gate = torch.clamp(m.kf_octave + 1, 0, L - 1).to(i64)
    n_support = cnt_le.reshape(-1)[mp_idx * L + lvl_gate] - 1  # exclude self
    redundant_obs = has_mp & (n_support >= 3)
    n_obs = torch.sum(has_mp, dim=1, dtype=torch.int32)
    n_red = torch.sum(redundant_obs, dim=1, dtype=torch.int32)
    in_window = (rows >= n - window) & (rows < n - 1) & (rows > 0)
    cull = (m.kf_valid & in_window & (n_obs > 20)
            & (n_red.to(torch.float32)
               >= cfg.map.kf_cull_redundancy * n_obs.to(torch.float32)))
    m = m._replace(
        kf_valid=m.kf_valid & ~cull,
        kf_mp=torch.where(cull[:, None], torch.full_like(m.kf_mp, -1),
                          m.kf_mp),
        kf_kp_valid=m.kf_kp_valid & ~cull[:, None])
    return m, _sum_i32(cull)


class LocalMapper:
    """The mapping step over the tracker's map, gated on the host.

    - FULL: triangulation + fusion + windowed BA + point and keyframe
      culling + compaction + stat refresh: the complete
      ``LocalMapping::Run`` body.
    - LIGHT: windowed BA + point culling + compaction only (for callers
      that want a cheaper refinement pass).

    A step runs only when a keyframe arrived since the previous one, as
    the original's consumer thread sleeps while ``CheckNewKeyFrames()`` is
    empty (``LocalMapping.cc:50-126``). The caller runs ``run()`` once per
    tracking chunk and passes the keyframe count it already has on the
    host, so the gate costs no read of the device.

    ``last_step`` holds what the most recent executed step did, as device
    scalars and host integers (see ``run``); ``n_executed`` counts executed
    steps.

    ``mesh`` (``parallel.mesh.Mesh``): the windowed BA's observation rows
    split over the mesh's ``kf`` axis (``dist_ba.distributed_windowed_ba``);
    its 2 * ``window`` rows must divide by the axis size.
    """

    def __init__(self, cfg: SlamConfig, window: int = 10, mesh=None):
        self.cfg = cfg
        self.window = window
        self.mesh = mesh
        if mesh is not None:
            n_row = mesh.shape[cfg.mesh.kf_axis]
            if (2 * window) % n_row:
                raise ValueError(f"2 * window = {2 * window} rows must "
                                 f"divide by the {n_row} shards of the "
                                 f"{cfg.mesh.kf_axis} axis")
        # post-step keyframe count of the previous run; -1 = never ran,
        # the first step always executes
        self._prev_n_kfs = -1
        self._last_n_ba_free = None     # device scalar of the last BA step
        self.n_executed = 0
        self.last_step = None

    def has_work(self, n_kfs: int) -> bool:
        """Whether a step run now would execute: a keyframe arrived since
        the previous step."""
        return n_kfs > self._prev_n_kfs

    def rearm(self):
        """Make the next step execute whatever the keyframe count is
        (after the keyframe pool was compacted or the map reset)."""
        self._prev_n_kfs = -1

    def run(self, m: map_state.MapState, last_mp: torch.Tensor = None,
            allow_compact: bool = True, full: bool = True,
            force: bool = False, n_kfs: int = None):
        """One mapping step. Returns (new_map, n_culled, last_mp') where
        last_mp' is the caller's keypoint -> map-point association vector
        re-indexed through the compaction remap (pass the tracker's
        ``carry.last_mp``; omitted -> a dummy is threaded through).
        allow_compact=False freezes point-pool ids; full=False runs the
        LIGHT body (BA + cull + compact). The step does nothing unless a
        keyframe arrived since the last step (force=True overrides).
        ``n_kfs`` is the map's keyframe count where the caller has it on
        the host; without it the count is read from the device.

        n_culled is a device scalar. After an executed step ``last_step``
        is a dict of device scalars ``n_spawned``, ``n_fused``,
        ``n_culled``, ``n_kf_culled``, ``n_ba_free`` and, from the BA,
        ``ba_iters`` and ``ba_cost`` (host numbers, see
        ``windowed_bundle_adjustment``)."""
        if last_mp is None:
            last_mp = torch.full((m.P,), -1, dtype=torch.int32,
                                 device=m.kf_q.device)
        if n_kfs is None:
            n_kfs = int(m.n_kfs)
        execute = force or self.has_work(n_kfs)
        self._prev_n_kfs = n_kfs
        if not execute:
            self._last_n_ba_free = None
            return m, torch.zeros((), dtype=torch.int32,
                                  device=m.kf_q.device), last_mp
        m, last_mp, step = _mapping_body(
            m, last_mp, self.cfg, self.window, allow_compact, full,
            self.mesh)
        self._last_n_ba_free = step["n_ba_free"]
        self.last_step = step
        self.n_executed += 1
        return m, step["n_culled"], last_mp

    @property
    def last_ba_free_points(self) -> int:
        """Free-landmark count of the most recent BA step (0 when the step
        did nothing). Above ``cfg.solver.local_ba_max_points`` the compact
        axis overflowed: the excess landmarks stayed frozen. Reads the
        device; for debugging and observation only."""
        if self._last_n_ba_free is None:
            return 0
        return int(self._last_n_ba_free)


@span("mapping.mapping_step")
def _mapping_body(m: map_state.MapState, last_mp: torch.Tensor,
                  cfg: SlamConfig, window: int, allow_compact: bool,
                  full: bool, mesh=None):
    """The body of one executed step. Returns (m, last_mp, step dict)."""
    K, M = m.K, m.M
    dev = m.kf_q.device
    i32, i64 = torch.int32, torch.int64
    zero = torch.zeros((), dtype=i32, device=dev)
    n_spawned = n_fused = n_kf_culled = zero
    if full:
        # one covisibility build serves triangulation and fusion, as the
        # original computes it once per keyframe (UpdateConnections in
        # ProcessNewKeyFrame)
        with span("mapping.covisibility"):
            covis = map_state.covisibility(m)
        with span("mapping.create_new_map_points"):
            m, n_spawned = create_new_map_points(m, cfg, covis=covis)
        with span("mapping.fuse_duplicates"):
            m, n_fused = fuse_duplicates(m, cfg, covis=covis)
    n = m.n_kfs
    # compact recent-rows table: only the last W2 keyframes enter the BA
    # edge set (the free window plus fixed recent observers, about the
    # original's fixed second ring; observers older than W2 anchor their
    # points implicitly through the points' positions)
    W2 = min(2 * window, K)
    rows_idx = n - W2 + torch.arange(W2, dtype=i32, device=dev)
    rows = torch.clamp(rows_idx, min=0).to(i64)
    row_ok = (rows_idx >= 0) & m.kf_valid[rows]
    none = torch.full((W2, m.P), -1, dtype=i32, device=dev)
    c_mp = torch.where(row_ok[:, None], m.kf_mp[rows], none)
    c_kpv = m.kf_kp_valid[rows] & row_ok[:, None]
    # free cameras: the last `window` rows of the compact table
    w_local = W2 - window + torch.arange(window, dtype=i32, device=dev)
    w_ok = row_ok[W2 - window:] & (rows_idx[W2 - window:] > 0)
    window_rows = torch.where(w_ok, w_local, torch.full_like(w_local, -1))

    # free points = observed by at least one window keyframe
    in_win_row = torch.zeros((W2,), dtype=torch.bool, device=dev)
    in_win_row[W2 - window:] = w_ok
    obs = torch.where(in_win_row[:, None] & (c_mp >= 0), c_mp.to(i64),
                      torch.full_like(c_mp, M, dtype=i64))
    mp_free = torch.zeros((M + 1,), dtype=torch.bool, device=dev).index_fill(
        0, obs.reshape(-1), True)[:M]
    mp_free = mp_free & m.mp_valid

    ba_stats = {}
    ba_args = (m.kf_q[rows], m.kf_t[rows], window_rows, m.kf_uv[rows],
               m.kf_ur[rows], m.kf_octave[rows], c_mp, c_kpv, m.mp_pos,
               mp_free, cfg)
    phases = (cfg.solver.local_ba_iters1, cfg.solver.local_ba_iters2)
    with span("mapping.windowed_bundle_adjustment"):
        if mesh is None:
            q_c, t_c, pos, edge_inl, _, n_ba_free = \
                ba.windowed_bundle_adjustment(*ba_args, phases=phases,
                                              stats=ba_stats)
        else:
            q_c, t_c, pos, edge_inl, _, n_ba_free = \
                dist_ba.distributed_windowed_ba(mesh, *ba_args,
                                                phases=phases, stats=ba_stats)

    # write back window poses and drop outlier observations at the
    # standard chi2 gate for every participating row
    # (Optimizer.cc:781-860). Rows that are not ok clamp to row 0 and may
    # repeat it, so they write to a spare row instead.
    scat_rows = torch.where(row_ok, rows, torch.full_like(rows, K))
    had_edge = (c_mp >= 0) & c_kpv
    c_mp_new = torch.where(had_edge & ~edge_inl, none, c_mp)
    m = m._replace(
        kf_q=pad_row(m.kf_q).index_put((scat_rows,), q_c)[:K],
        kf_t=pad_row(m.kf_t).index_put((scat_rows,), t_c)[:K],
        kf_mp=pad_row(m.kf_mp).index_put((scat_rows,), c_mp_new)[:K],
        mp_pos=pos)

    # map-point culling: old points with too few surviving observations
    # (mono keeps a point at >= 2 observations, stereo/RGB-D at >= 3,
    # LocalMapping.cc:209)
    cnt = map_state.observation_count(m)
    age = n - m.mp_first_kf     # in keyframes
    # found-ratio clause (GetFoundRatio() < 0.25f, LocalMapping.cc:221):
    # only while the point is recent (the original drops it from the
    # recently-added list after 3 keyframes, LocalMapping.cc:229-231);
    # applied forever it starves the observation graph on sweeping
    # trajectories, where old landmarks stay in view long after their
    # matched window
    ratio = (m.mp_found.to(torch.float32)
             / torch.clamp(m.mp_visible, min=1).to(torch.float32))
    weak = (age <= 3) & (m.mp_visible >= 8) & (ratio < 0.25)
    cull_th = 2 if cfg.sensor == SENSOR_MONOCULAR else cfg.map.min_obs_cull
    cull = m.mp_valid & (((age >= 3) & (cnt < cull_th)) | weak)
    kf_mp = torch.where(
        (m.kf_mp >= 0) & cull[torch.clamp(m.kf_mp, min=0).to(i64)],
        torch.full_like(m.kf_mp, -1), m.kf_mp)
    m = m._replace(mp_valid=m.mp_valid & ~cull, kf_mp=kf_mp)

    # redundant-keyframe culling (KeyFrameCulling, LocalMapping.cc:686-767)
    if full:
        with span("mapping.cull_keyframes"):
            m, n_kf_culled = cull_keyframes(m, cfg, window=window)

    # point-pool compaction: recycle culled and fused rows so that n_mps
    # is a live count (Map::EraseMapPoint, Map.cc:69-78). The tracker's
    # last-frame associations ride through the remap. Off while something
    # else holds point ids (a background global BA).
    if allow_compact:
        with span("mapping.compact_points"):
            m, remap = map_state.compact_points(m)
        last_mp = torch.where(
            last_mp >= 0, remap[torch.clamp(last_mp, min=0).to(i64)],
            torch.full_like(last_mp, -1))

    if full:
        with span("mapping.refresh_point_stats"):
            m = map_state.refresh_point_stats(m, cfg)
    step = dict(n_spawned=n_spawned, n_fused=n_fused, n_culled=_sum_i32(cull),
                n_kf_culled=n_kf_culled, n_ba_free=n_ba_free,
                n_ba_cams=_sum_i32(w_ok), ba_iters=ba_stats["iters"],
                ba_cost=ba_stats["cost"])
    return m, last_mp, step
