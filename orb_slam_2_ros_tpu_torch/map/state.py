"""MapState: the map as a NamedTuple of fixed-shape tensors.

Port of ``orb_slam_2_ros_tpu/map/state.py`` (the tracker commits through
``commit_keyframe``; the monocular initializer appends its two keyframes
with ``insert_keyframe``; ``spawn_points`` is the reference's public
depth-channel spawner, which no path of either package calls):
keyframes are rows of pooled tensors (pose, features and the kp -> map
point observation table ``kf_mp``), map points are rows of point pools.
Descriptors are int32 words with the reference's uint32 bits. What the
original keeps incrementally under mutexes (observation counts,
covisibility weights, viewing normals and scale bands) is recomputed from
the observation table in batched passes.

Updates are functional like the reference's (each returns a new MapState);
the pools are small enough that a copy per frame costs microseconds on the
card. Writes of a predicated commit that must not land go to one spare row
past the end of a pool, which is then dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame
from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.ops.hamming import popcount

NOBS_DESC = 8   # newest observations kept per point for the descriptor choice


class MapState(NamedTuple):
    # --- keyframe pool (K rows) ---
    kf_q: torch.Tensor        # (K, 4) world->camera rotation
    kf_t: torch.Tensor        # (K, 3)
    kf_valid: torch.Tensor    # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32 source frame index
    kf_uv: torch.Tensor       # (K, P, 2) undistorted
    kf_ur: torch.Tensor       # (K, P) right coord or -1
    kf_depth: torch.Tensor    # (K, P) metric depth or -1
    kf_octave: torch.Tensor   # (K, P) int32
    kf_angle: torch.Tensor    # (K, P) float32
    kf_desc: torch.Tensor     # (K, P, 8) int32 words
    kf_kp_valid: torch.Tensor  # (K, P) bool
    kf_mp: torch.Tensor       # (K, P) int32 map-point id or -1
    # --- map-point pool (M rows) ---
    mp_pos: torch.Tensor      # (M, 3) world
    mp_valid: torch.Tensor    # (M,) bool
    mp_desc: torch.Tensor     # (M, 8) int32 representative descriptor
    mp_normal: torch.Tensor   # (M, 3) mean viewing direction
    mp_min_dist: torch.Tensor  # (M,) scale-invariance band
    mp_max_dist: torch.Tensor  # (M,)
    mp_first_kf: torch.Tensor  # (M,) int32 creating keyframe
    mp_dir_sum: torch.Tensor   # (M, 3) running sum of unit viewing directions
    mp_obs_cnt: torch.Tensor   # (M,) int32 running observation count
    mp_visible: torch.Tensor   # (M,) int32 frames the point was in view
    mp_found: torch.Tensor     # (M,) int32 frames it was a pose inlier
    mp_obs_tbl: torch.Tensor   # (M, NOBS_DESC) int32 ring of kf * P + kp
    # --- counters ---
    n_kfs: torch.Tensor       # () int32 next keyframe row
    n_mps: torch.Tensor       # () int32 next map-point row

    @property
    def K(self):
        return self.kf_q.shape[0]

    @property
    def M(self):
        return self.mp_pos.shape[0]

    @property
    def P(self):
        return self.kf_uv.shape[1]


def empty(cfg: SlamConfig, device) -> MapState:
    K, M, P = cfg.map.max_kfs, cfg.map.max_mps, cfg.map.max_kps
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device)
    kf_q = torch.zeros((K, 4), dtype=f32, **kw)
    kf_q[:, 0] = 1.0
    return MapState(
        kf_q=kf_q,
        kf_t=torch.zeros((K, 3), dtype=f32, **kw),
        kf_valid=torch.zeros((K,), dtype=torch.bool, **kw),
        kf_frame_id=torch.full((K,), -1, dtype=i32, **kw),
        kf_uv=torch.zeros((K, P, 2), dtype=f32, **kw),
        kf_ur=torch.full((K, P), -1.0, dtype=f32, **kw),
        kf_depth=torch.full((K, P), -1.0, dtype=f32, **kw),
        kf_octave=torch.zeros((K, P), dtype=i32, **kw),
        kf_angle=torch.zeros((K, P), dtype=f32, **kw),
        kf_desc=torch.zeros((K, P, 8), dtype=i32, **kw),
        kf_kp_valid=torch.zeros((K, P), dtype=torch.bool, **kw),
        kf_mp=torch.full((K, P), -1, dtype=i32, **kw),
        mp_pos=torch.zeros((M, 3), dtype=f32, **kw),
        mp_valid=torch.zeros((M,), dtype=torch.bool, **kw),
        mp_desc=torch.zeros((M, 8), dtype=i32, **kw),
        mp_normal=torch.zeros((M, 3), dtype=f32, **kw),
        mp_min_dist=torch.zeros((M,), dtype=f32, **kw),
        mp_max_dist=torch.full((M,), 1e9, dtype=f32, **kw),
        mp_first_kf=torch.full((M,), -1, dtype=i32, **kw),
        mp_dir_sum=torch.zeros((M, 3), dtype=f32, **kw),
        mp_obs_cnt=torch.zeros((M,), dtype=i32, **kw),
        mp_visible=torch.ones((M,), dtype=i32, **kw),
        mp_found=torch.ones((M,), dtype=i32, **kw),
        mp_obs_tbl=torch.full((M, NOBS_DESC), -1, dtype=i32, **kw),
        n_kfs=torch.zeros((), dtype=i32, **kw),
        n_mps=torch.zeros((), dtype=i32, **kw),
    )


def pad_row(pool: torch.Tensor) -> torch.Tensor:
    """The pool with one spare row at index M for writes that must not land."""
    return torch.cat([pool, torch.zeros_like(pool[:1])], dim=0)


def set_rows(pool: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``pool.at[idx].set(vals)`` with idx in [0, M] (M = spare row, dropped).
    Where idx repeats, the last writer wins, as in XLA's CPU scatter; the
    winners are picked explicitly so the result is deterministic on CUDA."""
    M = pool.shape[0]
    n = idx.shape[0]
    order = torch.arange(n, device=idx.device)
    last = torch.full((M + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx, order, reduce="amax")
    keep = last[idx] == order
    idx = torch.where(keep, idx, torch.full_like(idx, M))
    return pad_row(pool).index_put((idx,), vals)[:M]


def set_row(pool: torch.Tensor, k: torch.Tensor, vals: torch.Tensor):
    """``pool.at[k].set(vals)`` for a 0-d index tensor k."""
    return pool.index_copy(0, k.reshape(1).to(torch.int64), vals[None])


def row(pool: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``pool[k]`` for a 0-d index tensor k on the pool's device. Plain
    indexing with such a tensor reads it on the host first, which waits
    for the device; ``index_select`` does not."""
    return pool.index_select(0, k.reshape(1).to(torch.int64))[0]


def spawn_points(state: MapState, kf_id, cfg: SlamConfig,
                 close_only: bool = True, max_spawn: int = 512) -> MapState:
    """Create map points from keyframe ``kf_id``'s depth channel for the
    keypoints not yet associated (``Tracking::CreateNewKeyFrame``'s
    depth-sorted spawning, ``Tracking.cc:1240-1296``).

    ``close_only`` keeps depth < th_depth * baseline, the close/far split;
    the nearest ``max_spawn`` eligible keypoints are spawned, within the
    pool's free capacity."""
    cam = cfg.camera
    P, M = state.P, state.M
    dev = state.kf_q.device
    i32, i64 = torch.int32, torch.int64
    k = torch.as_tensor(kf_id, dtype=i64, device=dev)
    depth = row(state.kf_depth, k)
    kf_mp = row(state.kf_mp, k)
    eligible = row(state.kf_kp_valid, k) & (depth > 0) & (kf_mp < 0)
    if close_only:
        eligible = eligible & (depth < cam.bf / cam.fx * cam.th_depth)

    # nearest first: rank the eligible keypoints by depth
    order = torch.argsort(torch.where(eligible, depth,
                                      torch.full_like(depth, float("inf"))),
                          stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(P, device=dev))
    spawn = eligible & (ranks < max_spawn) & (ranks < M - state.n_mps)
    new_id = torch.where(spawn, state.n_mps + ranks,
                         torch.full_like(ranks, -1)).to(i32)

    # back-project to the world
    q, t = row(state.kf_q, k), row(state.kf_t, k)
    uv = row(state.kf_uv, k)
    xc = torch.cat([torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                                 (uv[:, 1] - cam.cy) / cam.fy], -1)
                    * depth[:, None], depth[:, None]], dim=-1)
    xw = se3.apply(*se3.inverse(q, t), xc)
    dirs = xw - se3.camera_center(q, t)
    dist = torch.linalg.norm(dirs, dim=-1)
    octv = row(state.kf_octave, k).to(torch.float32)
    max_d = dist * torch.pow(torch.full_like(octv, cfg.orb.scale_factor),
                             octv)
    min_d = max_d / (cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))
    unit = dirs / torch.clamp(dist[:, None], min=1e-9)
    tgt = torch.where(spawn, new_id.to(i64), torch.full_like(ranks, M))

    def scat(pool, vals):
        return pad_row(pool).index_put((tgt,), vals)[:M]

    ones = torch.ones((P,), dtype=i32, device=dev)
    obs = torch.full((P, NOBS_DESC), -1, dtype=i32, device=dev)
    obs[:, 0] = (k * P + torch.arange(P, device=dev)).to(i32)
    return state._replace(
        mp_pos=scat(state.mp_pos, xw),
        mp_valid=scat(state.mp_valid, spawn),
        mp_desc=scat(state.mp_desc, row(state.kf_desc, k)),
        mp_normal=scat(state.mp_normal, unit),
        mp_min_dist=scat(state.mp_min_dist, 0.8 * min_d),
        mp_max_dist=scat(state.mp_max_dist, 1.2 * max_d),
        mp_first_kf=scat(state.mp_first_kf, ones * k.to(i32)),
        mp_dir_sum=scat(state.mp_dir_sum, unit),
        mp_obs_cnt=scat(state.mp_obs_cnt, ones),
        mp_visible=scat(state.mp_visible, ones),
        mp_found=scat(state.mp_found, ones),
        mp_obs_tbl=scat(state.mp_obs_tbl, obs),
        kf_mp=set_row(state.kf_mp, k, torch.where(spawn, new_id, kf_mp)),
        n_mps=state.n_mps + torch.sum(spawn, dtype=i32))


def bump_visibility(state: MapState, visible_mask: torch.Tensor,
                    found_ids: torch.Tensor, enable) -> MapState:
    """Per-frame visibility counters (``MapPoint::IncreaseVisible`` /
    ``IncreaseFound``): visible += 1 for every point the frustum pass saw,
    found += 1 for every final pose inlier. ``enable`` gates the update."""
    M = state.M
    vis = state.mp_visible + (visible_mask & enable).to(torch.int32)
    tgt = torch.where((found_ids >= 0) & enable, found_ids.to(torch.int64),
                      torch.full_like(found_ids, M, dtype=torch.int64))
    fnd = pad_row(state.mp_found).index_add(
        0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:M]
    return state._replace(mp_visible=vis, mp_found=fnd)


def insert_keyframe(state: MapState, frame: Frame, q, t, frame_id,
                    kp_to_mp: torch.Tensor):
    """Append the frame as keyframe row ``n_kfs`` with its current map-point
    associations (``Tracking::CreateNewKeyFrame``, ``Tracking.cc:1204-1219``)
    and record them in the points' observation rings. Spawns no point.
    Returns (state, kf_id) with kf_id the 0-d row tensor."""
    k = state.n_kfs
    P, M = state.P, state.M
    dev = state.kf_q.device
    i64 = torch.int64
    kp_mp = torch.where(frame.kps.valid, kp_to_mp, torch.full_like(kp_to_mp, -1))
    fid = torch.as_tensor(frame_id, dtype=torch.int32, device=dev)
    obs_mask = kp_mp >= 0
    mp_ids = torch.where(obs_mask, kp_mp.to(i64),
                         torch.full_like(kp_mp, M, dtype=i64))
    slot = (state.mp_obs_cnt[torch.clamp(kp_mp, min=0).to(i64)]
            % NOBS_DESC).to(i64)
    flat_idx = k * P + torch.arange(P, dtype=torch.int32, device=dev)
    flat_tbl = set_rows(pad_row(state.mp_obs_tbl).reshape(-1),
                        mp_ids * NOBS_DESC + slot, flat_idx)
    state = state._replace(
        kf_q=set_row(state.kf_q, k, q),
        kf_t=set_row(state.kf_t, k, t),
        kf_valid=set_row(state.kf_valid, k, torch.ones_like(state.kf_valid[0])),
        kf_frame_id=set_row(state.kf_frame_id, k, fid),
        kf_uv=set_row(state.kf_uv, k, frame.uv),
        kf_ur=set_row(state.kf_ur, k, frame.u_right),
        kf_depth=set_row(state.kf_depth, k, frame.depth),
        kf_octave=set_row(state.kf_octave, k, frame.kps.octave),
        kf_angle=set_row(state.kf_angle, k, frame.kps.angle),
        kf_desc=set_row(state.kf_desc, k, frame.kps.desc),
        kf_kp_valid=set_row(state.kf_kp_valid, k, frame.kps.valid),
        kf_mp=set_row(state.kf_mp, k, kp_mp),
        mp_obs_tbl=flat_tbl.reshape(M + 1, NOBS_DESC)[:M],
        mp_obs_cnt=pad_row(state.mp_obs_cnt).index_add(
            0, mp_ids, obs_mask.to(torch.int32))[:M],
        n_kfs=k + 1,
    )
    return state, k


def commit_keyframe(state: MapState, frame: Frame, q, t, frame_id,
                    kp_to_mp: torch.Tensor, need, allow_far, cfg: SlamConfig):
    """Predicated keyframe insertion + point spawning + incremental point
    stats (``Tracking::CreateNewKeyFrame``). When ``need`` is False every
    write goes to the uncommitted row or a spare row and the counters do
    not advance. Spawns every unmatched keypoint with depth that is close
    (depth < th_depth * baseline), or any depth where ``allow_far`` (the
    initialization frame): the reference's call with ``close_only=True,
    max_spawn=P``, whose spawn cap never binds. Returns (state, kf_mp_row)."""
    cam = cfg.camera
    P, M = state.P, state.M
    dev = state.kf_q.device
    i64 = torch.int64
    k = torch.clamp(state.n_kfs, max=state.K - 1)
    kp_mp = torch.where(frame.kps.valid & need, kp_to_mp,
                        torch.full_like(kp_to_mp, -1))

    state = state._replace(
        kf_q=set_row(state.kf_q, k, q),
        kf_t=set_row(state.kf_t, k, t),
        kf_valid=set_row(state.kf_valid, k,
                          need | (state.kf_valid[k] & (state.n_kfs > k))),
        kf_frame_id=set_row(state.kf_frame_id, k,
                             torch.as_tensor(frame_id, dtype=torch.int32,
                                             device=dev)),
        kf_uv=set_row(state.kf_uv, k, frame.uv),
        kf_ur=set_row(state.kf_ur, k, frame.u_right),
        kf_depth=set_row(state.kf_depth, k, frame.depth),
        kf_octave=set_row(state.kf_octave, k, frame.kps.octave),
        kf_angle=set_row(state.kf_angle, k, frame.kps.angle),
        kf_desc=set_row(state.kf_desc, k, frame.kps.desc),
        kf_kp_valid=set_row(state.kf_kp_valid, k, frame.kps.valid & need),
        kf_mp=set_row(state.kf_mp, k, kp_mp),
    )

    # --- incremental stats for points matched by this keyframe
    qi, ti = se3.inverse(q, t)
    ow = se3.camera_center(q, t)
    obs_mask = (kp_mp >= 0) & need
    mp_ids = torch.where(obs_mask, kp_mp.to(i64), torch.full_like(kp_mp, M, dtype=i64))
    kp_c = torch.clamp(kp_mp, min=0).to(i64)
    pw = state.mp_pos[kp_c]
    d = pw - ow
    dist = torch.linalg.norm(d, dim=-1)
    dirs = d / torch.clamp(dist[:, None], min=1e-9)
    sf = torch.pow(torch.full_like(dist, cfg.orb.scale_factor),
                   frame.kps.octave.to(torch.float32))
    sf_span = cfg.orb.scale_factor ** (cfg.orb.n_levels - 1)
    max_d = dist * sf
    min_d = max_d / sf_span

    dir_sum = pad_row(state.mp_dir_sum).index_add(
        0, mp_ids, torch.where(obs_mask[:, None], dirs,
                               torch.zeros_like(dirs)))[:M]
    # ring-buffer slot from the PRE-increment count
    slot = (state.mp_obs_cnt[kp_c] % NOBS_DESC).to(i64)
    flat_idx = k * P + torch.arange(P, dtype=torch.int32, device=dev)
    tbl = pad_row(state.mp_obs_tbl)
    flat_tbl = set_rows(tbl.reshape(-1), mp_ids * NOBS_DESC + slot, flat_idx)
    obs_tbl = flat_tbl.reshape(M + 1, NOBS_DESC)[:M]
    obs_cnt = pad_row(state.mp_obs_cnt).index_add(
        0, mp_ids, obs_mask.to(torch.int32))[:M]
    norm = torch.linalg.norm(dir_sum, dim=-1, keepdim=True)
    zero = torch.zeros_like(dist)
    state = state._replace(
        mp_dir_sum=dir_sum,
        mp_obs_cnt=obs_cnt,
        mp_obs_tbl=obs_tbl,
        mp_normal=torch.where((obs_cnt > 0)[:, None],
                              dir_sum / torch.clamp(norm, min=1e-9),
                              state.mp_normal),
        mp_max_dist=set_rows(state.mp_max_dist, mp_ids,
                              torch.where(obs_mask, 1.2 * max_d, zero)),
        mp_min_dist=set_rows(state.mp_min_dist, mp_ids,
                              torch.where(obs_mask, 0.8 * min_d, zero)),
        mp_desc=set_rows(state.mp_desc, mp_ids,
                          torch.where(obs_mask[:, None], frame.kps.desc,
                                      torch.zeros_like(frame.kps.desc))),
    )

    # --- predicated spawning (close points)
    depth = frame.depth
    close = (depth < cam.bf / cam.fx * cam.th_depth) | allow_far
    eligible = frame.kps.valid & (depth > 0) & (kp_mp < 0) & need & close
    ranks = torch.cumsum(eligible.to(torch.int32), 0, dtype=torch.int32) - 1
    spawn = eligible & (ranks < M - state.n_mps)
    new_id = torch.where(spawn, state.n_mps + ranks, torch.full_like(ranks, -1))

    xy = torch.stack([(frame.uv[:, 0] - cam.cx) / cam.fx,
                      (frame.uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    xc = torch.cat([xy * depth[:, None], depth[:, None]], dim=-1)
    xw = se3.apply(qi, ti, xc)
    tgt = torch.where(spawn, new_id.to(i64), torch.full_like(new_id, M, dtype=i64))
    dirs_s = xw - ow
    dist_s = torch.linalg.norm(dirs_s, dim=-1)
    max_ds = dist_s * sf
    min_ds = max_ds / sf_span
    unit_s = dirs_s / torch.clamp(dist_s[:, None], min=1e-9)

    def scat(pool, vals):
        return pad_row(pool).index_put((tgt,), vals)[:M]

    ones = torch.ones((P,), dtype=torch.int32, device=dev)
    new_tbl = torch.full((P, NOBS_DESC), -1, dtype=torch.int32, device=dev)
    new_tbl[:, 0] = flat_idx
    kf_mp_row = torch.where(spawn, new_id, kp_mp)
    state = state._replace(
        mp_pos=scat(state.mp_pos, xw),
        mp_valid=scat(state.mp_valid, spawn),
        mp_desc=scat(state.mp_desc, frame.kps.desc),
        mp_normal=scat(state.mp_normal, unit_s),
        mp_min_dist=scat(state.mp_min_dist, 0.8 * min_ds),
        mp_max_dist=scat(state.mp_max_dist, 1.2 * max_ds),
        mp_first_kf=scat(state.mp_first_kf, ones * k),
        mp_dir_sum=scat(state.mp_dir_sum, unit_s),
        mp_obs_cnt=scat(state.mp_obs_cnt, ones),
        mp_visible=scat(state.mp_visible, ones),
        mp_found=scat(state.mp_found, ones),
        mp_obs_tbl=scat(state.mp_obs_tbl, new_tbl),
        kf_mp=set_row(state.kf_mp, k, kf_mp_row),
        n_kfs=state.n_kfs + need.to(torch.int32),
        n_mps=state.n_mps + torch.sum(spawn, dtype=torch.int32),
    )
    return state, kf_mp_row


# ----------------------------------------------------- local-mapping passes

def _live_observations(state: MapState):
    """The observation table flattened: (flat_mp (K*P,) int32 with -1 on
    invalid keyframes, ok (K*P,) bool, tgt (K*P,) int64 with M where not
    ok)."""
    obs = torch.where(state.kf_valid[:, None], state.kf_mp,
                      torch.full_like(state.kf_mp, -1))
    flat = obs.reshape(-1)
    ok = flat >= 0
    tgt = torch.where(ok, flat.to(torch.int64),
                      torch.full_like(flat, state.M, dtype=torch.int64))
    return flat, ok, tgt


def _count(tgt: torch.Tensor, ok: torch.Tensor, M: int) -> torch.Tensor:
    cnt = torch.zeros((M + 1,), dtype=torch.int32, device=tgt.device)
    return cnt.index_add(0, tgt, ok.to(torch.int32))[:M]


def observation_count(state: MapState) -> torch.Tensor:
    """(M,) int32 number of keyframes observing each map point."""
    _, ok, tgt = _live_observations(state)
    return _count(tgt, ok, state.M)


def _distinctive_descriptors(obs_tbl: torch.Tensor, have: torch.Tensor,
                             desc_flat: torch.Tensor) -> torch.Tensor:
    """Per map point, the observation descriptor with minimum median Hamming
    distance to that point's other observations
    (``MapPoint::ComputeDistinctiveDescriptors``, ``MapPoint.cc:288-361``),
    over the whole pool from the per-point observation ring buffer
    (``mp_obs_tbl``: the newest NOBS_DESC observations).

    obs_tbl (M, NOBS) flat observation indices; have (M, NOBS) validity;
    desc_flat (KP, 8) int32. Returns (M, 8) int32 (zeros where no obs).
    Among equal medians the lowest slot wins, as ``jnp.argmin`` picks it.
    """
    KP = desc_flat.shape[0]
    NOBS = obs_tbl.shape[1]
    desc_pad = torch.cat([desc_flat, torch.zeros_like(desc_flat[:1])], dim=0)
    idx = torch.where(have, obs_tbl.to(torch.int64),
                      torch.full_like(obs_tbl, KP, dtype=torch.int64))
    d = desc_pad[idx]                                       # (M, NOBS, 8)
    ham = torch.sum(popcount(d[:, :, None, :] ^ d[:, None, :, :]), dim=-1,
                    dtype=torch.int32)                      # (M, NOBS, NOBS)
    big = 1 << 10
    ham = torch.where(have[:, :, None] & have[:, None, :], ham,
                      torch.full_like(ham, big))
    # median over each candidate's distances to the valid observations
    # (self-distance 0 included, matching the original's vDists)
    sortd, _ = torch.sort(ham, dim=-1)
    nv = torch.sum(have, dim=-1)                            # (M,) int64
    med_idx = torch.clamp((nv - 1) // 2, 0, NOBS - 1)
    med = torch.gather(sortd, 2, med_idx[:, None, None].expand(-1, NOBS, 1))
    med = torch.where(have, med[..., 0], torch.full_like(med[..., 0], big))
    slots = torch.arange(NOBS, dtype=torch.int32, device=med.device)
    best = (torch.min(med * NOBS + slots, dim=-1).values % NOBS).to(
        torch.int64)                                        # (M,)
    return torch.gather(d, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]


def refresh_point_stats(state: MapState, cfg: SlamConfig) -> MapState:
    """Recompute viewing normals, scale-invariance bands and representative
    descriptors for all map points in one pass over the observation table
    (``MapPoint::UpdateNormalAndDepth`` ``MapPoint.cc:388-452``,
    ``ComputeDistinctiveDescriptors`` ``MapPoint.cc:288-361``).

    Among a point's observations the descriptor with minimum median Hamming
    distance to the others is kept, evaluated over the newest ``NOBS_DESC``
    observations per point. Ring-buffer entries are validated against the
    live observation table first (fusion and culling leave stale entries
    behind); a point whose whole buffer is stale falls back to its newest
    observation's descriptor and re-seeds the buffer with it. Also rebuilds
    the incremental pools (``mp_dir_sum``, ``mp_obs_cnt``) so that
    ``commit_keyframe`` stays consistent."""
    K, P, M = state.K, state.P, state.M
    dev = state.kf_q.device
    i32, i64 = torch.int32, torch.int64
    flat_mp, ok, tgt = _live_observations(state)
    flat_c = torch.clamp(flat_mp, min=0).to(i64)

    centers = se3.camera_center(state.kf_q, state.kf_t)            # (K, 3)
    cen = centers.repeat_interleave(P, dim=0)                      # (K*P, 3)
    d = state.mp_pos[flat_c] - cen
    dist = torch.linalg.norm(d, dim=-1)
    dirs = d / torch.clamp(dist[:, None], min=1e-9)

    nsum = torch.zeros((M + 1, 3), dtype=torch.float32, device=dev).index_add(
        0, tgt, torch.where(ok[:, None], dirs, torch.zeros_like(dirs)))[:M]
    normal = nsum / torch.clamp(
        torch.linalg.norm(nsum, dim=-1, keepdim=True), min=1e-9)

    def scatter_max(idx, vals):
        zero = torch.zeros((M + 1,), dtype=vals.dtype, device=dev)
        return zero.scatter_reduce(0, idx, vals, reduce="amax")[:M]

    # scale band + descriptor from the newest observation
    kf_ids = torch.arange(K, dtype=i32, device=dev).repeat_interleave(P)
    newest = scatter_max(tgt, torch.where(ok, kf_ids + 1,
                                          torch.zeros_like(kf_ids))) - 1
    has_obs = newest >= 0
    is_newest = ok & (kf_ids == newest[flat_c])
    tgt_new = torch.where(is_newest, flat_c, torch.full_like(flat_c, M))
    dist_new = scatter_max(tgt_new, torch.where(is_newest, dist,
                                                torch.zeros_like(dist)))
    oct_flat = state.kf_octave.reshape(-1)
    oct_new = scatter_max(tgt_new, torch.where(is_newest, oct_flat,
                                               torch.zeros_like(oct_flat)))
    sf = torch.pow(torch.full_like(dist_new, cfg.orb.scale_factor),
                   oct_new.to(torch.float32))
    max_d = dist_new * sf
    min_d = max_d / (cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))
    desc_flat = state.kf_desc.reshape(-1, 8)
    tbl = state.mp_obs_tbl
    t_kf = torch.clamp(tbl // P, 0, K - 1).to(i64)
    t_kp = torch.clamp(tbl % P, 0, P - 1).to(i64)
    have = ((tbl >= 0) & state.kf_valid[t_kf]
            & (state.kf_mp[t_kf, t_kp]
               == torch.arange(M, dtype=i32, device=dev)[:, None]))
    desc = _distinctive_descriptors(tbl, have, desc_flat)
    keep = state.mp_valid & has_obs
    flat_pos = torch.arange(K * P, dtype=i32, device=dev)
    flat_newest = scatter_max(tgt_new, torch.where(
        is_newest, flat_pos, torch.zeros_like(flat_pos)))
    buffered = torch.any(have, dim=-1)
    desc = torch.where(buffered[:, None], desc,
                       desc_flat[flat_newest.to(i64)])
    seed = torch.full((M, NOBS_DESC), -1, dtype=i32, device=dev)
    seed[:, 0] = flat_newest
    tbl = torch.where((keep & ~buffered)[:, None], seed, tbl)
    return state._replace(
        mp_normal=torch.where(keep[:, None], normal, state.mp_normal),
        mp_max_dist=torch.where(keep, 1.2 * max_d, state.mp_max_dist),
        mp_min_dist=torch.where(keep, 0.8 * min_d, state.mp_min_dist),
        mp_desc=torch.where(keep[:, None], desc, state.mp_desc),
        mp_obs_tbl=tbl,
        mp_dir_sum=torch.where(keep[:, None], nsum, state.mp_dir_sum),
        mp_obs_cnt=torch.where(state.mp_valid, _count(tgt, ok, M),
                               state.mp_obs_cnt),
    )


def _repack(keep: torch.Tensor):
    """Order-preserving packing of the rows where ``keep`` to the front of
    a pool of N rows. Returns (remap (N,) int32: old row -> new row or -1,
    inv (N,) int64: new row -> old row for the live rows, live (N,) bool,
    n_valid () int32)."""
    N = keep.shape[0]
    dev = keep.device
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    new_idx = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    remap = torch.where(keep, new_idx, torch.full_like(new_idx, -1))
    # kept rows land on distinct slots; the others all go to the spare one
    tgt = torch.where(keep, new_idx, torch.full_like(new_idx, N)).to(
        torch.int64)
    inv = torch.zeros((N + 1,), dtype=torch.int64, device=dev).index_put(
        (tgt,), rows.to(torch.int64))[:N]
    n_valid = torch.sum(keep, dtype=torch.int32)
    return remap, inv, rows < n_valid, n_valid


def _gather_live(pool: torch.Tensor, inv: torch.Tensor, live: torch.Tensor,
                 fill=0) -> torch.Tensor:
    out = pool[inv]
    mask = live.reshape((-1,) + (1,) * (pool.dim() - 1))
    return torch.where(mask, out, torch.full_like(out, fill))


def compact_points(state: MapState):
    """Re-pack valid map points to the front of the pool so that culled and
    fused rows are reused by future spawns (``Map::EraseMapPoint``,
    ``Map.cc:69-78``). Without this ``n_mps`` only grows and a long
    sequence exhausts the pool even though culling keeps the live count
    bounded.

    Live rows keep their relative order, so age (``mp_first_kf``) and the
    ring buffers survive. Returns (state, remap (M,) int32: old id -> new
    id, -1 if culled). Callers that hold map-point ids across the call (the
    tracker's ``last_mp``) must re-index through ``remap``."""
    remap, inv, live, n_valid = _repack(state.mp_valid)

    def g(pool, fill=0):
        return _gather_live(pool, inv, live, fill)

    kf_mp = torch.where(
        state.kf_mp >= 0,
        remap[torch.clamp(state.kf_mp, min=0).to(torch.int64)],
        torch.full_like(state.kf_mp, -1))
    state = state._replace(
        kf_mp=kf_mp,
        mp_pos=g(state.mp_pos),
        mp_valid=live,
        mp_desc=g(state.mp_desc),
        mp_normal=g(state.mp_normal),
        mp_min_dist=g(state.mp_min_dist),
        mp_max_dist=g(state.mp_max_dist, fill=1),
        mp_first_kf=g(state.mp_first_kf, fill=-1),
        mp_dir_sum=g(state.mp_dir_sum),
        mp_obs_cnt=g(state.mp_obs_cnt),
        mp_visible=g(state.mp_visible, fill=1),
        mp_found=g(state.mp_found, fill=1),
        mp_obs_tbl=g(state.mp_obs_tbl, fill=-1),
        n_mps=n_valid,
    )
    return state, remap


def compact_keyframes(state: MapState):
    """Re-pack valid keyframes to the front of the pool, freeing culled
    rows for reuse (``Map::EraseKeyFrame``, ``Map.cc:81-97``;
    ``KeyFrame::SetBadFlag`` re-parenting, ``KeyFrame.cc:553-671``).

    Order-preserving, so the insertion-order chain stays chronological.
    ``mp_first_kf`` entries whose keyframe was culled re-anchor to the
    nearest surviving predecessor; ring-buffer entries on culled keyframes
    are dropped (the refresh re-seeds them).

    Returns (state, remap (K,) int32: old row -> new row, -1 if culled).
    Host-side consumers (``FrameRecord.ref_kf``) must be re-based through
    ``remap``: see ``System.compact_keyframe_pool``."""
    K, P = state.K, state.P
    i64 = torch.int64
    keep = state.kf_valid
    remap, inv, live, n_valid = _repack(keep)
    rows = torch.arange(K, dtype=torch.int32, device=keep.device)

    # nearest surviving predecessor of every old row (for re-anchoring)
    anc = torch.cummax(torch.where(keep, rows, torch.full_like(rows, -1)),
                       dim=0).values
    anchor_remap = torch.where(anc >= 0, remap[torch.clamp(anc, min=0).to(i64)],
                               torch.zeros_like(anc))

    def g(pool, fill=0):
        return _gather_live(pool, inv, live, fill)

    first = torch.clamp(state.mp_first_kf, 0, K - 1).to(i64)
    mp_first = torch.where(state.mp_first_kf >= 0, anchor_remap[first],
                           torch.full_like(state.mp_first_kf, -1))
    # observation ring buffer: flat kf*P + kp indices follow their keyframe
    tbl = state.mp_obs_tbl
    t_kf = torch.clamp(tbl // P, 0, K - 1).to(i64)
    tbl_new = torch.where((tbl >= 0) & keep[t_kf],
                          remap[t_kf] * P + tbl % P, torch.full_like(tbl, -1))
    state = state._replace(
        kf_q=g(state.kf_q),
        kf_t=g(state.kf_t),
        kf_valid=live,
        kf_frame_id=g(state.kf_frame_id, fill=-1),
        kf_uv=g(state.kf_uv),
        kf_ur=g(state.kf_ur, fill=-1),
        kf_depth=g(state.kf_depth, fill=-1),
        kf_octave=g(state.kf_octave),
        kf_angle=g(state.kf_angle),
        kf_desc=g(state.kf_desc),
        kf_kp_valid=g(state.kf_kp_valid),
        kf_mp=g(state.kf_mp, fill=-1),
        mp_first_kf=mp_first,
        mp_obs_tbl=tbl_new,
        n_kfs=n_valid,
    )
    return state, remap


def covisibility(state: MapState) -> torch.Tensor:
    """(K, K) int32 shared-observation counts: the covisibility graph
    (``KeyFrame::UpdateConnections``, ``KeyFrame.cc:344-460``) as one
    incidence matmul in f32 (TF32 is off package-wide, and counts up to P
    are exact in f32)."""
    K, M = state.K, state.M
    obs = torch.where(state.kf_valid[:, None], state.kf_mp,
                      torch.full_like(state.kf_mp, -1))
    ok = obs >= 0
    tgt = torch.where(ok, obs.to(torch.int64),
                      torch.full_like(obs, M, dtype=torch.int64))
    inc = torch.zeros((K, M + 1), dtype=torch.float32, device=obs.device)
    # a point seen twice by one keyframe writes the same 1.0 twice
    inc = inc.scatter(1, tgt, ok.to(torch.float32))
    inc = inc[:, :M] * state.mp_valid[None, :]
    cov = inc @ inc.T
    return (cov - torch.diag(torch.diagonal(cov))).to(torch.int32)
