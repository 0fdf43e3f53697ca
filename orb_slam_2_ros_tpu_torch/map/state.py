"""MapState: the map as a NamedTuple of fixed-shape tensors.

Port of the tracking slice's part of ``orb_slam_2_ros_tpu/map/state.py``:
keyframes are rows of pooled tensors (pose, features and the kp -> map
point observation table ``kf_mp``), map points are rows of point pools.
Descriptors are int32 words with the reference's uint32 bits.

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


def empty(cfg: SlamConfig, device=None) -> MapState:
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


def _pad(pool: torch.Tensor) -> torch.Tensor:
    """The pool with one spare row at index M for writes that must not land."""
    return torch.cat([pool, torch.zeros_like(pool[:1])], dim=0)


def _set_rows(pool: torch.Tensor, idx: torch.Tensor,
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
    return _pad(pool).index_put((idx,), vals)[:M]


def _set_row(pool: torch.Tensor, k: torch.Tensor, vals: torch.Tensor):
    """``pool.at[k].set(vals)`` for a 0-d index tensor k."""
    return pool.index_copy(0, k.reshape(1).to(torch.int64), vals[None])


def bump_visibility(state: MapState, visible_mask: torch.Tensor,
                    found_ids: torch.Tensor, enable) -> MapState:
    """Per-frame visibility counters (``MapPoint::IncreaseVisible`` /
    ``IncreaseFound``): visible += 1 for every point the frustum pass saw,
    found += 1 for every final pose inlier. ``enable`` gates the update."""
    M = state.M
    vis = state.mp_visible + (visible_mask & enable).to(torch.int32)
    tgt = torch.where((found_ids >= 0) & enable, found_ids.to(torch.int64),
                      torch.full_like(found_ids, M, dtype=torch.int64))
    fnd = _pad(state.mp_found).index_add(
        0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:M]
    return state._replace(mp_visible=vis, mp_found=fnd)


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
        kf_q=_set_row(state.kf_q, k, q),
        kf_t=_set_row(state.kf_t, k, t),
        kf_valid=_set_row(state.kf_valid, k,
                          need | (state.kf_valid[k] & (state.n_kfs > k))),
        kf_frame_id=_set_row(state.kf_frame_id, k,
                             torch.as_tensor(frame_id, dtype=torch.int32,
                                             device=dev)),
        kf_uv=_set_row(state.kf_uv, k, frame.uv),
        kf_ur=_set_row(state.kf_ur, k, frame.u_right),
        kf_depth=_set_row(state.kf_depth, k, frame.depth),
        kf_octave=_set_row(state.kf_octave, k, frame.kps.octave),
        kf_angle=_set_row(state.kf_angle, k, frame.kps.angle),
        kf_desc=_set_row(state.kf_desc, k, frame.kps.desc),
        kf_kp_valid=_set_row(state.kf_kp_valid, k, frame.kps.valid & need),
        kf_mp=_set_row(state.kf_mp, k, kp_mp),
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

    dir_sum = _pad(state.mp_dir_sum).index_add(
        0, mp_ids, torch.where(obs_mask[:, None], dirs,
                               torch.zeros_like(dirs)))[:M]
    # ring-buffer slot from the PRE-increment count
    slot = (state.mp_obs_cnt[kp_c] % NOBS_DESC).to(i64)
    flat_idx = k * P + torch.arange(P, dtype=torch.int32, device=dev)
    tbl = _pad(state.mp_obs_tbl)
    flat_tbl = _set_rows(tbl.reshape(-1), mp_ids * NOBS_DESC + slot, flat_idx)
    obs_tbl = flat_tbl.reshape(M + 1, NOBS_DESC)[:M]
    obs_cnt = _pad(state.mp_obs_cnt).index_add(
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
        mp_max_dist=_set_rows(state.mp_max_dist, mp_ids,
                              torch.where(obs_mask, 1.2 * max_d, zero)),
        mp_min_dist=_set_rows(state.mp_min_dist, mp_ids,
                              torch.where(obs_mask, 0.8 * min_d, zero)),
        mp_desc=_set_rows(state.mp_desc, mp_ids,
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
        return _pad(pool).index_put((tgt,), vals)[:M]

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
        kf_mp=_set_row(state.kf_mp, k, kf_mp_row),
        n_kfs=state.n_kfs + need.to(torch.int32),
        n_mps=state.n_mps + torch.sum(spawn, dtype=torch.int32),
    )
    return state, kf_mp_row
