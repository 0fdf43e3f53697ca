"""Tracking front end: per-frame RGB-D pose estimation against the map.

Port of ``orb_slam_2_ros_tpu/pipeline/tracking.py`` for the RGB-D sensor
(``Tracking.cc``: TrackWithMotionModel -> TrackReferenceKeyFrame fallback ->
TrackLocalMap -> NeedNewKeyFrame -> CreateNewKeyFrame). The reference's
``lax.scan`` over a chunk becomes a Python loop over its frames. The
stereo/RGB-D initialization, the reference-keyframe fallback, the widened
motion-model retry and the keyframe commit stay predicated: both sides are
computed and ``torch.where`` selects, exactly as the reference selects, so
nothing in the frame loop waits for the device. Per-frame outputs stay on
the device until ``flush()``.

Not in this slice: localization-only mode (its visual-odometry points),
the mono and stereo sensors, and relocalization.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import frame as frame_mod
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.solvers.pose_opt import pose_optimization

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3


class TrackCarry(NamedTuple):
    """Device-resident tracking context carried across frames. The vo_*
    fields and last_vo keep the reference's layout; they stay inert until
    localization-only mode is ported."""

    m: map_state.MapState
    initialized: torch.Tensor   # () bool
    q: torch.Tensor
    t: torch.Tensor
    vel_q: torch.Tensor
    vel_t: torch.Tensor
    last_mp: torch.Tensor       # (P,) kp -> mp of the previous frame
    last_oct: torch.Tensor
    last_angle: torch.Tensor
    ref_tracked: torch.Tensor   # () int32 inliers at the last KF insertion
    since_kf: torch.Tensor      # () int32
    frame_id: torch.Tensor      # () int32
    since_reloc: torch.Tensor   # () int32 frames since the last relocalization
    vo_pos: torch.Tensor        # (P, 3)
    vo_desc: torch.Tensor       # (P, 8) int32
    vo_oct: torch.Tensor        # (P,) int32
    vo_ok: torch.Tensor         # (P,) bool
    last_vo: torch.Tensor       # (P,) bool


@dataclasses.dataclass
class FrameRecord:
    """Host-side per-frame record."""

    frame_id: int
    timestamp: float
    state: int
    n_matches_frame: int
    n_inliers: int
    is_keyframe: bool
    R_wc: np.ndarray
    c_w: np.ndarray
    n_map_inliers: int = 0
    ref_kf: int = -1
    q_cr: np.ndarray = None   # (4,) T_cr rotation (wxyz)
    t_cr: np.ndarray = None   # (3,) T_cr translation


def _quat_mul_np(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw])


def _quat_rotate_np(q, v):
    t = 2.0 * np.cross(q[1:], v)
    return v + q[0] * t + np.cross(q[1:], t)


def _quat_to_R(qw, qx, qy, qz):
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])


def _track_core(cfg: SlamConfig, m: map_state.MapState, frame, q_pred,
                t_pred, q_last, t_last, last_mp, last_oct, last_angle,
                since_reloc):
    """Two-stage matching + pose LM (TrackWithMotionModel + TrackLocalMap,
    ``Tracking.cc:971-1093``)."""
    tc = cfg.tracking
    i64 = torch.int64
    th_close = cfg.camera.bf / cfg.camera.fx * cfg.camera.th_depth
    last_c = torch.clamp(last_mp, min=0).to(i64)
    src_ok = (last_mp >= 0) & m.mp_valid[last_c]
    kp_to_src, _ = matcher.search_by_projection_pose(
        m.mp_pos[last_c], m.mp_desc[last_c], last_oct, src_ok, q_pred,
        t_pred, frame, cfg, th=15.0, src_angle=last_angle,
        widen_below=tc.min_matches_motion)
    neg = torch.full_like(kp_to_src, -1)
    kp_mp1 = torch.where(kp_to_src >= 0,
                         last_mp[torch.clamp(kp_to_src, min=0).to(i64)], neg)

    # TrackReferenceKeyFrame fallback (Tracking.cc:328-339, :839-868),
    # predicated: both branches computed, one selected
    r = torch.clamp(m.n_kfs - 1, min=0).to(i64)
    ref_mp = m.kf_mp[r]
    ref_ok = (m.kf_kp_valid[r] & (ref_mp >= 0)
              & m.mp_valid[torch.clamp(ref_mp, min=0).to(i64)] & (m.n_kfs > 0))
    kp_to_ref, _ = matcher.search_reference_kf(
        m.kf_desc[r], ref_ok, m.kf_angle[r], frame, cfg)
    kp_mp_ref = torch.where(kp_to_ref >= 0,
                            ref_mp[torch.clamp(kp_to_ref, min=0).to(i64)], neg)
    n_mot = torch.sum(kp_mp1 >= 0, dtype=torch.int32)
    n_ref = torch.sum(kp_mp_ref >= 0, dtype=torch.int32)
    use_ref = ((n_mot < tc.min_matches_motion)
               & (n_ref >= tc.min_matches_reference) & (n_ref > n_mot))
    kp_mp1 = torch.where(use_ref, kp_mp_ref, kp_mp1)
    q_start = torch.where(use_ref, q_last, q_pred)
    t_start = torch.where(use_ref, t_last, t_pred)

    q1, t1, inl1, n1 = pose_optimization(
        q_start, t_start, m.mp_pos[torch.clamp(kp_mp1, min=0).to(i64)],
        frame.uv, frame.u_right, frame.kps.octave, kp_mp1 >= 0, cfg)
    kp_mp1 = torch.where(inl1, kp_mp1, neg)

    tv = matcher.frustum_check(q1, t1, m.mp_pos, m.mp_normal, m.mp_min_dist,
                               m.mp_max_dist, m.mp_valid, cfg)
    # points already matched by the motion-model stage count as visible too
    M = m.M
    seen_idx = torch.where(kp_mp1 >= 0, kp_mp1.to(i64),
                           torch.full_like(kp_mp1, M, dtype=i64))
    seen1 = torch.zeros((M + 1,), dtype=torch.bool, device=kp_mp1.device)
    seen1 = seen1.index_fill(0, seen_idx, True)[:M]
    vis_mask = tv.ok | seen1
    # compact the frustum survivors into a bounded candidate set
    CAND = min(cfg.map.local_map_cap, M)
    rank = torch.cumsum(tv.ok.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(tv.ok & (rank < CAND), rank.to(i64),
                       torch.full_like(rank, CAND, dtype=i64))
    cand = torch.zeros((CAND + 1,), dtype=torch.int32, device=kp_mp1.device)
    cand = cand.index_put((slot,), torch.arange(M, dtype=torch.int32,
                                                device=kp_mp1.device))[:CAND]
    cand_ok = (torch.arange(CAND, device=kp_mp1.device)
               < torch.sum(tv.ok, dtype=torch.int32))
    cand_l = cand.to(i64)
    tv_c = matcher.TrackInView(
        uv=tv.uv[cand_l], u_right=tv.u_right[cand_l], dist=tv.dist[cand_l],
        view_cos=tv.view_cos[cand_l], pred_level=tv.pred_level[cand_l],
        ok=cand_ok)
    # window th=3 for RGB-D, widened to 5 for two frames after a
    # relocalization (SearchLocalPoints, Tracking.cc:1322-1330)
    th_lm = torch.where(since_reloc < 2, 5.0, 3.0)
    kp_to_c, _ = matcher.search_local_map(tv_c, m.mp_desc[cand_l], frame,
                                          kp_mp1 >= 0, cfg, th=th_lm)
    kp_to_mp2 = torch.where(kp_to_c >= 0,
                            cand[torch.clamp(kp_to_c, min=0).to(i64)], neg)
    kp_mp = torch.where(kp_mp1 >= 0, kp_mp1, kp_to_mp2)
    q2, t2, inl2, n2 = pose_optimization(
        q1, t1, m.mp_pos[torch.clamp(kp_mp, min=0).to(i64)], frame.uv,
        frame.u_right, frame.kps.octave, kp_mp >= 0, cfg)
    n_map = torch.sum(inl2 & (kp_mp >= 0), dtype=torch.int32)
    kp_mp = torch.where(inl2, kp_mp, neg)
    close = frame.valid & (frame.depth > 0) & (frame.depth < th_close)
    n_close_tr = torch.sum(close & (kp_mp >= 0), dtype=torch.int32)
    n_close_free = torch.sum(close & (kp_mp < 0), dtype=torch.int32)
    return q2, t2, kp_mp, n1, n2, n_map, n_close_tr, n_close_free, vis_mask


def _frame_step(cfg: SlamConfig, carry: TrackCarry, frame, q_init, t_init):
    """One frame: track, bump visibility, initialize or decide and commit a
    keyframe (all predicated), update the carry. Returns (carry, out (20,))."""
    tc = cfg.tracking
    m = carry.m
    f32 = torch.float32

    q_pred, t_pred = se3.compose(carry.vel_q, carry.vel_t, carry.q, carry.t)
    q2, t2, kp_mp, n1, n2, n_map, nct, ncf, vis_mask = _track_core(
        cfg, m, frame, q_pred, t_pred, carry.q, carry.t, carry.last_mp,
        carry.last_oct, carry.last_angle, carry.since_reloc)
    good = (n2 >= tc.min_inliers_local_map) & carry.initialized
    m = map_state.bump_visibility(m, vis_mask, kp_mp, carry.initialized)

    # stereo/RGB-D initialization (predicated)
    n_depth = torch.sum(frame.valid & (frame.depth > 0), dtype=torch.int32)
    can_init = ~carry.initialized & (n_depth >= tc.min_init_stereo_kps)

    # keyframe decision (NeedNewKeyFrame, Tracking.cc:1103)
    capacity_ok = (m.M - m.n_mps >= 1024) & (m.n_kfs < m.K)
    need_close = (nct < 100) & (ncf > 70)
    c1 = carry.since_kf >= tc.max_frames_between_kf
    c2 = (n2 < 0.75 * carry.ref_tracked.to(f32)) | need_close
    need_kf = good & capacity_ok & (n2 > 15) & (c1 | c2)

    # predicated commit (insert + spawn)
    commit = need_kf | (can_init & capacity_ok)
    q_c = torch.where(can_init, q_init, q2)
    t_c = torch.where(can_init, t_init, t2)
    kp_mp_c = torch.where(can_init, torch.full_like(kp_mp, -1), kp_mp)
    m, kf_row = map_state.commit_keyframe(
        m, frame, q_c, t_c, carry.frame_id, kp_mp_c, commit, can_init, cfg)
    kp_mp_out = torch.where(commit, kf_row, kp_mp)
    n_spawned = torch.sum(kf_row >= 0, dtype=torch.int32)

    track_ok = good | can_init
    q_new = torch.where(can_init, q_init, torch.where(good, q2, carry.q))
    t_new = torch.where(can_init, t_init, torch.where(good, t2, carry.t))
    vq, vt = se3.relative(q2, t2, carry.q, carry.t)
    vel_q = torch.where(good, vq, torch.where(can_init, _unit_quat(q_init),
                                              carry.vel_q))
    vel_t = torch.where(good, vt, torch.where(can_init, torch.zeros_like(vt),
                                              carry.vel_t))
    initialized = carry.initialized | can_init

    one = torch.ones((), dtype=torch.int32, device=n2.device)
    new_carry = carry._replace(
        m=m, initialized=initialized, q=q_new, t=t_new,
        vel_q=vel_q, vel_t=vel_t,
        last_mp=torch.where(track_ok, kp_mp_out, carry.last_mp),
        last_oct=torch.where(track_ok, frame.kps.octave, carry.last_oct),
        last_angle=torch.where(track_ok, frame.kps.angle, carry.last_angle),
        last_vo=torch.where(track_ok, torch.zeros_like(carry.last_vo),
                            carry.last_vo),
        ref_tracked=torch.where(can_init, n_spawned,
                                torch.where(need_kf, n2, carry.ref_tracked)),
        since_kf=torch.where(commit, torch.zeros_like(carry.since_kf),
                             carry.since_kf + one),
        frame_id=carry.frame_id + one,
        since_reloc=torch.clamp(carry.since_reloc + one, max=1000))

    state_code = torch.where(
        track_ok, OK, torch.where(initialized, LOST, NOT_INITIALIZED))
    qi, ti = se3.inverse(q_new, t_new)
    n1_out = torch.where(can_init, n_spawned, n1)
    n2_out = torch.where(can_init, n_spawned, n2)
    # reference-keyframe relative pose T_cr = T_cw * T_rw^-1
    r_ref = m.n_kfs - 1
    rr = torch.clamp(r_ref, min=0).to(torch.int64)
    q_cr, t_cr = se3.relative(q_new, t_new, m.kf_q[rr], m.kf_t[rr])
    out = torch.cat([
        torch.stack([n1_out.to(f32), n2_out.to(f32), commit.to(f32),
                     state_code.to(f32)]),
        qi, ti, r_ref.to(f32)[None], q_cr, t_cr, n_map.to(f32)[None]])
    return new_carry, out


def _unit_quat(like):
    """The identity quaternion on ``like``'s device, without a host copy."""
    return torch.cat([torch.ones_like(like[:1]), torch.zeros_like(like[1:])])


def build_frame(cfg: SlamConfig, gray_u8: torch.Tensor, depth_mm: torch.Tensor):
    """Frame from wire-format inputs: u8 gray, integer millimetre depth."""
    gray = gray_u8.to(torch.float32)
    depth = depth_mm.to(torch.float32) * 1e-3
    return frame_mod.build_rgbd(gray, depth, cfg)


class Tracker:
    """Per-frame RGB-D tracking; stereo/RGB-D initialization is predicated
    inside the frame step."""

    CHUNK = 16   # frames moved to the device per transfer

    def __init__(self, cfg: SlamConfig, device=None):
        if cfg.localization_only:
            raise NotImplementedError(
                "localization-only mode is not ported yet")
        if cfg.sensor != SENSOR_RGBD:
            raise NotImplementedError("only the RGB-D sensor is ported yet")
        self.cfg = cfg
        self.device = torch.device(device if device is not None else "cpu")
        self.state = NO_IMAGES_YET
        self.records: List[FrameRecord] = []
        self._pending = []          # [(timestamps, (k, 20) device outs)]
        self._q_init = se3.quat_exp(torch.tensor(
            [cfg.initial_pitch, 0.0, 0.0], dtype=torch.float32,
            device=self.device))
        self._t_init = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.carry = self._fresh_carry(map_state.empty(cfg, self.device))

    def _fresh_carry(self, m: map_state.MapState) -> TrackCarry:
        P = self.cfg.orb.max_kps
        dev = self.device
        i32 = torch.int32

        def scalar(v, dtype=i32):
            return torch.tensor(v, dtype=dtype, device=dev)

        q0, t0 = se3.identity(device=dev)
        return TrackCarry(
            m=m, initialized=scalar(False, torch.bool),
            q=q0, t=t0, vel_q=q0.clone(), vel_t=t0.clone(),
            last_mp=torch.full((P,), -1, dtype=i32, device=dev),
            last_oct=torch.zeros((P,), dtype=i32, device=dev),
            last_angle=torch.zeros((P,), dtype=torch.float32, device=dev),
            ref_tracked=scalar(0), since_kf=scalar(0), frame_id=scalar(0),
            since_reloc=scalar(1000),
            vo_pos=torch.zeros((P, 3), dtype=torch.float32, device=dev),
            vo_desc=torch.zeros((P, 8), dtype=i32, device=dev),
            vo_oct=torch.zeros((P,), dtype=i32, device=dev),
            vo_ok=torch.zeros((P,), dtype=torch.bool, device=dev),
            last_vo=torch.zeros((P,), dtype=torch.bool, device=dev))

    # ------------------------------------------------------------- host API

    @property
    def map(self):
        return self.carry.m

    @property
    def n_kfs(self):
        return int(self.carry.m.n_kfs)

    def to_wire(self, grays, depths):
        """Float images -> wire format: u8 gray, u16 millimetre depth."""
        grays8 = np.clip(np.round(np.asarray(grays, np.float32)),
                         0, 255).astype(np.uint8)
        depth_w = np.clip(np.round(np.asarray(depths, np.float32) * 1e3),
                          0, 65535).astype(np.uint16)
        return grays8, depth_w

    def process_chunk(self, grays: np.ndarray, depths: np.ndarray,
                      timestamps) -> List[FrameRecord]:
        """Track a batch of frames, grays/depths (N, H, W) float images
        (metres for depth). The frame loop never waits for the device;
        the records are fetched once at the end (``flush``)."""
        grays, depths = self.to_wire(grays, depths)
        n = grays.shape[0]
        for w0 in range(0, n, self.CHUNK):
            w1 = min(w0 + self.CHUNK, n)
            g = torch.from_numpy(grays[w0:w1]).to(self.device)
            d = torch.from_numpy(depths[w0:w1].astype(np.int32)).to(self.device)
            outs = []
            for j in range(w1 - w0):
                frame = build_frame(self.cfg, g[j], d[j])
                self.carry, out = _frame_step(self.cfg, self.carry, frame,
                                              self._q_init, self._t_init)
                outs.append(out)
            self._pending.append((list(timestamps[w0:w1]), torch.stack(outs)))
        return self.flush()

    def process(self, gray: np.ndarray, depth: np.ndarray,
                timestamp: float) -> FrameRecord:
        """Single-frame convenience wrapper."""
        return self.process_chunk(gray[None], depth[None], [timestamp])[0]

    def flush(self) -> List[FrameRecord]:
        """Materialize all pending per-frame records (one device fetch)."""
        if not self._pending:
            return []
        fetched = torch.cat([p[1] for p in self._pending]).cpu().numpy()
        ts_all = [t for p in self._pending for t in p[0]]
        recs = []
        for ts, row in zip(ts_all, fetched):
            n1, n2, is_kf, state_f = row[:4]
            qw, qx, qy, qz = row[4:8]
            rec = FrameRecord(
                frame_id=len(self.records), timestamp=ts,
                state=int(state_f), n_matches_frame=int(n1),
                n_inliers=int(n2), is_keyframe=bool(is_kf > 0),
                R_wc=_quat_to_R(qw, qx, qy, qz), c_w=np.array(row[8:11]),
                ref_kf=int(row[11]), q_cr=np.array(row[12:16]),
                t_cr=np.array(row[16:19]), n_map_inliers=int(row[19]))
            self.records.append(rec)
            recs.append(rec)
        self._pending = []
        self.state = recs[-1].state
        return recs

    # ------------------------------------------------------------ trajectory

    def trajectory_wc(self):
        return [(r.R_wc, r.c_w) for r in self.records], \
               [r.timestamp for r in self.records]

    def composed_trajectory(self):
        """Per-frame camera-to-world poses of the OK frames, composed
        through each frame's reference keyframe, ``T_cw = T_cr *
        T_rw(current)`` (``System::SaveTrajectoryTUM``). Returns (poses
        [(R_wc, c_w)], timestamps)."""
        kf_q = self.carry.m.kf_q.cpu().numpy()
        kf_t = self.carry.m.kf_t.cpu().numpy()
        poses, ts = [], []
        for r in self.records:
            if r.ref_kf is None or r.ref_kf < 0 or r.q_cr is None:
                continue
            if r.state != OK:
                continue
            q_cw = _quat_mul_np(r.q_cr, kf_q[r.ref_kf])
            t_cw = _quat_rotate_np(r.q_cr, kf_t[r.ref_kf]) + r.t_cr
            R_cw = _quat_to_R(*q_cw)
            poses.append((R_cw.T, -R_cw.T @ t_cw))
            ts.append(r.timestamp)
        return poses, ts
