"""System facade: tracking plus local mapping behind one entry point.

Port of the part of ``orb_slam_2_ros_tpu/pipeline/slam.py`` (``System.cc``)
that the RGB-D path without loop closing runs: construction wires the
tracker and the local mapper, ``track_rgbd`` / ``track_chunk`` replace
``TrackRGBD`` (``System.cc:196``). Per tracker chunk the frames are tracked,
then one mapping step runs if the chunk inserted a keyframe, and the map
and the tracker's last-frame associations go back into the carry.

Not ported yet, each raising ``NotImplementedError``: loop closing and the
global BA (``enable_loop_closing=True``, the reference's default, so a
caller passes ``False``), a vocabulary, map loading and saving, the
monocular and stereo sensors, localization-only mode. Relocalization is not
ported either: a LOST frame is recorded and tracking goes on, as
``Tracker`` alone does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam_2_ros_tpu_torch.pipeline.tracking import (
    NOT_INITIALIZED, FrameRecord, Tracker, _quat_mul_np, _quat_rotate_np)


class System:
    """``device=None`` means the card (``cuda``) and raises where there is
    none; the system runs on the CPU only when asked to (``device="cpu"``).
    """

    # keyframe-pool recycling: once the pool is this full, culled rows are
    # compacted away (Map::EraseKeyFrame, Map.cc:81-97)
    KF_COMPACT_WATERMARK = 0.85

    def __init__(self, cfg: SlamConfig, enable_local_ba: bool = True,
                 ba_window: int = 10, load_map=None,
                 enable_loop_closing: bool = True, vocab=None, device=None):
        if enable_loop_closing:
            raise NotImplementedError(
                "loop closing is not ported yet; pass "
                "enable_loop_closing=False")
        if vocab is not None:
            raise NotImplementedError(
                "a vocabulary serves loop closing and relocalization, which "
                "are not ported yet")
        if load_map is not None:
            raise NotImplementedError("map loading is not ported yet")
        self.cfg = cfg
        # the tracker rejects the sensors and modes that are not ported and
        # resolves the device
        self.tracker = Tracker(cfg, device=device)
        self.device = self.tracker.device
        self.mapper = (LocalMapper(cfg, window=ba_window)
                       if enable_local_ba else None)
        self.n_resets = 0
        self.n_kf_compactions = 0
        self._culled_dev = []      # device scalars, summed when asked for
        self._frame_counter = 0

    # ------------------------------------------------------------- tracking

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> FrameRecord:
        return self.track_chunk(gray[None], depth[None], [timestamp])[0]

    def track_chunk(self, grays, depths, timestamps=None) -> List[FrameRecord]:
        """Track a batch of frames, grays/depths (N, H, W) float images
        (metres for depth): per tracker chunk, track, then one mapping
        step. The step runs only if the chunk inserted a keyframe; that is
        decided from the keyframe count that the chunk's own records carry
        (``ref_kf`` of the last frame), so the gate reads nothing more
        from the device."""
        grays = np.asarray(grays, np.float32)
        depths = np.asarray(depths, np.float32)
        if timestamps is None:
            timestamps = [self._frame_counter + i / 30.0
                          for i in range(len(grays))]
        recs: List[FrameRecord] = []
        C = self.tracker.CHUNK
        K = self.cfg.map.max_kfs
        for w0 in range(0, len(grays), C):
            w1 = min(w0 + C, len(grays))
            chunk = self.tracker.process_chunk(
                grays[w0:w1], depths[w0:w1], timestamps[w0:w1])
            recs.extend(chunk)
            if self.mapper is None:
                continue
            n_kfs = chunk[-1].ref_kf + 1
            carry = self.tracker.carry
            m2, n_culled, last_mp2 = self.mapper.run(
                carry.m, carry.last_mp, allow_compact=True, full=True,
                n_kfs=n_kfs)
            self.tracker.carry = carry._replace(m=m2, last_mp=last_mp2)
            self._culled_dev.append(n_culled)
            if n_kfs >= int(self.KF_COMPACT_WATERMARK * K):
                self.compact_keyframe_pool()
        self._frame_counter += len(grays)
        return recs

    def compact_keyframe_pool(self) -> int:
        """Recycle culled keyframe rows (``Map::EraseKeyFrame``,
        ``Map.cc:81-97``). A rare event that waits for the device: culled
        keyframes stop serving as trajectory reference anchors, so the
        FrameRecords that name one are re-based onto its nearest surviving
        predecessor at the current poses (the ``mTcp`` retention of
        ``KeyFrame::SetBadFlag``, ``KeyFrame.cc:553-671``). Returns the
        number of rows freed."""
        self.tracker.flush()   # pending records still index old rows
        m = self.tracker.carry.m
        m2, remap = map_state.compact_keyframes(m)
        remap_np = remap.cpu().numpy()
        K = len(remap_np)
        n_freed = int(np.sum((remap_np < 0) & (np.arange(K) < int(m.n_kfs))))
        if n_freed == 0:
            return 0
        kf_q = m.kf_q.cpu().numpy()
        kf_t = m.kf_t.cpu().numpy()
        anchor = np.maximum.accumulate(
            np.where(remap_np >= 0, np.arange(K), -1))
        first_kept = int(np.argmax(remap_np >= 0))
        for r in self.tracker.records:
            if r.ref_kf is None or r.ref_kf < 0 or r.q_cr is None:
                continue
            old = r.ref_kf
            if remap_np[old] >= 0:
                r.ref_kf = int(remap_np[old])
                continue
            a = int(anchor[old]) if anchor[old] >= 0 else first_kept
            # T_cw = T_cr . T_rw (current); T_cr' = T_cw . T_aw^-1
            q_cw = _quat_mul_np(r.q_cr, kf_q[old])
            t_cw = _quat_rotate_np(r.q_cr, kf_t[old]) + r.t_cr
            qa, ta = kf_q[a], kf_t[a]
            qa_i = np.array([qa[0], -qa[1], -qa[2], -qa[3]])
            ta_i = -_quat_rotate_np(qa_i, ta)
            r.q_cr = _quat_mul_np(q_cw, qa_i)
            r.t_cr = _quat_rotate_np(q_cw, ta_i) + t_cw
            r.ref_kf = int(remap_np[a])
        self.tracker.carry = self.tracker.carry._replace(m=m2)
        # the mapper's gate is "n_kfs moved past the last post-step count";
        # compaction shrinks n_kfs below that mark, so re-arm the gate, or
        # every keyframe inserted until the count passes the stale value
        # again would skip local mapping
        if self.mapper is not None:
            self.mapper.rearm()
        self.n_kf_compactions += 1
        return n_freed

    def reset(self):
        """Full map + tracker reset (``Tracking::Reset``,
        ``Tracking.cc:1727-1765``)."""
        self.tracker.carry = self.tracker._fresh_carry(
            map_state.empty(self.cfg, self.device))
        self.tracker.state = NOT_INITIALIZED
        if self.mapper is not None:
            self.mapper.rearm()
        self.n_resets += 1

    def flush(self) -> List[FrameRecord]:
        """Fetch all pending frame records."""
        return self.tracker.flush()

    # -------------------------------------------------------------- getters

    @property
    def records(self):
        return self.tracker.records

    @property
    def n_culled_total(self) -> int:
        """Map points culled by all mapping steps so far (reads the
        device)."""
        if not self._culled_dev:
            return 0
        return int(torch.stack(self._culled_dev).sum())
