"""System facade: tracking, local mapping and loop closing behind one
entry point.

Port of ``orb_slam_2_ros_tpu/pipeline/slam.py`` (``System.cc``) but for the
Slice 7b savers: construction wires the tracker, the local mapper, the loop
closer and the relocalizer; ``track_rgbd`` / ``track_chunk`` replace
``TrackRGBD``, ``TrackStereo`` and ``TrackMonocular`` (``System.cc:196``),
the stereo right images riding where RGB-D's depth maps do and mono
passing none. A monocular system first feeds frames one by one to the
two-view initializer (``pipeline/mono_init.py``); the frame that
initializes installs the two-keyframe map, and tracking goes on from the
next frame. Per tracker chunk the frames are tracked, one mapping step runs if
the chunk inserted a keyframe, the loop closer ingests the new keyframes and
detects, an in-flight global BA advances by one chunk, and the detection
verdict of the PREVIOUS chunk is consumed: a correction lands one chunk
after its detection, on a schedule that depends on the chunk count alone.
Then each LOST frame of the chunk gets a relocalization attempt, in order;
at the first success the chunk is replayed around it (``_replay_chunk``),
so tracking resumes at that frame. A map with too few keyframes to
relocalize against is reset (``Tracking.cc:508-516``).

Loop closing is on by default, as in the reference. Without a ``vocab`` the
system trains one from the descriptors of its first chunk's frames
(``_bootstrap_vocabulary``).

Relocalization needs the BoW index, so it runs with loop closing on, in
localization-only mode, or on a loaded map, as in the reference.

Localization-only mode (``cfg.localization_only``, or
``activate_localization_mode``) skips mapping, loop closing, the auto-reset
and the pool compaction; the tracker's keyframe freeze and its
visual-odometry points follow ``cfg.localization_only``, as the
reference's compiled tracker does. While the last frame tracks on fewer
than 10 map inliers, each chunk ends with a relocalization attempt that
re-anchors it on the map (``Tracking.cc:385-417``).

``save_map`` / ``load_map`` keep the reference's npz layout (the map's
fields, ``vocab__*``, ``loop__*``), so a map saved by either package loads
in the other; ``merge_map`` aligns a saved session by place recognition
and a Sim3 and appends it (``pipeline/map_merge.py``).

A stereo system builds its relocalization frames with ``build_stereo``.
The reference builds them as RGB-D with the right image as the depth map
(``slam.py:512-518``), a fault of its own; this is a deliberate divergence
(``tests/test_torch_stereo.py``).

``track_chunk`` takes float images or the wire format of the native
prefetcher (``io/datasets.make_prefetcher``: u8 gray, u16 millimetre depth
or a u8 right image), told apart by the gray images' dtype as in the
reference; both give the same records. The savers write the composed
trajectory in the TUM or KITTI format (``io/trajectory.py``),
``render_debug_image`` draws the last frame (``pipeline/frame_drawer.py``)
and ``map_points`` returns the valid points.

``mesh=`` (``parallel.mesh.Mesh``, from ``parallel.multihost.global_mesh``)
runs the back end over a mesh of process groups, one rank per device, every
rank the same program on the same frames: the local BA's rows split over
the ``kf`` axis when 2 * ``ba_window`` divides by it, and the loop
closer's global BA (shared with the relocalizer's index) the reference's
edge-list CG over the ``mp`` axis, with its faults (no structure-only
mode, no loop priors; ``pipeline/loop_closing.py``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.config import (SENSOR_MONOCULAR, SENSOR_STEREO,
                                             SlamConfig)
from orb_slam_2_ros_tpu_torch.frontend import frame as frame_mod
from orb_slam_2_ros_tpu_torch.io import trajectory
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.pipeline import frame_drawer, map_merge
from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam_2_ros_tpu_torch.pipeline.loop_closing import (LoopCloser,
                                                            LoopState)
from orb_slam_2_ros_tpu_torch.pipeline.metrics import (StageTimers,
                                                       entry_point, span)
from orb_slam_2_ros_tpu_torch.pipeline.mono_init import MonoInitializer
from orb_slam_2_ros_tpu_torch.pipeline.relocalization import Relocalizer
from orb_slam_2_ros_tpu_torch.place import database, vocabulary
from orb_slam_2_ros_tpu_torch.pipeline.tracking import (
    LOST, NOT_INITIALIZED, OK, FrameRecord, Tracker, _quat_mul_np,
    _quat_rotate_np, _quat_to_R)




def default_vocabulary(cfg: SlamConfig, device, warn: bool = True):
    """Train a small deterministic vocabulary from seeded random
    descriptors. A LAST RESORT: random 256-bit codes cover descriptor space
    uniformly, which gates matching adequately but retrieves far worse than
    a tree trained on real imagery. ``System`` without a vocabulary trains
    one from its first chunk's own descriptors and comes here only when
    those are too few."""
    if warn:
        import warnings
        warnings.warn(
            "No vocabulary provided: falling back to a RANDOM-descriptor "
            "tree. Loop-closing retrieval will be weak; pass a trained "
            "vocabulary (place.vocabulary.train_vocabulary) or let System "
            "bootstrap from tracked imagery.", stacklevel=2)
    rng = np.random.default_rng(cfg.seed)
    train = rng.integers(0, 2 ** 32, (8192, 8), dtype=np.uint32)
    return vocabulary.train_vocabulary(train, cfg, seed=cfg.seed,
                                       device=device)


class System:
    """``device=None`` means the card (``cuda``), or the mesh's device when
    a ``mesh`` is given, and raises where there is none; the system runs on
    the CPU only when asked to (``device="cpu"``, or a gloo mesh).
    """

    # keyframe-pool recycling: once the pool is this full, culled rows are
    # compacted away (Map::EraseKeyFrame, Map.cc:81-97)
    KF_COMPACT_WATERMARK = 0.85

    def __init__(self, cfg: SlamConfig, enable_local_ba: bool = True,
                 ba_window: int = 10, load_map=None,
                 enable_loop_closing: bool = True, vocab=None, device=None,
                 mesh=None):
        self.cfg = cfg
        self.timers = StageTimers()
        if mesh is not None and device is None:
            device = mesh.device
        # the tracker rejects the sensors and modes that are not ported and
        # resolves the device
        self.tracker = Tracker(cfg, device=device)
        self.device = self.tracker.device
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"a mesh on {mesh.device} for a system on "
                             f"{self.device}")
        self.mesh = mesh
        # the mapper's windowed BA splits its rows over the mesh's kf axis
        # when the window divides by it
        map_mesh = None
        if (mesh is not None
                and (2 * ba_window) % mesh.shape[cfg.mesh.kf_axis] == 0):
            map_mesh = mesh
        self.mapper = (LocalMapper(cfg, window=ba_window, mesh=map_mesh)
                       if enable_local_ba else None)
        self.n_resets = 0
        self.n_merges = 0
        self.n_kf_compactions = 0
        self.localization_only = cfg.localization_only
        self._culled_dev = []      # device scalars, summed when asked for
        self._frame_counter = 0
        self._last_frame_inputs = None
        # relocalization's RANSAC stream (the reference's PRNGKey(seed + 1))
        self._reloc_generator = torch.Generator(device=self.device)
        self._reloc_generator.manual_seed(cfg.seed + 1)
        self.n_reloc_attempts = 0
        self.n_relocalized = 0
        # the loop closer owns the BoW index, which the relocalizer shares
        self.loop_closing_enabled = enable_loop_closing
        self.loop_closer = None
        self.relocalizer = None
        self.vocab = vocab
        # no vocabulary given: the retrieval stack is built at the first
        # tracked chunk, around a tree trained on that chunk's descriptors;
        # a loaded map brings its own (the random-code tree stands in only
        # for a file without one)
        self._vocab_pending = False
        if enable_loop_closing or cfg.localization_only or load_map:
            if vocab is None and not load_map:
                self._vocab_pending = True
            else:
                if vocab is None and "vocab__node_desc" not in np.load(
                        load_map).files:
                    self.vocab = default_vocabulary(cfg, self.device)
                if self.vocab is not None:
                    self._build_retrieval_stack()
        # monocular bootstrap (MonocularInitialization, Tracking.cc:633-816)
        self.mono_init = None
        self._mono_initialized = cfg.sensor != SENSOR_MONOCULAR
        if cfg.sensor == SENSOR_MONOCULAR:
            self.mono_init = MonoInitializer(cfg, device=self.device)
        if load_map:
            self.load_map(load_map)
            self._mono_initialized = True

    def _build_retrieval_stack(self):
        """The relocalizer and the loop closer around ``self.vocab``, the
        closer's global BA stepped in the background, one chunk per
        tracking chunk."""
        self.relocalizer = Relocalizer(self.cfg, self.vocab)
        self.loop_closer = LoopCloser(self.cfg, self.vocab,
                                      background_gba=True, mesh=self.mesh)

    def _bootstrap_vocabulary(self, grays):
        """Train the vocabulary from the first tracked chunk's descriptors
        (up to 4 frames sampled across the batch, extracted from the float
        gray image as the reference's ``build_mono`` extracts them), then
        build the retrieval stack. A one-time host event before any
        keyframe is BoW-ingested."""
        n = len(grays)
        train = vocabulary.frame_descriptors(
            grays, list(range(0, n, max(1, n // 4)))[:4], self.cfg,
            self.device)
        if len(train) < 64:
            self.vocab = default_vocabulary(self.cfg, self.device)
        else:
            self.vocab = vocabulary.train_vocabulary(
                train, self.cfg, seed=self.cfg.seed, device=self.device)
        self._build_retrieval_stack()
        self._vocab_pending = False

    # ------------------------------------------------------------- tracking

    @entry_point
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> FrameRecord:
        return self.track_chunk(gray[None], depth[None], [timestamp])[0]

    @entry_point
    def track_chunk(self, grays, depths=None,
                    timestamps=None) -> List[FrameRecord]:
        """Track a batch of frames, grays/depths (N, H, W) float images:
        depth maps in metres (RGB-D), the right images (stereo) or None
        (mono). u8 gray images mean the wire format instead (u16
        millimetre depth or a u8 right image, as the native prefetcher
        delivers them), detected by dtype as in the reference
        (``slam.py:171-190``). A monocular system not yet initialized first feeds the
        frames to the two-view initializer, one at a time. Then per
        tracker chunk: track, one mapping step, loop closing, then
        relocalization of the chunk's LOST frames. The mapping step runs
        only if the chunk inserted a keyframe; that, and how many keyframes
        wait for the loop closer, is decided from the keyframe count that
        the chunk's own records carry (``ref_kf`` of the last frame), so
        neither gate reads anything more from the device."""
        grays = np.asarray(grays)
        wire = grays.dtype == np.uint8
        if not wire:
            grays = grays.astype(np.float32)
            if depths is not None:
                depths = np.asarray(depths, np.float32)
        if self._vocab_pending:
            self._bootstrap_vocabulary(grays)
        if timestamps is None:
            timestamps = [self._frame_counter + i / 30.0
                          for i in range(len(grays))]
        timestamps = list(timestamps)
        init_recs: List[FrameRecord] = []
        if not self._mono_initialized:
            consumed = 0
            for i in range(len(grays)):
                out = self.mono_init.process(grays[i].astype(np.float32),
                                             self._frame_counter + i)
                consumed = i + 1
                if out is not None:
                    self._adopt_mono_init(*out, consumed, init_recs,
                                          timestamps)
                    break
                init_recs.append(self._placeholder_record(
                    timestamps[i], NOT_INITIALIZED, offset=len(init_recs)))
            self.tracker.records.extend(init_recs)
            self._frame_counter += consumed
            if not self._mono_initialized or consumed == len(grays):
                return init_recs
            grays = grays[consumed:]
            timestamps = timestamps[consumed:]
        recs: List[FrameRecord] = []
        C = self.tracker.chunk
        K = self.cfg.map.max_kfs
        lc = self.loop_closer
        loop_on = (lc is not None and self.loop_closing_enabled
                   and not self.localization_only)
        mapping_on = self.mapper is not None and not self.localization_only
        for w0 in range(0, len(grays), C):
            w1 = min(w0 + C, len(grays))
            d = None if depths is None else depths[w0:w1]
            carry_before = self.tracker.carry
            with span("tracking"):
                chunk = self.tracker.process_chunk(grays[w0:w1], d,
                                                   timestamps[w0:w1], wire)
            n_kfs = chunk[-1].ref_kf + 1
            # point ids stay frozen while a global BA holds a snapshot
            gba_running = lc is not None and lc.gba_running
            if mapping_on:
                with span("local_mapping"):
                    carry = self.tracker.carry
                    m2, n_culled, last_mp2 = self.mapper.run(
                        carry.m, carry.last_mp,
                        allow_compact=not gba_running, full=True,
                        n_kfs=n_kfs)
                    self.tracker.carry = carry._replace(m=m2,
                                                        last_mp=last_mp2)
                    self._culled_dev.append(n_culled)
            if loop_on:
                with span("loop_closing"):
                    # detection only: its verdict is consumed one chunk on
                    lc.dispatch(self.tracker.carry.m, n_kfs)
                    # background GBA: one chunk per tracking chunk, so the
                    # refinement never stalls the camera (the reference's
                    # detached GBA thread, LoopClosing.cc:689)
                    m3, finished = lc.step_background(self.tracker.carry.m)
                    if finished:
                        self.tracker.adopt_map(m3)
                    verdict = lc.pop_lagged_verdict()
                    if verdict is not None:
                        m2, closed = lc.consume_host(self.tracker.carry.m,
                                                     *verdict)
                        if closed:
                            self.tracker.adopt_map(m2)
            # per-frame relocalization (Tracking.cc:341-346): every LOST
            # frame gets an attempt, in order; the first success replays
            # the chunk around it, so the lost-lag is at most one frame
            states = self.tracker.last_chunk_states()
            if self.relocalizer is not None and (states == LOST).any():
                ok = False
                with span("relocalization"):
                    for f in np.flatnonzero(states == LOST):
                        ok, q, t, kp_mp, frame = self._attempt_reloc(
                            *self._to_float_frame(
                                grays[w0 + f],
                                None if d is None else d[f]))
                        if ok:
                            chunk = self._replay_chunk(
                                carry_before, grays[w0:w1], d,
                                timestamps[w0:w1], int(f), q, t, kp_mp,
                                frame, wire)
                            break
                # lost with a barely started map: start over
                # (Tracking.cc:508-516, min_num_kf_in_map)
                if (not ok and not self.localization_only
                        and self.tracker.n_kfs
                        <= self.cfg.tracking.min_num_kf_in_map):
                    self.reset()
            recs.extend(chunk)
            # keyframe-pool recycling, only while no GBA runs (its
            # snapshot indexes the rows as they are)
            if (mapping_on and not (lc is not None and lc.gba_running)
                    and n_kfs >= int(self.KF_COMPACT_WATERMARK * K)):
                self.compact_keyframe_pool()
        self._frame_counter += len(grays)
        self._last_frame_inputs = (grays[-1],
                                   None if depths is None else depths[-1])
        # localization-VO re-anchoring: tracking survives on temporal points
        # while the map is out of sight (mbVO, Tracking.cc:385-417), so try
        # to relocalize on the map again (LOST frames were handled above)
        if (recs and self.localization_only and self.relocalizer is not None
                and recs[-1].state == OK and recs[-1].n_map_inliers < 10):
            with span("relocalization"):
                self.relocalize()
        return init_recs + recs

    def _placeholder_record(self, ts, state, offset=0) -> FrameRecord:
        """The record of a frame that the monocular initializer consumed."""
        return FrameRecord(
            frame_id=len(self.tracker.records) + offset, timestamp=float(ts),
            state=state, n_matches_frame=0, n_inliers=0, is_keyframe=False,
            R_wc=np.eye(3, dtype=np.float32),
            c_w=np.zeros(3, dtype=np.float32))

    def _adopt_mono_init(self, m, q1, t1, kp_mp, cur, consumed, init_recs,
                         timestamps):
        """Install the two-keyframe monocular map and bootstrap the tracker
        from keyframe 1's pose (the tail of CreateInitialMapMonocular,
        ``Tracking.cc:802-816``). As in the reference, the carry's frame
        count restarts at the number of frames this call consumed, the
        keyframe decision's reference count is keyframe 1's points, and
        the initializing frame's record is OK at the identity pose."""
        tr = self.tracker
        tr.carry = tr._fresh_carry(m, initialized=True)
        tr.force_pose(q1, t1, kp_mp, cur.kps.octave, cur.kps.angle)
        tr.carry = tr.carry._replace(
            frame_id=torch.full_like(tr.carry.frame_id, consumed),
            ref_tracked=torch.sum(kp_mp >= 0, dtype=torch.int32))
        self._mono_initialized = True
        for i in range(len(init_recs), consumed):
            init_recs.append(self._placeholder_record(
                timestamps[i], NOT_INITIALIZED, offset=len(init_recs)))
        init_recs[-1] = self._placeholder_record(
            timestamps[consumed - 1], OK, offset=len(init_recs) - 1)

    # ------------------------------------------------------- relocalization

    def _to_float_frame(self, gray, aux):
        """One frame's float images (host arrays; ``aux`` None for mono)
        as tensors on the device; a wire-format u16 millimetre depth map
        becomes metres."""
        def dev(a):
            if a is None:
                return None
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        if aux is not None and aux.dtype == np.uint16:
            aux = aux.astype(np.float32) * np.float32(1e-3)
        return dev(gray), dev(aux)

    @entry_point
    def _attempt_reloc(self, gray: torch.Tensor, aux: torch.Tensor):
        """Run the relocalization ladder on one float frame against the
        current map and BoW index (``Tracking::Relocalization``,
        ``Tracking.cc:1535-1724``). The index may lag the map, so the
        missing keyframes are ingested first, their detection results
        discarded. Returns (ok, q, t, kp_mp, frame); the caller decides
        when to ``force_pose`` (the replay applies it mid-chunk)."""
        m = self.tracker.carry.m
        lc = self.loop_closer
        lc.ingest_pending(m, self.tracker.n_kfs)
        with span("reloc.build_frame"):
            if self.cfg.sensor == SENSOR_MONOCULAR:
                frame = frame_mod.build_mono(gray, self.cfg)
            elif self.cfg.sensor == SENSOR_STEREO:
                # a deliberate divergence: the reference builds an RGB-D
                # frame with the right image as depth (its slam.py:512-518)
                frame = frame_mod.build_stereo(gray, aux, self.cfg)
            else:
                frame = frame_mod.build_rgbd(gray, aux, self.cfg)
        ok, q, t, kp_mp, _, _ = self.relocalizer.relocalize(
            m, lc.state.db, lc.state.kf_node, frame,
            generator=self._reloc_generator)
        self.n_reloc_attempts += 1
        ok = bool(ok)
        self.n_relocalized += ok
        return ok, q, t, kp_mp, frame

    @entry_point
    def relocalize(self) -> bool:
        """Attempt relocalization with the most recent frame
        (``Tracking::Relocalization``). Returns success."""
        if self._last_frame_inputs is None or self.relocalizer is None:
            return False
        ok, q, t, kp_mp, frame = self._attempt_reloc(
            *self._to_float_frame(*self._last_frame_inputs))
        if ok:
            self.tracker.force_pose(q, t, kp_mp, frame.kps.octave,
                                    frame.kps.angle)
        return ok

    def _replay_chunk(self, carry_before, grays, depths, timestamps, f: int,
                      q, t, kp_mp, frame, wire: bool = False
                      ) -> List[FrameRecord]:
        """Replay the chunk around a relocalization at its frame ``f``
        (per-frame relocalization, ``Tracking.cc:341-346``): take the
        chunk's records back out, restore the carry from before the chunk,
        re-track frames [0, f) (the same results), force the relocalized
        pose, and re-track [f, end) from it; the relocalized frame itself
        re-tracks from the forced pose (the reference's TrackLocalMap pass
        after relocalization). Returns the chunk's new records.

        As in the reference (``slam.py:546`` and ``:291``), the restored
        carry predates this chunk's mapping step, loop correction and GBA
        adoption, and the loop closer's state is not rolled back: kept so
        that both systems give the same frames."""
        self.tracker.pop_pending()
        self.tracker.carry = carry_before
        recs = []
        if f > 0:
            recs += self.tracker.process_chunk(
                grays[:f], None if depths is None else depths[:f],
                timestamps[:f], wire)
        self.tracker.force_pose(q, t, kp_mp, frame.kps.octave,
                                frame.kps.angle)
        recs += self.tracker.process_chunk(
            grays[f:], None if depths is None else depths[f:],
            timestamps[f:], wire)
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
        if self.loop_closer is not None:
            self.loop_closer.apply_kf_compaction(remap_np)
        self.n_kf_compactions += 1
        return n_freed

    @entry_point
    def reset(self):
        """Full map + tracker reset (``Tracking::Reset``,
        ``Tracking.cc:1727-1765``)."""
        self.tracker.carry = self.tracker._fresh_carry(
            map_state.empty(self.cfg, self.device))
        self.tracker.state = NOT_INITIALIZED
        if self.mapper is not None:
            self.mapper.rearm()
        if self.loop_closer is not None:
            self.loop_closer.reset()
        if self.mono_init is not None:
            self.mono_init.reset()
            self._mono_initialized = False
        self.n_resets += 1

    @entry_point
    def flush(self) -> List[FrameRecord]:
        """Drain the deferred work (queued loop-detection verdicts, an
        in-flight global BA) and fetch all pending frame records. Call at
        the end of a sequence, before reading trajectories or loop
        counters: they then reflect the COMPLETED refinement."""
        lc = self.loop_closer
        if (lc is not None and self.loop_closing_enabled
                and not self.localization_only):
            with span("loop_closing"):
                m2, closed = lc.finish_pending(self.tracker.carry.m)
                if closed:
                    self.tracker.adopt_map(m2)
                if lc.gba_running:
                    self.tracker.adopt_map(
                        lc.run_gba_to_completion(self.tracker.carry.m))
        return self.tracker.flush()

    # -------------------------------------------------------------- getters

    @property
    def records(self):
        return self.tracker.records

    @property
    def last_big_change_idx(self) -> int:
        """Counter of global map rewrites (loop corrections, resets and
        session merges). Consumers compare it against a remembered value
        to decide when to re-read the whole map
        (``Map::GetLastBigChangeIdx``)."""
        loops = self.loop_closer.n_loops_closed if self.loop_closer else 0
        return loops + self.n_resets + self.n_merges

    def metrics(self) -> dict:
        """Run summary: counters + per-stage host timing (reads the
        device)."""
        m = self.tracker.map
        lc = self.loop_closer
        return {
            "frames": len(self.tracker.records),
            "big_change_idx": self.last_big_change_idx,
            "keyframes": int(m.n_kfs),
            "map_points": int(m.mp_valid.sum()),
            "points_culled": self.n_culled_total,
            "loops_closed": lc.n_loops_closed if lc else 0,
            "resets": self.n_resets,
            "stages": self.timers.summary(),
        }

    @property
    def n_culled_total(self) -> int:
        """Map points culled by all mapping steps so far (reads the
        device)."""
        if not self._culled_dev:
            return 0
        return int(torch.stack(self._culled_dev).sum())

    # ----------------------------------------------------------------- mode

    def activate_localization_mode(self):
        """Stop mapping and loop closing (``System.cc:578-605``). As in the
        reference, the tracker's own freeze (no keyframe, the VO points)
        follows ``cfg.localization_only``."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    # ------------------------------------------------------------- map I/O

    def save_map(self, path: str) -> bool:
        """Persist the map, the vocabulary and the loop closer's BoW index
        and loop edges in the reference's npz layout: the ``MapState``
        fields by name (descriptors as uint32), ``vocab__node_desc``,
        ``vocab__word_weight``, ``vocab__klu``, and ``loop__*`` (the
        reference archives the Map and the KeyFrameDatabase together and
        rebinds the vocabulary on load, ``System.cc:610-691``)."""
        arrays = convert.to_numpy(self.tracker.map)
        v = self.vocab
        if v is not None:
            arrays["vocab__node_desc"] = convert.to_numpy(v)["node_desc"]
            arrays["vocab__word_weight"] = v.word_weight.cpu().numpy()
            arrays["vocab__klu"] = np.array([v.k, v.levels, v.levels_up],
                                            np.int32)
        lc = self.loop_closer
        if lc is not None:
            st = convert.to_numpy(lc.state)
            arrays.update(("loop__db_" + f, a)
                          for f, a in st.pop("db").items())
            arrays.update(("loop__" + f, a) for f, a in st.items())
            # the port keeps this count on the host
            arrays["loop__n_ingested"] = np.array(lc._n_ingested, np.int32)
        np.savez_compressed(path, **arrays)
        return True

    def load_map(self, path: str) -> bool:
        """Load a saved map (either package's), rebind its vocabulary and
        restore the BoW index and loop edges, so that relocalization and
        loop closing work against it (``System::LoadMap``,
        ``System.cc:647-691``). The tracker starts from the origin on the
        loaded map (``Tracker.attach_map``)."""
        data = np.load(path)
        self.tracker.attach_map(self._map_from(data))
        if self.mapper is not None:
            self.mapper.rearm()
        if "vocab__node_desc" in data.files:
            k, levels, lu = (int(x) for x in data["vocab__klu"])
            self.vocab = convert.vocabulary_from_numpy(dict(
                node_desc=data["vocab__node_desc"],
                word_weight=data["vocab__word_weight"], k=k, levels=levels,
                levels_up=lu), self.device)
            self._build_retrieval_stack()
            self._vocab_pending = False
        lc = self.loop_closer
        if lc is not None and "loop__n_ingested" in data.files:
            st = {f: data["loop__" + f] for f in LoopState._fields
                  if f != "db"}
            st["db"] = {f: data["loop__db_" + f]
                        for f in database.BowDatabase._fields}
            lc.state = convert.loop_state_from_numpy(st, self.device)
            lc._n_ingested = int(data["loop__n_ingested"])
        return True

    def merge_map(self, path: str, fix_scale: bool = None) -> bool:
        """Merge a saved session's map into the live one
        (``pipeline/map_merge.py``): align by place recognition and a Sim3,
        concatenate, and let the loop closer re-index the merged map from
        its first row. Returns success."""
        m2 = self._map_from(np.load(path))
        if self.vocab is None:
            self.vocab = default_vocabulary(self.cfg, self.device)
        if fix_scale is None:
            fix_scale = self.cfg.sensor != SENSOR_MONOCULAR
        merged, _ = map_merge.merge_maps(
            self.tracker.carry.m, m2, self.vocab, self.cfg,
            fix_scale=fix_scale)
        if merged is None:
            return False
        self.tracker.adopt_map(merged)
        self.n_merges += 1
        if self.loop_closer is not None:
            self.loop_closer.clear_index()
        return True

    def _map_from(self, data) -> map_state.MapState:
        """A MapState from a saved npz; a field the file lacks takes the
        empty map's value, as in the reference."""
        empty = map_state.empty(self.cfg, self.device)
        return map_state.MapState(**{
            f: (convert.to_tensor(data[f], self.device) if f in data.files
                else getattr(empty, f))
            for f in map_state.MapState._fields})

    # --------------------------------------------------------- trajectories

    def save_trajectory_tum(self, path: str):
        """Every OK frame's pose composed through its reference keyframe,
        so it carries every BA and loop correction since
        (``System::SaveTrajectoryTUM``, ``System.cc:343-401``)."""
        poses, ts = self.tracker.composed_trajectory(skip_lost=True)
        trajectory.write_tum(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path: str):
        """The valid keyframes' poses, each with its frame's timestamp
        (``System::SaveKeyFrameTrajectoryTUM``, ``System.cc:404-438``)."""
        m = self.tracker.map
        n = int(m.n_kfs)
        valid = m.kf_valid[:n].cpu().numpy()
        kf_q = m.kf_q[:n].cpu().numpy()[valid]
        kf_t = m.kf_t[:n].cpu().numpy()[valid]
        fids = m.kf_frame_id[:n].cpu().numpy()[valid]
        recs = self.tracker.records
        poses, ts = [], []
        for q, t, fid in zip(kf_q, kf_t, fids):
            R_cw = _quat_to_R(*q)
            poses.append((R_cw.T, -R_cw.T @ t))
            ts.append(recs[fid].timestamp if 0 <= fid < len(recs) else 0.0)
        trajectory.write_tum(path, ts, poses)

    def save_trajectory_kitti(self, path: str):
        """Composed like the TUM saver but keeping every frame
        (``System::SaveTrajectoryKITTI``, ``System.cc:441-494``, does not
        gate on ``mbLost``)."""
        poses, _ = self.tracker.composed_trajectory(skip_lost=False)
        trajectory.write_kitti(path, poses)

    # -------------------------------------------------------------- getters

    def render_debug_image(self):
        """The last frame with its keypoint overlays and the status bar
        (the ``FrameDrawer`` and ``PublishRenderedImage`` path,
        ``ros/src/Node.cc:200-206``): (H + 20, W, 3) uint8 BGR, or None
        before the first tracked chunk."""
        if self._last_frame_inputs is None:
            return None
        gray, aux = self._to_float_frame(*self._last_frame_inputs)
        if self.cfg.sensor == SENSOR_MONOCULAR:
            frame = frame_mod.build_mono(gray, self.cfg)
        elif self.cfg.sensor == SENSOR_STEREO:
            frame = frame_mod.build_stereo(gray, aux, self.cfg)
        else:
            frame = frame_mod.build_rgbd(gray, aux, self.cfg)
        carry = self.tracker.carry
        # while a monocular map initializes: the reference keypoints and
        # the current match vector, drawn as match lines
        init_ref_xy = init_matches = None
        mi = self.mono_init
        if (not self._mono_initialized and mi is not None
                and mi.ref is not None and mi.last_matches is not None):
            init_ref_xy = mi.ref.uv.cpu().numpy()
            init_matches = mi.last_matches.cpu().numpy()
        rec = self.records[-1] if self.records else None
        m = self.tracker.map
        return frame_drawer.draw_frame(
            gray.cpu().numpy(), frame.kps.xy.cpu().numpy(),
            frame.valid.cpu().numpy(), (carry.last_mp >= 0).cpu().numpy(),
            state=self.tracker.state,
            n_matches=rec.n_inliers if rec else 0,
            n_kfs=int(m.n_kfs), n_mps=int(m.mp_valid.sum()),
            localization_only=self.localization_only,
            kp_has_vo=carry.last_vo.cpu().numpy(),
            init_ref_xy=init_ref_xy, init_matches=init_matches)

    def map_points(self, min_observations: int = 0) -> np.ndarray:
        """(N, 3) valid map-point positions (the PointCloud2 of
        ``ros/src/Node.cc:244-289``); ``min_observations`` drops points
        seen by fewer keyframes, as ``min_observations_for_ros_map``
        does (``ros/src/Node.cc:277-286``)."""
        m = self.tracker.map
        valid = m.mp_valid
        if min_observations > 0:
            valid = valid & (map_state.observation_count(m)
                             >= min_observations)
        return m.mp_pos[valid].cpu().numpy()
