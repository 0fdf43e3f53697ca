"""Monocular bootstrap: two-view initialization + initial map construction.

Port of ``orb_slam_2_ros_tpu/pipeline/mono_init.py``
(``Tracking::MonocularInitialization`` + ``CreateInitialMapMonocular``,
``Tracking.cc:633-816``): hold a reference frame, match each new frame
against it in a window (``search_for_initialization``), run the batched
H/F RANSAC initializer, and on success build the two-keyframe map: the
accepted triangulations observed in both keyframes, a structure-only BA
of 20 iterations, and the median-depth normalization.

The reference's two jitted programs are plain functions here
(``_try_init``, ``_build_map``). Its host decisions stay as they are: one
read of the keypoint count and one of the match count per frame
(``n_kps <= 100`` and too few matches both reset the reference frame,
``:147-161``), and one of the verdict.

Two behaviours of the reference are kept on purpose:
- the BA fixes both cameras (its documented deviation from the full GBA of
  ``Tracking.cc:765``), so only the landmarks move; the port skips the
  CG solve, whose answer is then exactly zero;
- the median-depth normalization (``Tracking.cc:775-800``) takes
  ``jnp.median`` over an array that is NaN wherever a pool row is not a
  point, so the median is NaN, ``nan_to_num`` makes it 1.0, and the map
  keeps the initializer's unit baseline. ``torch.quantile(x, 0.5)``
  propagates NaN as ``jnp.median`` does and is used the same way (a
  ``nanquantile`` would give a different map).
"""

from __future__ import annotations

from typing import Optional

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import frame as frame_mod
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame
from orb_slam_2_ros_tpu_torch.geometry import camera, se3
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.map.state import pad_row
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span
from orb_slam_2_ros_tpu_torch.solvers import ba, initializer


def median_or_one(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``nan_to_num(jnp.median(x), nan=1.0)``: the mean of
    the two middle values, NaN (so 1.0) if any element is NaN."""
    return torch.nan_to_num(torch.quantile(x, 0.5), nan=1.0)


def _try_init(cfg: SlamConfig, ref: Frame, cur: Frame,
              generator: torch.Generator = None,
              sample_idx: torch.Tensor = None):
    """Match the current frame to the reference frame and run the
    initializer. Returns (ok, InitResult, cur_to_ref, n_matches)."""
    with span("mono.search_for_initialization"):
        cur_to_ref, _ = matcher.search_for_initialization(ref, cur, cfg)
    pair = cur_to_ref >= 0
    n_matches = torch.sum(pair, dtype=torch.int32)
    ridx = torch.clamp(cur_to_ref, min=0).to(torch.int64)
    K = camera.intrinsics(cfg.camera, cur.uv.device)
    with span("mono.initialize"):
        res = initializer.initialize(ref.uv[ridx], cur.uv, pair, K,
                                     generator=generator,
                                     sample_idx=sample_idx)
    ok = res.ok & (n_matches >= cfg.tracking.min_init_mono_matches)
    return ok, res, cur_to_ref, n_matches


@span("mono.build_map")
def _build_map(cfg: SlamConfig, ref: Frame, cur: Frame, cur_to_ref, q, t,
               points, good, ref_frame_id, cur_frame_id):
    """Initial map: keyframe 0 at the identity, keyframe 1 at (q, t); the
    accepted triangulations become points observed in both; structure-only
    BA; median-depth scale normalization. Returns (m, q1, t1, kp_mp1)."""
    dev = cur.uv.device
    i64 = torch.int64
    P = cur.uv.shape[0]
    m = map_state.empty(cfg, dev)
    none = torch.full((P,), -1, dtype=torch.int32, device=dev)
    m, _ = map_state.insert_keyframe(m, ref, *se3.identity(device=dev),
                                     ref_frame_id, none)
    m, _ = map_state.insert_keyframe(m, cur, q, t, cur_frame_id, none)
    M = m.M

    # spawn landmarks (aligned on cur's keypoint axis)
    spawn = good & (cur_to_ref >= 0) & cur.valid
    rank = torch.cumsum(spawn.to(torch.int32), 0, dtype=torch.int32) - 1
    new_id = torch.where(spawn, rank, none)
    tgt = torch.where(spawn, new_id.to(i64), torch.full_like(new_id, M,
                                                             dtype=i64))
    ridx = torch.clamp(cur_to_ref, min=0).to(i64)

    c1 = se3.camera_center(q, t)
    d0 = torch.linalg.norm(points, dim=-1)
    d1 = torch.linalg.norm(points - c1, dim=-1)
    dirs = (points / torch.clamp(d0[:, None], min=1e-9)
            + (points - c1) / torch.clamp(d1[:, None], min=1e-9))
    nrm = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                             min=1e-9)
    sf = torch.pow(torch.full_like(d1, cfg.orb.scale_factor),
                   cur.kps.octave.to(torch.float32))
    max_d = d1 * sf
    min_d = max_d / (cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))

    def put(pool, vals):
        return pad_row(pool).index_put((tgt,), vals)[:M]

    ones = torch.ones((P,), dtype=torch.int32, device=dev)
    slot_all = torch.arange(P, device=dev)
    kf_mp = m.kf_mp.clone()
    kf_mp[0] = pad_row(kf_mp[0]).index_put(
        (torch.where(spawn, ridx, torch.full_like(ridx, P)),), new_id)[:P]
    kf_mp[1] = pad_row(kf_mp[1]).index_put(
        (torch.where(spawn, slot_all, torch.full_like(slot_all, P)),),
        new_id)[:P]
    m = m._replace(
        mp_pos=put(m.mp_pos, points),
        mp_valid=put(m.mp_valid, spawn),
        mp_desc=put(m.mp_desc, cur.kps.desc),
        mp_normal=put(m.mp_normal, nrm),
        mp_min_dist=put(m.mp_min_dist, 0.8 * min_d),
        mp_max_dist=put(m.mp_max_dist, 1.2 * max_d),
        mp_first_kf=put(m.mp_first_kf, ones * 0),
        mp_dir_sum=put(m.mp_dir_sum, dirs),
        mp_obs_cnt=put(m.mp_obs_cnt, ones * 2),
        mp_visible=put(m.mp_visible, ones),
        mp_found=put(m.mp_found, ones),
        kf_mp=kf_mp,
        n_mps=torch.sum(spawn, dtype=torch.int32))

    # structure-only refinement of the 2-view problem: both cameras fixed
    # (the reference's documented deviation), 20 LM iterations with the
    # Huber kernel. Only the two keyframe rows hold edges: the rest of the
    # pool contributes exact zeros, so the problem is built on those two.
    kp_valid = m.kf_kp_valid[:2] & m.kf_valid[:2, None]
    prob = ba.build_problem(m.kf_uv[:2], m.kf_ur[:2], m.kf_octave[:2],
                            m.kf_mp[:2], kp_valid, cfg)
    with span("mono.structure_only_ba"):
        _, _, pos, _ = ba.bundle_adjustment(m.kf_q[:2], m.kf_t[:2], None,
                                            m.mp_pos, m.mp_valid, prob, cfg,
                                            phases=(20,))
    m = m._replace(mp_pos=pos)

    # median-depth scale normalization (Tracking.cc:775-800): a no-op in
    # the reference and here, see the module docstring
    z0 = se3.apply(m.kf_q[0], m.kf_t[0], m.mp_pos)[:, 2]
    med = median_or_one(torch.where(m.mp_valid, z0,
                                    torch.full_like(z0, float("nan"))))
    inv_med = 1.0 / torch.clamp(med, min=1e-6)
    m = m._replace(
        mp_pos=m.mp_pos * inv_med,
        kf_t=m.kf_t * inv_med,
        mp_min_dist=m.mp_min_dist * inv_med,
        mp_max_dist=m.mp_max_dist * inv_med)
    with span("mono.refresh_point_stats"):
        m = map_state.refresh_point_stats(m, cfg)
    return m, m.kf_q[1], m.kf_t[1], m.kf_mp[1]


class MonoInitializer:
    """Host state machine over ``_try_init`` and ``_build_map``.

    ``device=None`` means the card (``cuda``) and raises where there is
    none. The RANSAC draws come from a ``torch.Generator`` seeded
    ``cfg.seed + 2`` (the reference's ``PRNGKey(cfg.seed + 2)``)."""

    def __init__(self, cfg: SlamConfig, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MonoInitializer runs on a CUDA device by default and "
                    "torch.cuda.is_available() is False; pass device=\"cpu\" "
                    "to run on the CPU")
            device = "cuda"
        self.cfg = cfg
        self.device = torch.device(device)
        self.ref: Optional[Frame] = None
        self.ref_frame_id = -1
        # the last attempt's current -> reference matches (the FrameDrawer's
        # initialization lines); a device tensor or None
        self.last_matches = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 2)

    def reset(self):
        self.ref = None
        self.ref_frame_id = -1

    @span("mono.init_attempt")
    def process(self, gray, frame_id: int):
        """Feed one float gray image (host array or tensor). Returns None
        while initializing, else (map, q1, t1, kp_mp, cur_frame) ready for
        the tracker."""
        gray = torch.as_tensor(gray, dtype=torch.float32).to(self.device)
        with span("mono.build_frame"):
            frame = frame_mod.build_mono(gray, self.cfg)
        n_kps = int(torch.sum(frame.valid))
        if self.ref is None or n_kps <= 100:
            # (re)set the reference (Tracking.cc:638-660)
            self.ref = frame if n_kps > 100 else None
            self.ref_frame_id = frame_id if n_kps > 100 else -1
            return None
        ok, res, cur_to_ref, n_matches = _try_init(
            self.cfg, self.ref, frame, generator=self.generator)
        self.last_matches = cur_to_ref
        if int(n_matches) < self.cfg.tracking.min_init_mono_matches:
            # too few matches: reset to this frame (:661-668)
            self.ref = frame
            self.ref_frame_id = frame_id
            return None
        if not bool(ok):
            return None
        m, q1, t1, kp_mp = _build_map(
            self.cfg, self.ref, frame, cur_to_ref, res.q, res.t, res.points,
            res.good, self.ref_frame_id, frame_id)
        return m, q1, t1, kp_mp, frame
