"""Descriptor matching for the tracking and local-mapping steps.

Port of the RGB-D path's part of ``orb_slam_2_ros_tpu/frontend/
matcher.py``. Each projection search builds per-row and per-column metadata
and runs the fused masked best-two search of ``ops/match_kernel.py`` (the
CUDA kernel for CUDA tensors, its plain version for CPU tensors), then the
accept gates, the rotation histogram and a scatter-min conflict resolution.

``search_reference_kf`` goes through the same kernel with its gates opened
(infinite radius, octave band [-1, 99], no stereo coordinate), which gives
the reference's ungated masked ``best_two`` without an (N, M) matrix.
``search_for_triangulation`` gates by the epipolar line, which the kernel's
metadata cannot express, and works on the (N, M) Hamming matrix in PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame
from orb_slam_2_ros_tpu_torch.geometry import camera, se3
from orb_slam_2_ros_tpu_torch.ops.hamming import INF_DIST, hamming_matrix
from orb_slam_2_ros_tpu_torch.ops.match_kernel import masked_best_two

_KEY_NONE = 0x7FFFFFFF
HISTO_LENGTH = 30


def _f32(x, like):
    """x as an f32 tensor shaped like ``like`` (x may be a Python number)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).expand_as(like)
    return torch.full_like(like, float(x), dtype=torch.float32)


def fused_best_two(desc_rows, desc_cols, row_uv, row_rad, row_oct_lo,
                   row_oct_hi, row_ur, row_ok, col_uv, col_oct, col_ur,
                   col_ok):
    """Pack the (8, N) / (8, M) metadata of the kernel and run it (the
    reference's ``_fused_best_two``)."""
    ref = row_uv[:, 0]
    row_meta = torch.stack([
        row_uv[:, 0].float(), row_uv[:, 1].float(), _f32(row_rad, ref),
        _f32(row_oct_lo, ref), _f32(row_oct_hi, ref), _f32(row_ur, ref),
        _f32(row_ok, ref), torch.zeros_like(ref, dtype=torch.float32)])
    cref = col_uv[:, 0]
    zc = torch.zeros_like(cref, dtype=torch.float32)
    col_meta = torch.stack([
        col_uv[:, 0].float(), col_uv[:, 1].float(), _f32(col_oct, cref),
        _f32(col_ur, cref), _f32(col_ok, cref), zc, zc, zc])
    return masked_best_two(desc_rows.contiguous(), row_meta,
                           desc_cols.contiguous(), col_meta)


class TrackInView(NamedTuple):
    """Per-map-point frustum data (``Frame::isInFrustum``)."""

    uv: torch.Tensor          # (N, 2) projected undistorted pixel
    u_right: torch.Tensor     # (N,) projected right coord
    dist: torch.Tensor        # (N,) distance to camera centre
    view_cos: torch.Tensor    # (N,) cos(ray, mean normal)
    pred_level: torch.Tensor  # (N,) int32 predicted octave
    ok: torch.Tensor          # (N,) bool


def predict_level(dist: torch.Tensor, max_dist: torch.Tensor,
                  cfg: SlamConfig) -> torch.Tensor:
    """Scale prediction from distance (``MapPoint::PredictScale``)."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    log_sf = torch.log(torch.full_like(dist, cfg.orb.scale_factor))
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_sf)
    return torch.clamp(lvl.to(torch.int32), 0, cfg.orb.n_levels - 1)


def frustum_check(q, t, mp_pos, mp_normal, mp_min_dist, mp_max_dist,
                  mp_valid, cfg: SlamConfig) -> TrackInView:
    """Batched isInFrustum over the map-point pool (viewing-angle cosine
    limit 0.5, as the tracker's local-map search uses it)."""
    cam = cfg.camera
    xc = se3.apply(q, t, mp_pos)
    z = xc[..., 2]
    uvr = camera.project_stereo(cam, xc)
    uv = uvr[..., :2]
    po = mp_pos - se3.camera_center(q, t)
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    ok = (mp_valid & (z > 0.0) & camera.in_image(cam, uv)
          & (dist >= mp_min_dist) & (dist <= mp_max_dist)
          & (view_cos > 0.5))
    return TrackInView(uv=uv, u_right=uvr[..., 2], dist=dist,
                       view_cos=view_cos,
                       pred_level=predict_level(dist, mp_max_dist, cfg), ok=ok)


def resolve_conflicts(best_kp: torch.Tensor, best_d: torch.Tensor,
                      accept: torch.Tensor, n_kps: int):
    """Per target keypoint, keep the accepted query with the smallest
    (distance, query index). Returns (kp_to_query (n_kps,) int32 with -1,
    kp_dist (n_kps,) int32)."""
    n_q = best_kp.shape[0]
    dev = best_kp.device
    key = best_d.to(torch.int32) * (1 << 20) + torch.arange(
        n_q, dtype=torch.int32, device=dev)
    key = torch.where(accept, key, torch.full_like(key, _KEY_NONE))
    slot = torch.where(accept, best_kp.to(torch.int64),
                       torch.full_like(best_kp, n_kps, dtype=torch.int64))
    kp_key = torch.full((n_kps + 1,), _KEY_NONE, dtype=torch.int32, device=dev)
    kp_key = kp_key.scatter_reduce(0, slot, key, reduce="amin")[:n_kps]
    matched = kp_key != _KEY_NONE
    kp_to_q = torch.where(matched, kp_key & ((1 << 20) - 1),
                          torch.full_like(kp_key, -1))
    kp_dist = torch.where(matched, kp_key >> 20,
                          torch.full_like(kp_key, INF_DIST))
    return kp_to_q, kp_dist


def rotation_consistency(rot_deg: torch.Tensor,
                         accept: torch.Tensor) -> torch.Tensor:
    """Keep only matches in the 3 most-populated rotation bins
    (``ComputeThreeMaxima``; 30-degree bins, the reference's factor quirk).

    The top 3 of the 30 integer counts are taken by a stable descending
    sort, so the lower bin comes first among ties, as ``jax.lax.top_k``
    orders them."""
    rot = torch.where(rot_deg < 0, rot_deg + 360.0, rot_deg)
    b = torch.round(rot * (1.0 / HISTO_LENGTH)).to(torch.int64)
    b = torch.where(b == HISTO_LENGTH, torch.zeros_like(b), b)
    b = torch.clamp(b, 0, HISTO_LENGTH - 1)
    counts = torch.zeros((HISTO_LENGTH,), dtype=torch.int32,
                         device=rot.device)
    counts = counts.index_add(0, torch.where(accept, b, torch.zeros_like(b)),
                              accept.to(torch.int32))
    vals, idx = torch.sort(counts, descending=True, stable=True)
    vals, idx = vals[:3], idx[:3]
    keep_bins = (torch.arange(3, device=rot.device) == 0) | (vals > 0.1 * vals[0])
    good = torch.zeros((HISTO_LENGTH,), dtype=torch.bool, device=rot.device)
    good = good.index_copy(0, idx, keep_bins)
    return accept & good[b]


def _degrees(x: torch.Tensor) -> torch.Tensor:
    return x * (180.0 / math.pi)


def search_local_map(tv: TrackInView, mp_desc: torch.Tensor, frame: Frame,
                     kp_has_mp: torch.Tensor, cfg: SlamConfig, th=1.0):
    """Project local map points into the frame and match
    (``ORBmatcher::SearchByProjection`` variant 1). ``th`` is a number or a
    0-d tensor. Returns (kp_to_mp_local (max_kps,) int32 or -1, kp_dist)."""
    m = cfg.matcher
    sf = torch.pow(torch.full_like(tv.dist, cfg.orb.scale_factor),
                   tv.pred_level.to(torch.float32))
    r = torch.where(tv.view_cos > 0.998, 2.5, 4.0) * th * sf
    best_idx, best_d, second_idx, second_d = fused_best_two(
        mp_desc, frame.desc, tv.uv, r, tv.pred_level - 1, tv.pred_level,
        tv.u_right, tv.ok, frame.uv, frame.kps.octave, frame.u_right,
        frame.valid & ~kp_has_mp)
    oct_kp = frame.kps.octave
    lvl_best = oct_kp[best_idx.long()]
    lvl_second = oct_kp[second_idx.long()]
    ratio_fail = (lvl_best == lvl_second) & (
        best_d.to(torch.float32)
        > m.nn_ratio_tracking * second_d.to(torch.float32))
    accept = (best_d <= m.th_high) & ~ratio_fail & tv.ok
    return resolve_conflicts(best_idx, best_d, accept, frame.uv.shape[0])


def search_by_projection_pose(mp_world: torch.Tensor, mp_desc: torch.Tensor,
                              src_octave: torch.Tensor,
                              src_valid: torch.Tensor, q, t, frame: Frame,
                              cfg: SlamConfig, th: float,
                              src_angle: torch.Tensor = None,
                              check_rotation: bool = True,
                              widen_below: int = 0):
    """Project known 3D points (with a source octave each) into the frame
    under pose (q, t) and match in a window th*scale^octave: the
    last-frame -> current SearchByProjection (``ORBmatcher.cc:1330-1472``)
    and, with ``check_rotation=False`` and no ``src_angle``, the projection
    search of landmark fusion (``ORBmatcher::Fuse``).

    widen_below > 0 re-matches with a 2x window when fewer than that many
    matches pass (``Tracking.cc:1002-1016``). Both passes always run and a
    ``torch.where`` picks one, as the reference's predicated retry does.
    Returns (kp_to_src (max_kps,) int32, kp_dist)."""
    cam = cfg.camera
    xc = se3.apply(q, t, mp_world)
    z = xc[..., 2]
    uvr = camera.project_stereo(cam, xc)
    uv = uvr[..., :2]
    ok = src_valid & (z > 0) & camera.in_image(cam, uv)
    sf = torch.pow(torch.full_like(z, cfg.orb.scale_factor),
                   src_octave.to(torch.float32))

    def attempt(radius):
        best_idx, best_d, _, _ = fused_best_two(
            mp_desc, frame.desc, uv, radius, src_octave - 1, src_octave + 1,
            uvr[..., 2], ok, frame.uv, frame.kps.octave, frame.u_right,
            frame.valid)
        accept = (best_d <= cfg.matcher.th_high) & ok
        if check_rotation and src_angle is not None:
            rot = _degrees(src_angle - frame.kps.angle[best_idx.long()])
            accept = rotation_consistency(rot, accept)
        return best_idx, best_d, accept

    best_idx, best_d, accept = attempt(th * sf)
    if widen_below > 0:
        n = torch.sum(accept, dtype=torch.int32)
        bi2, bd2, ac2 = attempt(2.0 * th * sf)
        use_wide = n < widen_below
        best_idx = torch.where(use_wide, bi2, best_idx)
        best_d = torch.where(use_wide, bd2, best_d)
        accept = torch.where(use_wide, ac2, accept)
    return resolve_conflicts(best_idx, best_d, accept, frame.uv.shape[0])


def search_reference_kf(ref_desc: torch.Tensor, ref_valid: torch.Tensor,
                        ref_angle: torch.Tensor, frame: Frame,
                        cfg: SlamConfig):
    """Reference-keyframe matching for TrackReferenceKeyFrame
    (``SearchByBoW(KF, F)``, nn ratio 0.7 + rotation check), over all pairs
    as in the reference (its documented deviation: no vocabulary-node gate).
    Returns (kp_to_ref (max_kps,) int32, kp_dist)."""
    m = cfg.matcher
    ref_uv = torch.zeros((ref_desc.shape[0], 2), dtype=torch.float32,
                         device=ref_desc.device)
    best_idx, best_d, _, second_d = fused_best_two(
        ref_desc, frame.desc, ref_uv, math.inf, -1.0, 99.0, -1.0, ref_valid,
        frame.uv, frame.kps.octave, frame.u_right, frame.valid)
    accept = ((best_d <= m.th_low)
              & (best_d.to(torch.float32)
                 < m.nn_ratio_bow * second_d.to(torch.float32))
              & ref_valid)
    rot = _degrees(ref_angle - frame.kps.angle[best_idx.long()])
    accept = rotation_consistency(rot, accept)
    return resolve_conflicts(best_idx, best_d, accept, frame.desc.shape[0])


def search_for_triangulation(f1_desc, f1_uv, f1_valid, f2_desc, f2_uv, f2_oct,
                             f2_valid, F12: torch.Tensor, cfg: SlamConfig):
    """Epipolar-gated matching between two keyframes for new-point creation
    (``SearchForTriangulation``, ``ORBmatcher.cc:659-825``): candidates are
    unmatched features whose pairing passes the fundamental-matrix distance
    gate ``CheckDistEpipolarLine`` (``:140-157``). No rotation check and no
    vocabulary-node gate, as the reference's mapping step calls it.

    F12 maps points of image 1 to epipolar lines in image 2
    (x2^T F12 x1 = 0). Per feature of image 1 the best gated feature of
    image 2 is taken, ties to the lowest index by a composite key (an
    ``argmin`` on CUDA promises no tie order). Returns (idx2_to_idx1 (M,)
    int32, dist)."""
    N, M = f1_desc.shape[0], f2_desc.shape[0]
    # epipolar line of each f1 feature in image 2: l = F12 @ [u1, v1, 1]
    x1 = torch.cat([f1_uv, torch.ones_like(f1_uv[:, :1])], dim=-1)   # (N, 3)
    lines = x1 @ F12.T
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * f2_uv[None, :, 0] + b * f2_uv[None, :, 1] + c          # (N, M)
    dsqr = (num * num) / torch.clamp(a * a + b * b, min=1e-12)
    sf2 = torch.pow(torch.full_like(f2_uv[:, 0], cfg.orb.scale_factor),
                    f2_oct.to(torch.float32))
    mask = (f1_valid[:, None] & f2_valid[None, :]
            & (dsqr < 3.84 * (sf2 * sf2)[None, :]))
    D = hamming_matrix(f1_desc, f2_desc)
    cols = torch.arange(M, dtype=torch.int32, device=D.device)
    key = torch.where(mask, D, torch.full_like(D, INF_DIST)) * (1 << 15) + cols
    best = torch.min(key, dim=1).values
    best_idx, best_d = best & ((1 << 15) - 1), best >> 15
    accept = (best_d <= cfg.matcher.th_low) & f1_valid
    return resolve_conflicts(best_idx, best_d, accept, M)
