"""Relocalization: re-acquire the camera pose after tracking loss.

Port of ``orb_slam_2_ros_tpu/pipeline/relocalization.py``
(``Tracking::Relocalization``, ``Tracking.cc:1535-1724``): query the keyframe
database for candidates, BoW-match the lost frame against each, run EPnP
RANSAC per candidate, refine with the pose LM, widen the matches by
projection and accept at >= 50 inliers.

The per-candidate ladder (BoW-gated matching -> EPnP RANSAC -> pose LM) runs
once over the top ``N_CANDIDATES`` database candidates as a leading axis:
``torch.func.vmap`` over the matcher and the LM, one batch of 5 x 256
hypotheses for the RANSAC, so that a bad top-scoring candidate (a BoW decoy)
cannot sink the attempt. The winner by post-LM inlier count, the first among
equal counts, then gets the projection-guided widening over the whole point
pool (``SearchByProjection``, ``Tracking.cc:1655``: the matcher kernel at
``max_mps`` x ``max_kps``) and the final gate. Nothing waits for the device;
the caller fetches ``ok``.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax, top_k_stable
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span
from orb_slam_2_ros_tpu_torch.place import database, vocabulary
from orb_slam_2_ros_tpu_torch.solvers import pnp
from orb_slam_2_ros_tpu_torch.solvers.pose_opt import pose_optimization

MIN_BOW_MATCHES = 15     # per-candidate gate (Tracking.cc:1586)
MIN_INLIERS_ACCEPT = 50  # final accept (Tracking.cc:1713)
N_CANDIDATES = 5         # candidates swept per attempt (the reference sweeps
                         # every database candidate, typically a handful)
LAUNCHES = 1             # matcher-kernel launches of one attempt (widening)


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 1-element index tensor i, without a 0-d tensor index."""
    return x.index_select(0, i)[0]


@span("reloc.bow_candidates")
def _candidates(m: map_state.MapState, db: database.BowDatabase,
                frame: Frame, vocab: vocabulary.Vocabulary):
    """The frame's BoW and the top ``N_CANDIDATES`` database candidates.
    Returns (top_idx (C,) int64, cand_ok (C,) bool, node_id (P,))."""
    with span("reloc.transform"):
        wid, nid, tfidf = vocabulary.transform(vocab, frame.kps.desc,
                                               frame.valid)
    wt = vocabulary.bow_weights(wid, tfidf, vocab.num_words)
    with span("reloc.query"):
        queried = database.query(db, wid, wt, vocab.num_words)
    with span("reloc.detect_candidates"):
        cand = database.detect_candidates(
            db, wid, wt, torch.zeros((m.K,), dtype=torch.bool,
                                     device=frame.uv.device),
            map_state.covisibility(m), vocab.num_words, min_score=None,
            queried=queried)
    scores = queried[0]
    top_scores, top_idx = top_k_stable(
        torch.where(cand, scores, torch.full_like(scores, -1.0)), N_CANDIDATES)
    return top_idx, top_scores > 0.0, nid


@span("reloc.candidate_ladder")
def _candidate_ladder(m: map_state.MapState, kf_node: torch.Tensor,
                      frame: Frame, node_id: torch.Tensor,
                      top_idx: torch.Tensor, cand_ok: torch.Tensor,
                      cfg: SlamConfig, generator, sample_idx):
    """BoW-gated matching -> EPnP RANSAC -> pose LM for every candidate at
    once (``Tracking.cc:1586-1652``), the candidates on the leading axis.
    Returns (q (C, 4), t (C, 3), kp_to_mp (C, P), n_inliers (C,), -1 for a
    candidate that is absent or has too few BoW matches)."""
    i64 = torch.int64
    kf_mp = m.kf_mp[top_idx]                                  # (C, P)
    valid_c = (m.kf_kp_valid[top_idx] & (kf_mp >= 0)
               & m.kf_valid[top_idx][:, None] & cand_ok[:, None])

    def by_node(desc_c, node_c, ok_c, angle_c):
        return matcher.search_by_node(
            desc_c, node_c, ok_c, angle_c, frame.kps.desc, node_id,
            frame.valid, frame.kps.angle, cfg)[0]

    with span("reloc.search_by_node"):
        f_to_c = torch.func.vmap(by_node)(m.kf_desc[top_idx],
                                          kf_node[top_idx], valid_c,
                                          m.kf_angle[top_idx])
    kp_mp = torch.where(
        f_to_c >= 0, torch.gather(kf_mp, 1, torch.clamp(f_to_c, min=0).to(i64)),
        torch.full_like(f_to_c, -1))
    ok_pair = kp_mp >= 0
    n_bow = torch.sum(ok_pair, dim=1, dtype=torch.int32)
    xw = m.mp_pos[torch.clamp(kp_mp, min=0).to(i64)]          # (C, P, 3)
    with span("reloc.ransac_pnp"):
        q0, t0, pnp_inl, _ = pnp.ransac_pnp(
            xw, frame.uv.expand(xw.shape[:-1] + (2,)), ok_pair, cfg,
            generator=generator, sample_idx=sample_idx)

    def lm(q, t, pts, valid):
        return pose_optimization(q, t, pts, frame.uv, frame.u_right,
                                 frame.kps.octave, valid, cfg)

    with span("reloc.pose_optimization"):
        q1, t1, inl1, n1 = torch.func.vmap(lm)(q0, t0, xw,
                                               ok_pair & pnp_inl)
    kp_mp1 = torch.where(inl1 & ok_pair, kp_mp, torch.full_like(kp_mp, -1))
    usable = cand_ok & (n_bow >= MIN_BOW_MATCHES)
    return q1, t1, kp_mp1, torch.where(usable, n1, torch.full_like(n1, -1))


@span("reloc.widening")
def _widen(m: map_state.MapState, frame: Frame, q, t, kp_mp,
           cfg: SlamConfig):
    """Projection-guided widening over the whole point pool
    (``SearchByProjection``, ``Tracking.cc:1655``) and the final pose LM.
    Returns (q, t, kp_to_mp, n_inliers)."""
    with span("reloc.frustum_check"):
        tv = matcher.frustum_check(q, t, m.mp_pos, m.mp_normal,
                                   m.mp_min_dist, m.mp_max_dist, m.mp_valid,
                                   cfg)
    with span("reloc.search_local_map"):
        kp_to_mp2, _ = matcher.search_local_map(tv, m.mp_desc, frame,
                                                kp_mp >= 0, cfg)
    kp_mp_w = torch.where(kp_mp >= 0, kp_mp, kp_to_mp2)
    with span("reloc.pose_optimization"):
        q2, t2, inl2, n2 = pose_optimization(
            q, t, m.mp_pos[torch.clamp(kp_mp_w, min=0).to(torch.int64)],
            frame.uv, frame.u_right, frame.kps.octave, kp_mp_w >= 0, cfg)
    return q2, t2, torch.where(inl2, kp_mp_w, torch.full_like(kp_mp_w, -1)), n2


@span("reloc.attempt")
def relocalize(m: map_state.MapState, db: database.BowDatabase,
               kf_node: torch.Tensor, frame: Frame, cfg: SlamConfig,
               vocab: vocabulary.Vocabulary,
               generator: torch.Generator = None,
               sample_idx: torch.Tensor = None):
    """One attempt for ``frame`` against the map ``m`` and its BoW index
    (``db``, ``kf_node`` (K, P) vocabulary node per keyframe keypoint).
    The RANSAC samples, (N_CANDIDATES, 256, 6), are drawn from
    ``generator`` unless ``sample_idx`` gives them.

    Returns (ok, q, t, kp_to_mp (P,) int32, n_inliers, candidate_kf), all
    device tensors."""
    top_idx, cand_ok, node_id = _candidates(m, db, frame, vocab)
    q1s, t1s, kp_mp1s, n1s = _candidate_ladder(
        m, kf_node, frame, node_id, top_idx, cand_ok, cfg, generator,
        sample_idx)
    # the winner by post-LM inlier count, the first among equal counts
    best = first_argmax(n1s).reshape(1)
    n1 = _pick(n1s, best)
    kp_mp1 = torch.where(n1 >= 0, _pick(kp_mp1s, best),
                         torch.full_like(kp_mp1s[0], -1))
    q2, t2, kp_mp, n2 = _widen(m, frame, _pick(q1s, best), _pick(t1s, best),
                               kp_mp1, cfg)
    ok = torch.any(cand_ok) & (n1 >= 0) & (n2 >= MIN_INLIERS_ACCEPT)
    return ok, q2, t2, kp_mp, n2, _pick(top_idx, best).to(torch.int32)


class Relocalizer:
    """Relocalization against a map and the loop closer's BoW index."""

    def __init__(self, cfg: SlamConfig, vocab: vocabulary.Vocabulary):
        self.cfg = cfg
        self.vocab = vocab

    def relocalize(self, m, db, kf_node, frame, generator=None,
                   sample_idx=None):
        """Returns (ok, q, t, kp_to_mp, n_inliers, candidate_kf), device
        tensors; the caller fetches ``ok`` to decide."""
        return relocalize(m, db, kf_node, frame, self.cfg, self.vocab,
                          generator=generator, sample_idx=sample_idx)
