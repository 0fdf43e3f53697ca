"""Multi-session map merging: align a second session's map into the first.

Port of ``orb_slam_2_ros_tpu/pipeline/map_merge.py`` (the reference's own
extension: ORB-SLAM2 itself only saves, loads and relocalizes). The merge
is driven by place recognition, with the loop-closing machinery:

1. every keyframe of map A enters a BoW database;
2. map B's keyframes query it; the best-scoring pair of keyframes is
   matched by descriptor and their common landmarks feed a Horn-RANSAC
   Sim3 between the two camera frames, refined by the Sim3 LM and lifted
   to the two world frames;
3. on acceptance, map B is re-expressed through the Sim3 and appended to
   map A's pools (keyframe rows, point rows, observation ids offset);
4. the seam is left to the loop closer's next passes.

Host orchestration, as in the reference: merging is rare. The BoW scores
of all of map B's keyframes come back in one fetch. The RANSAC draws from
``generator``, or takes ``sample_idx`` to reproduce another draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.geometry import se3, sim3
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.map.state import row
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax
from orb_slam_2_ros_tpu_torch.place import database, vocabulary
from orb_slam_2_ros_tpu_torch.solvers import sim3_solver

MIN_MERGE_INLIERS = 20    # Sim3 accept gate (mirrors LoopClosing.cc:439)


def _bow(m: map_state.MapState, k: int, vocab):
    """BoW row (word ids, weights) of keyframe row k."""
    wid, _, tfidf = vocabulary.transform(
        vocab, m.kf_desc[k], m.kf_kp_valid[k] & m.kf_valid[k])
    return wid, vocabulary.bow_weights(wid, tfidf, vocab.num_words)


def _ingest_all(m: map_state.MapState, vocab, cfg: SlamConfig):
    """A BoW database with a row for every valid keyframe of a map (the
    reference's predicated add: an invalid keyframe leaves its row as it
    was). Reads the keyframe count and validity once."""
    db = database.empty(cfg, m.kf_q.device)
    n = int(m.n_kfs)
    valid = m.kf_valid[:n].tolist()
    for k in range(n):
        if valid[k]:
            db = database.add(db, k, *_bow(m, k, vocab))
    return db


def match_pair(m1: map_state.MapState, m2: map_state.MapState, c1: int,
               k2: int, cfg: SlamConfig):
    """Descriptor matching between keyframe c1 of map 1 and k2 of map 2
    over all pairs (``search_by_node`` with one node for every keypoint),
    and the landmark pairs it gives. Returns (pair_ok (P,), x1c, x2c, uv1,
    uv2): the pairs' points in the two cameras' frames and their pixels,
    aligned on k2's keypoints."""
    i64 = torch.int64
    c1_t = torch.tensor(c1, device=m1.kf_q.device)
    k2_t = torch.tensor(k2, device=m2.kf_q.device)
    mp1_row, mp2 = row(m1.kf_mp, c1_t), row(m2.kf_mp, k2_t)
    valid_1 = row(m1.kf_kp_valid, c1_t) & (mp1_row >= 0) & row(m1.kf_valid,
                                                                 c1_t)
    valid_2 = row(m2.kf_kp_valid, k2_t) & (mp2 >= 0) & row(m2.kf_valid, k2_t)
    zeros1 = torch.zeros((m1.P,), dtype=torch.int32, device=mp1_row.device)
    zeros2 = torch.zeros((m2.P,), dtype=torch.int32, device=mp2.device)
    two_to_one, _ = matcher.search_by_node(
        row(m1.kf_desc, c1_t), zeros1, valid_1, row(m1.kf_angle, c1_t),
        row(m2.kf_desc, k2_t), zeros2, valid_2, row(m2.kf_angle, k2_t), cfg)
    i1 = torch.clamp(two_to_one, min=0).to(i64)
    mp1 = mp1_row[i1]
    pair_ok = (two_to_one >= 0) & (mp1 >= 0) & (mp2 >= 0)
    x1w = m1.mp_pos[torch.clamp(mp1, min=0).to(i64)]
    x2w = m2.mp_pos[torch.clamp(mp2, min=0).to(i64)]
    x1c = se3.apply(row(m1.kf_q, c1_t), row(m1.kf_t, c1_t), x1w)
    x2c = se3.apply(row(m2.kf_q, k2_t), row(m2.kf_t, k2_t), x2w)
    return (pair_ok, x1c, x2c, row(m1.kf_uv, c1_t)[i1],
            row(m2.kf_uv, k2_t))


def best_pair(m1: map_state.MapState, m2: map_state.MapState, vocab,
              cfg: SlamConfig):
    """Place recognition: map B's keyframes query map A's BoW database;
    the first keyframe of B with the highest score and its best row of A
    win. Returns (kf1, kf2), (-1, -1) when nothing scores. The scores come
    back in one fetch."""
    db1 = _ingest_all(m1, vocab, cfg)
    best_c, best_s = [], []
    for k2 in range(int(m2.n_kfs)):
        wid, wt = _bow(m2, k2, vocab)
        scores, _ = database.query(db1, wid, wt, vocab.num_words)
        scores = torch.where(db1.kf_valid, scores,
                             torch.full_like(scores, -1.0))
        best_c.append(first_argmax(scores))
        best_s.append(torch.max(scores))
    best = (-1, -1, -1.0)
    if best_c:
        cs = torch.stack(best_c).tolist()
        for k2, sc in enumerate(torch.stack(best_s).tolist()):
            if sc > best[2]:
                best = (int(cs[k2]), k2, sc)
    return best[0], best[1]


def solve_pair(m1: map_state.MapState, m2: map_state.MapState, c1: int,
               k2: int, cfg: SlamConfig, generator: torch.Generator = None,
               fix_scale: bool = True, sample_idx: torch.Tensor = None):
    """The world-to-world Sim3 ``x1 ~ S(x2)`` from keyframe c1 of map 1 and
    k2 of map 2: RANSAC over their common landmarks, the Sim3 LM, then the
    camera-frame Sim3 lifted to the world frames. Returns (ok, q, t, s,
    n_inliers)."""
    pair_ok, x1c, x2c, uv1, uv2 = match_pair(m1, m2, c1, k2, cfg)
    if sample_idx is None:
        pw = pair_ok.to(torch.float32)
        # no pair at all: draw uniformly (the count rejects; a multinomial
        # over zeros would fault on the device)
        pw = pw + (torch.sum(pw) == 0).to(torch.float32)
        sample_idx = torch.multinomial(pw, 256 * 3, replacement=True,
                                       generator=generator).reshape(256, 3)
    q12, t12, s12, _, _ = sim3_solver.ransac_sim3(
        x1c, x2c, pair_ok, uv1, uv2, cfg, fix_scale=fix_scale,
        sample_idx=sample_idx)
    q12, t12, s12, _, n_inl = sim3_solver.refine_sim3_lm(
        q12, t12, s12, x1c, x2c, uv1, uv2, pair_ok, cfg, fix_scale=fix_scale)
    # S_w1<-w2 = T1w^-1 * S_c1<-c2 * T2w
    S1 = sim3.from_se3(m1.kf_q[c1], m1.kf_t[c1])
    S2 = sim3.from_se3(m2.kf_q[k2], m2.kf_t[k2])
    qw, tw, sw = sim3.compose(*sim3.inverse(*S1),
                              *sim3.compose(q12, t12, s12, *S2))
    n_inl = int(n_inl)
    return n_inl >= MIN_MERGE_INLIERS, qw, tw, sw, n_inl


def align_sim3(m1: map_state.MapState, m2: map_state.MapState, vocab,
               cfg: SlamConfig, generator: torch.Generator = None,
               fix_scale: bool = True, sample_idx: torch.Tensor = None):
    """Find the world-to-world Sim3 ``x1 ~ S(x2)`` by place recognition
    (``best_pair``, then ``solve_pair``). Returns (ok, q, t, s, n_inliers,
    (kf1, kf2)): the transform mapping map-2 world coordinates into map
    1's frame."""
    c1, k2 = best_pair(m1, m2, vocab, cfg)
    if c1 < 0:
        return False, None, None, None, 0, (c1, k2)
    ok, qw, tw, sw, n_inl = solve_pair(m1, m2, c1, k2, cfg, generator,
                                       fix_scale, sample_idx)
    return ok, qw, tw, sw, n_inl, (c1, k2)


def transform_map(m: map_state.MapState, q, t, s) -> map_state.MapState:
    """Re-express a map through a world Sim3 y = S(x): points and keyframe
    centres move with S, rotations pick up R_S^-1 (projections are
    invariant to the leftover uniform scaling of the camera frames, which
    is how a monocular scale enters). ``s`` is a number or a tensor of one
    element."""
    s = torch.as_tensor(s, dtype=torch.float32, device=m.kf_q.device)
    s1 = s.reshape(1)
    pos = sim3.apply(q, t, s1, m.mp_pos)
    c_new = sim3.apply(q, t, s1, se3.camera_center(m.kf_q, m.kf_t))
    q_new = se3.quat_mul(m.kf_q, se3.quat_conj(q)[None, :])
    t_new = -se3.quat_rotate(q_new, c_new)
    # the scale-invariance distance bands scale with the world
    return m._replace(
        mp_pos=pos, kf_q=se3.quat_normalize(q_new), kf_t=t_new,
        mp_min_dist=m.mp_min_dist * s1, mp_max_dist=m.mp_max_dist * s1,
        mp_normal=se3.quat_rotate(q[None, :], m.mp_normal))


def concat_maps(m1: map_state.MapState,
                m2: map_state.MapState) -> map_state.MapState:
    """Append m2's keyframe rows [0, n_kfs) and point rows [0, n_mps) to
    m1's (ids offset). The pools must hold both maps (``ValueError``
    otherwise). Reads the four counts."""
    n1, n2 = int(m1.n_kfs), int(m2.n_kfs)
    p1, p2 = int(m1.n_mps), int(m2.n_mps)
    if n1 + n2 > m1.K or p1 + p2 > m1.M:
        raise ValueError(
            f"merged map exceeds pool capacity: {n1}+{n2} KFs of {m1.K}, "
            f"{p1}+{p2} points of {m1.M}")
    P = m1.P

    def shift(x, by):
        return torch.where(x >= 0, x + by, torch.full_like(x, -1))

    m2 = m2._replace(kf_mp=shift(m2.kf_mp, p1),
                     mp_obs_tbl=shift(m2.mp_obs_tbl, n1 * P),
                     mp_first_kf=shift(m2.mp_first_kf, n1))
    out = {}
    for f in map_state.MapState._fields:
        a, b = getattr(m1, f), getattr(m2, f)
        if f.startswith("kf_"):
            out[f] = torch.cat([a[:n1], b[:n2], a[n1 + n2:]])
        elif f.startswith("mp_"):
            out[f] = torch.cat([a[:p1], b[:p2], a[p1 + p2:]])
    return map_state.MapState(
        **out, n_kfs=torch.full_like(m1.n_kfs, n1 + n2),
        n_mps=torch.full_like(m1.n_mps, p1 + p2))


def append_map(m1: map_state.MapState, m2: map_state.MapState, q, t, s,
               cfg: SlamConfig) -> map_state.MapState:
    """Map 2 re-expressed through the Sim3 and appended to map 1, with the
    points' statistics refreshed."""
    return map_state.refresh_point_stats(
        concat_maps(m1, transform_map(m2, q, t, s)), cfg)


def merge_maps(m1: map_state.MapState, m2: map_state.MapState, vocab,
               cfg: SlamConfig, generator: torch.Generator = None,
               fix_scale: bool = True, sample_idx: torch.Tensor = None
               ) -> Tuple[Optional[map_state.MapState], dict]:
    """Full merge: align (place recognition + Sim3) and concatenate.
    Without a generator the draw comes from one seeded ``cfg.seed + 7``
    (the reference's ``PRNGKey(cfg.seed + 7)``).

    Returns (merged map or None, info dict)."""
    if generator is None and sample_idx is None:
        generator = torch.Generator(device=m1.kf_q.device)
        generator.manual_seed(cfg.seed + 7)
    ok, q, t, s, n_inl, pair = align_sim3(m1, m2, vocab, cfg, generator,
                                          fix_scale=fix_scale,
                                          sample_idx=sample_idx)
    info = {"aligned": ok, "inliers": n_inl, "pair": pair}
    if not ok:
        return None, info
    merged = append_map(m1, m2, q, t, s, cfg)
    info["sim3"] = (q.cpu().numpy(), t.cpu().numpy(),
                    float(s.reshape(-1)[0]))
    return merged, info
