"""Loop closing: detection, Sim3 computation, correction, global BA.

Port of ``orb_slam_2_ros_tpu/pipeline/loop_closing.py`` (the ``LoopClosing``
thread, ``LoopClosing.cc``) for one device. The reference's five compiled
programs are plain functions on tensors here:

1. ``_ingest_and_detect``: BoW-transform newly committed keyframes into the
   database and run ``DetectLoop`` on each (candidate query with the
   covisibility exclusion and the minScore floor, then the
   3-consecutive-detections consistency counter over expanded covisibility
   groups). How many keyframes wait is a host fact: the caller knows the
   keyframe count and the closer counts what it ingested, so nothing is
   read from the device.
2. ``_sim3_check``: the acceptance ladder of ``ComputeSim3``: BoW-gated
   pairing, Horn-RANSAC Sim3, SearchBySim3 mutual match growing, two-phase
   Huber-LM refinement (>= 20 inliers) and >= 40 correspondences after the
   Scw widening. Three launches of the matcher kernel.
3. ``_apply_correction``: essential-graph optimisation over chain,
   covisibility and loop edges, point correction through the owner
   keyframes, the cross-seam weld and SearchAndFuse over the current
   keyframe and its 8 best covisible ones (nine launches of the matcher
   kernel), and the loop edge's record.
4. ``_gba_start`` / ``_gba_step`` / ``_gba_finish``: the chunked dense
   global BA and its reconciliation with the map that kept growing.

With a mesh (``LoopCloser(mesh=)``, ``parallel/``) the global BA is the
reference's mesh branch (``loop_closing.py:950-970``): the edge list of
every valid keyframe row (``ba.build_problem``) padded to the ``mp`` axis,
the matrix-free CG chunk with the point pool and the edges split over that
axis (``dist_ba.distributed_gba_chunk``), and the pool gathered whole for
the reconciliation. Its faults are kept, as the reference's mesh runs show
them: it ignores ``cfg.solver.gba_structure_only`` (every valid camera but
the first moves), it carries no loop-edge priors, and it has no robust
kernel.

Deviations kept from the reference: the background GBA carries a divergence
guard (``step_background``), the widening group adds temporal neighbours,
and the fuse sweep searches at the base octave.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.geometry import se3, sim3
from orb_slam_2_ros_tpu_torch.map import state as map_state
from orb_slam_2_ros_tpu_torch.map.state import row, set_row, set_rows
from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import _kf_as_frame
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax, top_k_stable
from orb_slam_2_ros_tpu_torch.parallel import dist_ba
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span
from orb_slam_2_ros_tpu_torch.place import database, vocabulary
from orb_slam_2_ros_tpu_torch.solvers import ba, pose_graph, sim3_solver

MAX_NEW_PER_STEP = 4      # keyframes BoW-ingested per pipeline step
COVIS_EDGE_TH = 100       # essential-graph covisibility gate (Optimizer.cc:1073)
COVIS_EDGE_DEG = 8        # bounded covisibility degree in the pose graph
MIN_SIM3_INLIERS = 20     # Sim3 accept gate (LoopClosing.cc:439)
MIN_BOW_PAIRS = 20        # matches needed before trying Sim3 (:307)
MIN_TOTAL_MATCHES = 40    # widened-projection accept (LoopClosing.cc:466)
MAX_LOOP_EDGES = 16       # persistent loop-edge slots (KeyFrame::mspLoopEdges;
                          # every past edge re-enters each essential-graph
                          # run, Optimizer.cc:1047)
GBA_CHUNK_ITERS = 5       # LM iterations per background-GBA chunk; the host
                          # checks the abort condition between chunks
N_FUSE_ROWS = 9           # the current keyframe + its 8 best covisible ones
LADDER_LAUNCHES = 3       # matcher-kernel launches of one Sim3 ladder


class LoopState(NamedTuple):
    """Device-resident loop-closing context. How many keyframes the
    database holds is a host integer of ``LoopCloser``, not a field here."""

    db: database.BowDatabase
    kf_node: torch.Tensor       # (K, P) int32 vocab node per keypoint
    consist_cnt: torch.Tensor   # (K,) int32 consecutive-consistency counts
    last_loop_kf: torch.Tensor  # () int32 kf row of the last closed loop
    # persistent loop edges: accepted (c, k) pairs with their MEASURED
    # relative Sim3, so that a later closure cannot reopen an earlier seam
    loop_ei: torch.Tensor       # (L,) int32 loop keyframe c
    loop_ej: torch.Tensor       # (L,) int32 current keyframe k
    loop_rq: torch.Tensor       # (L, 4) measured S_kc rotation
    loop_rt: torch.Tensor       # (L, 3)
    loop_rs: torch.Tensor       # (L, 1) scale (geometry/sim3.py convention)
    n_loop_edges: torch.Tensor  # () int32 lifetime count


def empty_state(cfg: SlamConfig, device) -> LoopState:
    K = cfg.map.max_kfs
    L = MAX_LOOP_EDGES
    i32, f32 = torch.int32, torch.float32
    kw = dict(device=device)
    return LoopState(
        db=database.empty(cfg, device),
        kf_node=torch.full((K, cfg.map.max_kps), -1, dtype=i32, **kw),
        consist_cnt=torch.zeros((K,), dtype=i32, **kw),
        last_loop_kf=torch.full((), -1, dtype=i32, **kw),
        loop_ei=torch.zeros((L,), dtype=i32, **kw),
        loop_ej=torch.zeros((L,), dtype=i32, **kw),
        loop_rq=se3.quat_identity((L,), device),
        loop_rt=torch.zeros((L, 3), dtype=f32, **kw),
        loop_rs=torch.ones((L, 1), dtype=f32, **kw),
        n_loop_edges=torch.zeros((), dtype=i32, **kw))


def _with_row(pool: torch.Tensor, r: int, vals) -> torch.Tensor:
    """``pool.at[r].set(vals)`` for a host integer r."""
    out = pool.clone()
    out[r] = vals
    return out


def _mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """(n,) bool, True at ``idx`` (int64, in [0, n]; slot n is a spare that
    is dropped): ``zeros(n).at[idx].set(True, mode="drop")``."""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=idx.device)
    return out.index_fill(0, idx.reshape(-1), True)[:n]


def _group_points(m: map_state.MapState, group_kf: torch.Tensor):
    """(M,) bool: the valid map points observed by the keyframes of
    ``group_kf`` (K,) bool."""
    M = m.M
    obs = torch.where(group_kf[:, None] & (m.kf_mp >= 0),
                      m.kf_mp.to(torch.int64),
                      torch.full((), M, dtype=torch.int64,
                                 device=m.kf_mp.device))
    return _mark(M, obs) & m.mp_valid


# ------------------------------------------------------------------ programs

def _detect(m: map_state.MapState, st: LoopState, covis, k: int,
            cfg: SlamConfig, vocab, min_gap_frames: int, n_kfs: int):
    """DetectLoop for keyframe row k (``LoopClosing.cc:110-274``): candidate
    query + minScore floor + 3-consecutive consistency over expanded
    covisibility groups. Returns (st, best_candidate, found)."""
    K = m.K
    dev = covis.device
    rows = torch.arange(K, device=dev)
    neigh = covis[k] >= cfg.map.covis_th
    # recent keyframes trivially share words: exclude a gap, measured in
    # FRAMES (culling leaves the keyframe rows sparser than the original's
    # keyframe ids, so its 10-keyframe heuristics translate to footage)
    fid_k = m.kf_frame_id[k]
    exclude = neigh | (rows == k) | (m.kf_frame_id > fid_k - min_gap_frames)
    with span("loop.query"):
        queried = database.query(st.db, st.db.kf_word[k], st.db.kf_wt[k],
                                 vocab.num_words)
    scores = queried[0]
    inf = torch.full_like(scores, float("inf"))
    min_score = torch.min(torch.where(neigh & st.db.kf_valid, scores, inf))
    min_score = torch.where(torch.isfinite(min_score), min_score,
                            torch.full_like(min_score, 0.015))
    with span("loop.detect_candidates"):
        cand = database.detect_candidates(
            st.db, st.db.kf_word[k], st.db.kf_wt[k], exclude, covis,
            vocab.num_words, min_score=None, queried=queried)
    cand = cand & (scores >= min_score)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    group = cand[:, None] & ((covis > 0) | eye)             # (K, K)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    inherited = torch.max(
        torch.where(group, st.consist_cnt[None, :], zero), dim=1).values
    cnt = torch.where(cand, inherited + 1, zero)
    enough = cand & (cnt >= 3)
    # the count is stored on the candidate's WHOLE covisibility group: the
    # next keyframe's candidate is typically a few keyframes further along
    # the revisited segment, covisible with members of the previous group
    # but not with its leader row, and must still inherit the chain
    cnt_grp = torch.max(torch.where(group, cnt[:, None], zero), dim=0).values
    st = st._replace(consist_cnt=cnt_grp)
    best = first_argmax(torch.where(enough, scores,
                                    torch.full_like(scores, -1.0)))
    llk = st.last_loop_kf
    last_fid = torch.where(
        llk >= 0, row(m.kf_frame_id, torch.clamp(llk, min=0)),
        torch.full_like(fid_k, -(10 ** 9)))
    found = torch.any(enough) & (fid_k - last_fid > min_gap_frames)
    if n_kfs <= 3:
        found = torch.zeros_like(found)
    return st, best.to(torch.int32), found


@span("loop.ingest_and_detect")
def _ingest_and_detect(m: map_state.MapState, st: LoopState, cfg: SlamConfig,
                       vocab: vocabulary.Vocabulary, min_gap_frames: int,
                       n_kfs: int, n_ingested: int):
    """Ingest up to ``MAX_NEW_PER_STEP`` waiting keyframes, one after
    another, and run the detection on each (the reference's consumer loop
    pops one keyframe per iteration, ``LoopClosing.cc:59-94``, so the
    3-consecutive-keyframe window advances per keyframe even when several
    land in one tracking chunk). A step that ingested nothing re-detects
    the newest keyframe, so that a candidate that persists while no
    keyframe arrives still accumulates consistency.

    ``n_kfs`` (the map's keyframe count) and ``n_ingested`` are host
    integers. Returns (st, verdict (2,) int32 device tensor [cand, k] with
    cand = -1 where nothing was found, n_ingested)."""
    dev = m.kf_q.device
    # one covisibility build serves every sub-step (the observation table
    # does not change during ingestion)
    with span("loop.covisibility"):
        covis = map_state.covisibility(m)
    cand_out = torch.full((), -1, dtype=torch.int32, device=dev)
    k_out = torch.full((), max(n_kfs - 1, 0), dtype=torch.int32, device=dev)

    def merge(found, best, k, cand_out, k_out):
        return (torch.where(found, best, cand_out),
                torch.where(found, torch.full_like(k_out, k), k_out))

    n_before = n_ingested
    for _ in range(MAX_NEW_PER_STEP):
        if n_ingested >= n_kfs:
            break
        r = min(n_ingested, m.K - 1)
        with span("loop.transform"):
            wid, nid, tfidf = vocabulary.transform(
                vocab, m.kf_desc[r], m.kf_kp_valid[r] & m.kf_valid[r])
        with span("loop.bow_weights"):
            wt = vocabulary.bow_weights(wid, tfidf, vocab.num_words)
        n_ingested += 1
        st = st._replace(
            db=database.add(st.db, r, wid, wt),
            kf_node=_with_row(st.kf_node, r, nid))
        st, best, found = _detect(m, st, covis, r, cfg, vocab,
                                  min_gap_frames, n_kfs)
        cand_out, k_out = merge(found, best, r, cand_out, k_out)
    if n_ingested == n_before and n_kfs > 0:
        newest = n_kfs - 1
        st, best, found = _detect(m, st, covis, newest, cfg, vocab,
                                  min_gap_frames, n_kfs)
        cand_out, k_out = merge(found, best, newest, cand_out, k_out)
    return st, torch.stack([cand_out, k_out]), n_ingested


@span("loop.sim3_ladder")
def _sim3_check(m: map_state.MapState, st: LoopState, c: int, k: int,
                cfg: SlamConfig, generator: torch.Generator = None,
                sample_idx: torch.Tensor = None):
    """The detection-confirmation ladder between keyframe rows k (current)
    and c (candidate), host integers: BoW pairs -> RANSAC Sim3 ->
    SearchBySim3 growth -> Huber-LM refine -> Scw widening -> verdict
    (``LoopClosing::ComputeSim3``, ``LoopClosing.cc:277-476``). Split from
    the correction so that a rejected candidate, the common case while a
    revisit streams by, costs this alone.

    Returns (accepted, n_inl, q12, t12, s12, kp_to_mp_w, counts) with
    counts a (4,) int32 tensor [accepted, n_inl, n_pairs, n_widened]."""
    K, P, M = m.K, m.P, m.M
    dev = m.kf_q.device
    i64 = torch.int64
    qk, tk, qc, tc = m.kf_q[k], m.kf_t[k], m.kf_q[c], m.kf_t[c]
    mp_k_all, mp_c = m.kf_mp[k], m.kf_mp[c]
    slots = torch.arange(P, device=dev)

    def clip(x):
        return torch.clamp(x, min=0).to(i64)

    def spare(ok, idx):
        return torch.where(ok, idx.to(i64), torch.full_like(idx, P, dtype=i64))

    # ---- BoW-gated matching between keyframes k (current) and c
    valid_k = m.kf_kp_valid[k] & (mp_k_all >= 0)
    valid_c = m.kf_kp_valid[c] & (mp_c >= 0)
    with span("loop.search_by_node"):
        c_to_k, _ = matcher.search_by_node(
            m.kf_desc[k], st.kf_node[k], valid_k, m.kf_angle[k],
            m.kf_desc[c], st.kf_node[c], valid_c, m.kf_angle[c], cfg)
    # pairs aligned on c's keypoint axis: j matched to i = c_to_k[j]
    i_idx = clip(c_to_k)
    mp_k = mp_k_all[i_idx]
    pair_ok = (c_to_k >= 0) & (mp_k >= 0) & (mp_c >= 0)
    x1 = se3.apply(qk, tk, m.mp_pos[clip(mp_k)])
    x2 = se3.apply(qc, tc, m.mp_pos[clip(mp_c)])
    uv1 = m.kf_uv[k][i_idx]
    uv2 = m.kf_uv[c]
    n_pairs = torch.sum(pair_ok, dtype=torch.int32)

    fix_scale = cfg.sensor != 0     # the monocular sensor estimates scale
    with span("loop.ransac_sim3"):
        q12, t12, s12, inl, n_inl = sim3_solver.ransac_sim3(
            x1, x2, pair_ok, uv1, uv2, cfg, generator, fix_scale=fix_scale,
            sample_idx=sample_idx)

    # ---- SearchBySim3 mutual match growing (ORBmatcher.cc:1104-1328):
    # project c's unmatched landmarks into k through the RANSAC Sim3 and
    # k's unmatched landmarks into c through its inverse; a pair found in
    # BOTH directions joins the correspondence set before the LM refine
    frame_k = _kf_as_frame(m, torch.tensor(k, device=dev))
    frame_c = _kf_as_frame(m, torch.tensor(c, device=dev))
    q0, t0 = se3.identity(device=dev)
    matched_k = _mark(P, spare(pair_ok, i_idx))
    # c -> k: sources are c's landmark-bearing, not-yet-matched kps
    src_c = (m.kf_kp_valid[c] & (mp_c >= 0) & m.mp_valid[clip(mp_c)]
             & ~pair_ok)
    x_ck = sim3.apply(q12, t12, s12, x2)
    with span("loop.search_by_projection_pose"):
        A, _ = matcher.search_by_projection_pose(
            x_ck, m.kf_desc[c], m.kf_octave[c], src_c, q0, t0, frame_k, cfg,
            th=7.5, check_rotation=False, exclude_kp=matched_k)
    # k -> c: sources are k's landmark-bearing, not-yet-matched kps
    src_k = (m.kf_kp_valid[k] & (mp_k_all >= 0)
             & m.mp_valid[clip(mp_k_all)] & ~matched_k)
    q21, t21, s21 = sim3.inverse(q12, t12, s12)
    x_kc = sim3.apply(q21, t21, s21,
                      se3.apply(qk, tk, m.mp_pos[clip(mp_k_all)]))
    with span("loop.search_by_projection_pose"):
        B, _ = matcher.search_by_projection_pose(
            x_kc, m.kf_desc[k], m.kf_octave[k], src_k, q0, t0, frame_c, cfg,
            th=7.5, check_rotation=False, exclude_kp=pair_ok)
    # mutual agreement on c's keypoint axis: c-kp i grew k-kp B[i] only
    # if k-kp B[i] picked i back (A[B[i]] == i)
    grown = torch.where((B >= 0) & (A[clip(B)] == slots), B,
                        torch.full_like(B, -1))
    c_to_k = torch.where(pair_ok, c_to_k, grown)
    pair_ok = pair_ok | (grown >= 0)
    i_idx = clip(c_to_k)
    mp_k = mp_k_all[i_idx]
    x1 = se3.apply(qk, tk, m.mp_pos[clip(mp_k)])
    uv1 = m.kf_uv[k][i_idx]

    # Huber-LM refinement over ALL correspondences (OptimizeSim3 refines
    # the full match set: the kernel downweights the outliers RANSAC
    # rejected, and matches that reproject under the refined transform are
    # regained); the verdict counts the refined inliers
    with span("loop.refine_sim3_lm"):
        q12, t12, s12, inl, n_inl = sim3_solver.refine_sim3_lm(
            q12, t12, s12, x1, x2, uv1, uv2, pair_ok, cfg,
            fix_scale=fix_scale)

    # ---- match widening: project the loop keyframe's neighbourhood
    # landmarks through the estimated Sim3 into keyframe k and count total
    # correspondences (SearchByProjection with Scw, LoopClosing.cc:439-476)
    with span("loop.covisibility"):
        covis0 = map_state.covisibility(m)
    # the matched keyframe's covisible set plus its TEMPORAL
    # neighbours: after the windowed BA's edge pruning old segments
    # keep few shared observations
    rows = torch.arange(K, device=dev)
    group_kf = ((covis0[c] > 0) | (torch.abs(rows - c) <= 3)) & m.kf_valid
    group_mp = _group_points(m, group_kf)
    # S_kw = S_kc * S_cw maps world -> keyframe-k camera coordinates
    qkw, tkw, skw = sim3.compose(q12, t12, s12, *sim3.from_se3(qc, tc))
    x_in_k = sim3.apply(qkw, tkw, skw, m.mp_pos)
    # per-landmark octave prediction from the viewing distance
    # (SearchByProjection(Scw) calls PredictScale per point)
    lvl_k = matcher.predict_level(torch.linalg.norm(x_in_k, dim=-1),
                                  m.mp_max_dist, cfg)
    # keypoints of k already claimed by refined Sim3 inliers: the
    # widening only FILLS EMPTY slots (LoopClosing.cc:439-449), so the
    # >= 40 gate counts Sim3 inliers plus widened additions
    matched_k2 = _mark(P, spare(pair_ok & inl, i_idx))
    with span("loop.search_by_projection_pose"):
        kp_to_mp_w, _ = matcher.search_by_projection_pose(
            x_in_k, m.mp_desc, lvl_k, group_mp, q0, t0, frame_k, cfg,
            th=10.0, check_rotation=False, exclude_kp=matched_k2)
    n_widened = torch.sum(kp_to_mp_w >= 0, dtype=torch.int32)
    accepted = ((n_inl >= MIN_SIM3_INLIERS) & (n_pairs >= MIN_BOW_PAIRS)
                & (n_inl + n_widened >= MIN_TOTAL_MATCHES))
    counts = torch.stack([accepted.to(torch.int32), n_inl, n_pairs,
                          n_widened])
    return accepted, n_inl, q12, t12, s12, kp_to_mp_w, counts


@span("loop.apply_correction")
def _apply_correction(m: map_state.MapState, st: LoopState, c: int, k: int,
                      q12, t12, s12, kp_to_mp_w, cfg: SlamConfig):
    """The accepted-loop correction: essential-graph optimisation, point
    correction, cross-seam weld, SearchAndFuse, loop-edge recording
    (``LoopClosing::CorrectLoop``, ``LoopClosing.cc:479-695``). Runs only
    when a loop actually closes. Returns (m, st)."""
    K, P, M = m.K, m.P, m.M
    dev = m.kf_q.device
    i64, f32 = torch.int64, torch.float32
    rows = torch.arange(K, device=dev)

    def clip(x):
        return torch.clamp(x, min=0).to(i64)

    def spare(ok, idx):
        return torch.where(ok, idx.to(i64), torch.full_like(idx, M, dtype=i64))

    with span("loop.covisibility"):
        covis = map_state.covisibility(m)
    # loop-side landmark group
    group_mp = _group_points(m, (covis[c] > 0) | (rows == c))

    # corrected Sim3 pose of keyframe k: S_kw = S_kc * S_cw
    q_corr, t_corr, s_corr = sim3.compose(
        q12, t12, s12, *sim3.from_se3(m.kf_q[c], m.kf_t[c]))
    q_old, t_old, s_old = sim3.from_se3(m.kf_q, m.kf_t)
    # seed the current keyframe at its corrected pose
    qv = _with_row(q_old, k, q_corr)
    tv = _with_row(t_old, k, t_corr)
    sv = _with_row(s_old, k, s_corr)

    # chain edges i -> i+1 (each keyframe's parent is its predecessor
    # in insertion order). Culled keyframes take part too: their stored
    # poses go on serving as reference anchors of the frame trajectory,
    # so the chain drags them along with the correction.
    exists = rows < m.n_kfs
    ei_chain, ej_chain = rows[:-1], rows[1:]
    w_chain = (exists[:-1] & exists[1:]).to(f32)
    # covisibility edges: the COVIS_EDGE_DEG best neighbours above the
    # threshold, the lower row first among equal counts
    w_top, idx_top = top_k_stable(covis, COVIS_EDGE_DEG)    # (K, D)
    ei_cov = rows.repeat_interleave(COVIS_EDGE_DEG)
    ej_cov = idx_top.reshape(-1)
    w_cov = ((w_top.reshape(-1) >= COVIS_EDGE_TH) & m.kf_valid[ei_cov]
             & m.kf_valid[ej_cov] & (ei_cov < ej_cov)).to(f32)
    # loop edges: every PAST accepted pair with its measured relative
    # Sim3, plus the current one
    L = MAX_LOOP_EDGES
    past_ok = (torch.arange(L, device=dev)
               < torch.clamp(st.n_loop_edges, max=L)).to(f32)
    this = torch.tensor([c, k], device=dev)
    ei_all = torch.cat([ei_chain, ei_cov, st.loop_ei.to(i64), this[:1]])
    ej_all = torch.cat([ej_chain, ej_cov, st.loop_ej.to(i64), this[1:]])
    w_all = torch.cat([w_chain, w_cov, 2.0 * past_ok,
                       torch.full((1,), 2.0, dtype=f32, device=dev)])

    # measured relative Sim3 of each edge: S_j * S_i^-1 at the poses
    # before the correction; the loop edges carry their own
    rq, rt, rs = sim3.compose(
        q_old[ej_all], t_old[ej_all], s_old[ej_all],
        *sim3.inverse(q_old[ei_all], t_old[ei_all], s_old[ei_all]))
    base = ei_chain.shape[0] + ei_cov.shape[0]
    rq = torch.cat([rq[:base], st.loop_rq, q12[None]])
    rt = torch.cat([rt[:base], st.loop_rt, t12[None]])
    rs = torch.cat([rs[:base], st.loop_rs, s12[None]])

    fixed = (rows == c) | ~exists
    with span("loop.essential_graph"):
        q2, t2, s2, _ = pose_graph.optimize_essential_graph(
            qv, tv, sv, ei_all, ej_all, rq, rt, rs, w_all, fixed, cfg)

    # correct the points through their reference keyframes
    owner = torch.clamp(m.mp_first_kf, 0, K - 1)
    with span("loop.correct_points"):
        new_pos = pose_graph.correct_points(
            m.mp_pos, owner, q_old, t_old, s_old, q2, t2, s2, m.mp_valid)
    q_se, t_se = sim3.to_se3(q2, t2, s2)
    m = m._replace(kf_q=q_se, kf_t=t_se, mp_pos=new_pos)

    # ---- Loop Fusion step 1 (LoopClosing.cc:595-615): the widened Scw
    # correspondences REPLACE the current keyframe's conflicting
    # observations (the loop-side landmark wins) and fill its free
    # keypoints: the cross-seam weld that makes the seam a reprojection
    # constraint for the global BA
    loop_side = group_mp & m.mp_valid
    ids = torch.arange(M, dtype=torch.int32, device=dev)
    none = torch.full((P,), -1, dtype=torch.int32, device=dev)
    repl = ids                  # landmark -> the landmark replacing it
    cand_w = torch.where(
        (kp_to_mp_w >= 0) & m.mp_valid[clip(kp_to_mp_w)], kp_to_mp_w,
        none)
    dstk = m.kf_mp[k]
    gain_k = (cand_w >= 0) & (dstk < 0)
    m = m._replace(kf_mp=_with_row(m.kf_mp, k,
                                   torch.where(gain_k, cand_w, dstk)))
    confl_k = ((cand_w >= 0) & (dstk >= 0) & (cand_w != dstk)
               & ~loop_side[clip(dstk)])
    # two keypoints can conflict onto one old point: the last writer
    # is kept, by an explicit choice (``set_rows``)
    repl = set_rows(repl, spare(confl_k, dstk), cand_w)

    # ---- SearchAndFuse (LoopClosing.cc:617-642, 698-755): project the
    # loop group's landmarks through the corrected poses into the
    # current keyframe and its covisible group; where a keypoint
    # already references a different landmark, the loop landmark
    # replaces it. The 8 best covisible rows are taken whether or not
    # they share anything; an invalid row contributes nothing.
    with span("loop.covisibility"):
        covis2 = map_state.covisibility(m)
    _, fuse_targets = top_k_stable(covis2[k], N_FUSE_ROWS - 1)
    fuse_rows = torch.cat([this[1:], fuse_targets])
    oct0 = torch.zeros((M,), dtype=torch.int32, device=dev)
    for ri in range(N_FUSE_ROWS):
        r = fuse_rows[ri]
        frame_r = _kf_as_frame(m, r)
        # the sweep searches at the base octave window (the reference's
        # documented deviation: predicted-level gating thins the
        # cross-seam fusion set enough for the GBA to relax the seam)
        with span("loop.search_by_projection_pose"):
            kp_to_lmp, _ = matcher.search_by_projection_pose(
                m.mp_pos, m.mp_desc, oct0, loop_side & row(m.kf_valid, r),
                row(m.kf_q, r), row(m.kf_t, r), frame_r, cfg, th=4.0,
                check_rotation=False)
        dst = row(m.kf_mp, r)
        gain = (kp_to_lmp >= 0) & (dst < 0)
        m = m._replace(kf_mp=set_row(
            m.kf_mp, r, torch.where(gain, kp_to_lmp, dst)))
        conflict = ((kp_to_lmp >= 0) & (dst >= 0) & (kp_to_lmp != dst)
                    & ~loop_side[clip(dst)])
        repl = set_rows(repl, spare(conflict, dst), kp_to_lmp)
    repl = repl[repl.to(i64)]           # squash two-level chains
    replaced = repl != ids
    # Replace merges the found/visible counters (MapPoint.cc:229-233)
    wtgt = spare(replaced, repl)
    zero = torch.zeros_like(m.mp_visible)
    vis = map_state.pad_row(m.mp_visible).index_add(
        0, wtgt, torch.where(replaced, m.mp_visible, zero))[:M]
    fnd = map_state.pad_row(m.mp_found).index_add(
        0, wtgt, torch.where(replaced, m.mp_found, zero))[:M]
    m = m._replace(
        kf_mp=torch.where(m.kf_mp >= 0, repl[clip(m.kf_mp)],
                          torch.full_like(m.kf_mp, -1)),
        mp_valid=m.mp_valid & ~replaced, mp_visible=vis, mp_found=fnd)

    # record the accepted pair as a persistent loop edge
    # (LoopClosing.cc:681-682). The slots are a RING: past MAX_LOOP_EDGES
    # accepted loops the oldest measured edge is retired.
    slot = int(st.n_loop_edges) % L
    st = st._replace(
        last_loop_kf=torch.full_like(st.last_loop_kf, k),
        consist_cnt=torch.zeros_like(st.consist_cnt),
        loop_ei=_with_row(st.loop_ei, slot, c),
        loop_ej=_with_row(st.loop_ej, slot, k),
        loop_rq=_with_row(st.loop_rq, slot, q12),
        loop_rt=_with_row(st.loop_rt, slot, t12),
        loop_rs=_with_row(st.loop_rs, slot, s12),
        n_loop_edges=st.n_loop_edges + 1)
    return m, st


@span("loop.gba_start")
def _gba_start(m: map_state.MapState, st: LoopState, cfg: SlamConfig,
               mesh=None):
    """Snapshot the map for the chunked global BA
    (``RunGlobalBundleAdjustment``, ``LoopClosing.cc:758-862``; no robust
    kernel, as the reference: the large seam residuals ARE the signal).
    The measured seams enter as SE3 priors of weight
    ``cfg.solver.gba_loop_prior_weight``.

    With a mesh: this rank's part of the edge-list ``GBAState`` (see the
    module's docstring), every valid camera but the first free whatever
    ``gba_structure_only`` says, and no priors."""
    dev = m.kf_q.device
    rows = torch.arange(m.K, device=dev)
    kp_valid = m.kf_kp_valid & m.kf_valid[:, None]
    cam_free = m.kf_valid & (rows > 0)
    if mesh is not None:
        prob = dist_ba.pad_problem(
            ba.build_problem(m.kf_uv, m.kf_ur, m.kf_octave, m.kf_mp,
                             kp_valid, cfg), mesh.shape[cfg.mesh.mp_axis])
        g = ba.gba_init(m.kf_q, m.kf_t, cam_free, m.mp_pos, m.mp_valid, prob,
                        m.n_kfs, m.n_mps, cfg, robust=False)
        return dist_ba.shard_gba_state(mesh, g, cfg)
    if cfg.solver.gba_structure_only:
        cam_free = torch.zeros_like(cam_free)
    L = MAX_LOOP_EDGES
    live = torch.arange(L, device=dev) < torch.clamp(st.n_loop_edges, max=L)
    lw = live.to(torch.float32) * cfg.solver.gba_loop_prior_weight
    lt = st.loop_rt / torch.clamp(st.loop_rs, min=1e-9)
    return ba.dense_gba_init(
        m.kf_uv, m.kf_ur, m.kf_octave, m.kf_mp, kp_valid, m.kf_q, m.kf_t,
        cam_free, m.mp_pos, m.mp_valid, m.n_kfs, m.n_mps, cfg,
        loop_i=st.loop_ei, loop_j=st.loop_ej, loop_q=st.loop_rq, loop_t=lt,
        loop_w=lw)


@span("loop.gba_chunk")
def _gba_step(g, cfg: SlamConfig, mesh=None):
    if mesh is not None:
        return dist_ba.distributed_gba_chunk(mesh, g, cfg,
                                             n_iters=GBA_CHUNK_ITERS)
    return ba.dense_gba_chunk(
        g, cfg, n_iters=GBA_CHUNK_ITERS,
        structure_only=cfg.solver.gba_structure_only)


@span("loop.gba_finish")
def _gba_finish(m: map_state.MapState, g, mesh=None, cfg: SlamConfig = None):
    """Reconcile the GBA snapshot with the live map: keyframes and points
    that were IN the GBA take the optimised values; anything created (or
    culled) while it ran is corrected through its nearest in-GBA ancestor
    at the CURRENT relative pose, the spanning-tree propagation of
    ``RunGlobalBundleAdjustment`` (``LoopClosing.cc:790-850``). ``g`` is a
    ``DenseGBAState``, or with ``mesh`` (and its ``cfg``) a rank's part of a
    ``GBAState``, whose point pool is gathered whole first."""
    if mesh is not None:
        g = dist_ba.gather_gba_points(mesh, g, cfg)
    K, M = m.K, m.M
    dev = m.kf_q.device
    i64 = torch.int64
    rows = torch.arange(K, dtype=torch.int32, device=dev)
    exists = rows < m.n_kfs
    known = (g.cam_free | (rows == 0)) & (rows < g.n0)
    anc = torch.cummax(torch.where(known, rows, torch.full_like(rows, -1)),
                       dim=0).values
    a = torch.clamp(anc, min=0).to(i64)
    # current relative pose to the anchor, composed with the anchor's
    # optimised pose: T_iw' = (T_iw T_aw^-1) T_aw_gba
    q_ia, t_ia = se3.relative(m.kf_q, m.kf_t, m.kf_q[a], m.kf_t[a])
    q_prop, t_prop = se3.compose(q_ia, t_ia, g.q[a], g.t[a])
    use_prop = exists & ~known & (anc >= 0)
    q_new = torch.where(known[:, None], g.q,
                        torch.where(use_prop[:, None], q_prop, m.kf_q))
    t_new = torch.where(known[:, None], g.t,
                        torch.where(use_prop[:, None], t_prop, m.kf_t))
    # points: in-GBA points take the optimised positions; points created
    # during the GBA are re-expressed through their reference keyframe
    in_gba = (torch.arange(M, device=dev) < g.nm0) & g.mp_free
    r = torch.clamp(m.mp_first_kf, 0, K - 1).to(i64)
    x_r = se3.apply(m.kf_q[r], m.kf_t[r], m.mp_pos)
    qi, ti = se3.inverse(q_new[r], t_new[r])
    p_prop = se3.apply(qi, ti, x_r)
    prop_pt = m.mp_valid & ~in_gba & (m.mp_first_kf >= 0)
    pos_new = torch.where(in_gba[:, None], g.pos,
                          torch.where(prop_pt[:, None], p_prop, m.mp_pos))
    return m._replace(kf_q=q_new, kf_t=t_new, mp_pos=pos_new)


# ---------------------------------------------------------------- the closer

class LoopCloser:
    """Host orchestration of the loop-closing programs over one map.

    ``n_ladders`` and ``n_corrections`` count the Sim3 ladders and the
    corrections run (3 and 9 launches of the matcher kernel each);
    ``events`` logs each ladder and each finished GBA as a dict.

    ``mesh`` (``parallel.mesh.Mesh``): the global BA runs over it, its
    point pool and edges split over the ``mp`` axis (the module's
    docstring says what changes with it); everything else runs the same on
    every rank."""

    def __init__(self, cfg: SlamConfig, vocab: vocabulary.Vocabulary,
                 min_kfs_between_loops: int = 10,
                 background_gba: bool = False, mesh=None):
        self.cfg = cfg
        self.vocab = vocab
        self.device = vocab.node_desc.device    # the state lives beside it
        self.min_gap = min_kfs_between_loops
        # the reference's 10-keyframe-id gaps, converted to frames at its
        # keyframe density (~3 frames per keyframe early in a map): recency
        # exclusion for candidates and consecutive-closure suppression
        self.min_gap_frames = 3 * min_kfs_between_loops
        # background_gba=True: the post-correction global BA runs as
        # host-stepped chunks interleaved with tracking (step_background),
        # like the reference's detached GBA thread; False runs it to
        # completion inside process()
        self.background_gba = background_gba
        self.mesh = mesh
        if mesh is not None and cfg.map.max_mps % mesh.shape[cfg.mesh.mp_axis]:
            raise ValueError(
                f"the point pool (cfg.map.max_mps = {cfg.map.max_mps}) must "
                f"divide over the {mesh.shape[cfg.mesh.mp_axis]} shards of "
                f"the {cfg.mesh.mp_axis} axis")
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.seed)
        self.n_loops_closed = 0
        self.n_gba_aborts = 0
        self.n_gba_finished = 0
        self.n_gba_rejected = 0
        self.n_ladders = 0
        self.n_corrections = 0
        self.events = []
        self.reset()

    def reset(self):
        """Forget the database, the loop edges, the queued verdicts and any
        GBA in flight. The counters and the RANSAC stream go on."""
        self.state = empty_state(self.cfg, self.device)
        self._n_ingested = 0
        # dispatched-but-unchecked detection verdicts
        self._pending_verdict = []
        # in-flight GBA handle (None = idle); dropping it aborts
        # (the mnFullBAIdx invalidation protocol, LoopClosing.cc:490-502)
        self.gba = None     # DenseGBAState, or a rank's GBAState on a mesh
        self._gba_iters_done = 0

    def clear_index(self):
        """Forget the database, the loop edges and the queued verdicts, so
        that the next dispatch re-ingests the map from its first row (after
        a session merge); a GBA in flight goes on."""
        self.state = empty_state(self.cfg, self.device)
        self._n_ingested = 0
        self._pending_verdict = []

    # ------------------------------------------------------------- host API

    def apply_kf_compaction(self, remap_np):
        """Re-index the BoW database and the loop bookkeeping after a
        keyframe-pool compaction (``map_state.compact_keyframes``): rows
        moved with the same order-preserving permutation; culled rows
        dropped. A rare event that waits for the device: numpy permute and
        re-upload."""
        # pending detection verdicts index pre-compaction rows: drop them
        self._pending_verdict = []
        st = self.state
        dev = self.device
        remap_np = np.asarray(remap_np)
        K = len(remap_np)
        kept_old = np.flatnonzero(remap_np >= 0)
        inv = np.zeros(K, np.int64)           # new row -> old row
        inv[:len(kept_old)] = kept_old
        live = np.arange(K) < len(kept_old)

        def g(arr, fill=0):
            out = arr.cpu().numpy()[inv]
            out[~live] = fill
            return torch.from_numpy(out).to(dev)

        db = st.db._replace(kf_word=g(st.db.kf_word, -1),
                            kf_wt=g(st.db.kf_wt, 0.0),
                            kf_valid=g(st.db.kf_valid, False))
        # ingested rows form a prefix before AND after an order-preserving
        # compaction, so the new count is the kept-ingested count
        n_ing2 = int((kept_old < self._n_ingested).sum())
        llk = int(st.last_loop_kf)
        llk2 = -1
        if llk >= 0:
            # keep the loop-gap guard anchored at the nearest surviving row
            anchor = np.maximum.accumulate(
                np.where(remap_np >= 0, np.arange(K), -1))
            if anchor[llk] >= 0:
                llk2 = int(remap_np[anchor[llk]])
        # loop edges: re-index the endpoints; an edge touching a culled
        # keyframe is dropped (its measured Sim3 refers to a removed frame)
        nle = min(int(st.n_loop_edges), MAX_LOOP_EDGES)
        lei = st.loop_ei.cpu().numpy()[:nle]
        lej = st.loop_ej.cpu().numpy()[:nle]
        keep_e = (remap_np[lei] >= 0) & (remap_np[lej] >= 0)
        n_kept = int(keep_e.sum())
        fresh = empty_state(self.cfg, "cpu")

        def edges(name, kept):
            """The fresh pool ``name`` with the kept edges' values first."""
            out = getattr(fresh, name).numpy()
            out[:n_kept] = kept
            return torch.from_numpy(out).to(dev)

        def kept_of(pool):
            return pool.cpu().numpy()[:nle][keep_e]

        self._n_ingested = n_ing2
        self.state = st._replace(
            db=db, kf_node=g(st.kf_node, -1),
            consist_cnt=g(st.consist_cnt, 0),
            last_loop_kf=torch.full_like(st.last_loop_kf, llk2),
            loop_ei=edges("loop_ei", remap_np[lei[keep_e]]),
            loop_ej=edges("loop_ej", remap_np[lej[keep_e]]),
            loop_rq=edges("loop_rq", kept_of(st.loop_rq)),
            loop_rt=edges("loop_rt", kept_of(st.loop_rt)),
            loop_rs=edges("loop_rs", kept_of(st.loop_rs)),
            n_loop_edges=torch.full_like(st.n_loop_edges, n_kept))

    def dispatch(self, m: map_state.MapState, n_kfs: int = None):
        """Run one ingest + detect step and queue its verdict; nothing is
        fetched. ``n_kfs`` is the map's keyframe count where the caller has
        it on the host; without it the count is read from the device."""
        if n_kfs is None:
            n_kfs = int(m.n_kfs)
        self.state, verdict, self._n_ingested = _ingest_and_detect(
            m, self.state, self.cfg, self.vocab, self.min_gap_frames,
            n_kfs, self._n_ingested)
        self._pending_verdict.append(verdict)

    def ingest_pending(self, m: map_state.MapState, n_kfs: int):
        """BoW-ingest every keyframe of the first ``n_kfs`` rows that the
        index lacks, the detection results discarded: relocalization
        queries an index that may lag the map."""
        while self._n_ingested < n_kfs:
            self.state, _, self._n_ingested = _ingest_and_detect(
                m, self.state, self.cfg, self.vocab, self.min_gap_frames,
                n_kfs, self._n_ingested)

    def process(self, m: map_state.MapState, defer: bool = True,
                n_kfs: int = None):
        """One loop-closing step: ingest new keyframes, detect, and, when a
        consistent candidate exists, run the ladder and the correction.
        Returns (possibly corrected map, closed).

        With ``defer`` (the default) a verdict is consumed at a FIXED
        one-call lag: each call queues its own verdict and drains those of
        EARLIER calls, so the consumption schedule depends on the call
        count alone and two runs close their loops at the same frames.
        ``finish_pending`` drains the queue at the end of a sequence.
        ``defer=False`` consumes the call's own verdict at once."""
        self.dispatch(m, n_kfs)
        if not defer:
            return self._consume_verdict(m, self._pending_verdict.pop())
        closed_any = False
        while len(self._pending_verdict) > 1:
            m, closed = self._consume_verdict(m, self._pending_verdict.pop(0))
            closed_any = closed_any or closed
        return m, closed_any

    def finish_pending(self, m: map_state.MapState):
        """Drain every queued detection verdict (end of a sequence).
        Returns (map, any_closed)."""
        closed_any = False
        while self._pending_verdict:
            m, closed = self._consume_verdict(m, self._pending_verdict.pop(0))
            closed_any = closed_any or closed
        return m, closed_any

    def pop_lagged_verdict(self):
        """The verdict of the dispatch before last as host integers (cand,
        k), or None while fewer than two are queued: ``System`` consumes
        each verdict one chunk late. One fetch."""
        if len(self._pending_verdict) <= 1:
            return None
        cand, k = self._pending_verdict.pop(0).tolist()
        return cand, k

    def consume_host(self, m: map_state.MapState, cand: int, k_i: int):
        """Consume an already-fetched verdict. Returns (map, closed)."""
        if cand < 0:
            return m, False
        return self._run_ladder(m, cand, k_i)

    def _consume_verdict(self, m: map_state.MapState, verdict):
        cand, k_i = verdict.tolist()
        return self.consume_host(m, cand, k_i)

    def _run_ladder(self, m: map_state.MapState, cand: int, k_i: int):
        # a queued verdict's keyframes can be culled by the mapper between
        # dispatch and consumption: check liveness on the CURRENT map, in
        # one fetch, before paying for the ladder
        alive = m.kf_valid[[cand, k_i]].tolist()
        if not all(alive):
            return m, False
        self.n_ladders += 1
        accepted, _, q12, t12, s12, kp_to_mp_w, counts = _sim3_check(
            m, self.state, cand, k_i, self.cfg, generator=self._generator)
        acc, n_inl, n_pairs, n_widened = counts.tolist()
        self.events.append(dict(kind="ladder", cand=cand, k=k_i,
                                accepted=bool(acc), n_inl=n_inl,
                                n_pairs=n_pairs, n_widened=n_widened))
        if not acc:
            return m, False
        # the expensive correction runs ONLY here
        self.n_corrections += 1
        m2, self.state = _apply_correction(
            m, self.state, cand, k_i, q12, t12, s12, kp_to_mp_w, self.cfg)
        # drop the not-yet-checked verdicts: they predate this correction
        # and would re-close the same seam against the corrected map
        self._pending_verdict = []
        self.n_loops_closed += 1
        # a newer loop invalidates any in-flight GBA: its snapshot predates
        # this correction
        if self.gba is not None:
            self.n_gba_aborts += 1
        self.gba = _gba_start(m2, self.state, self.cfg, self.mesh)
        self._gba_iters_done = 0
        if not self.background_gba:
            m2 = self.run_gba_to_completion(m2)
        return m2, True

    @property
    def gba_running(self) -> bool:
        return self.gba is not None

    def _loop_edge_residual(self, m: map_state.MapState) -> float:
        """Max translation residual of the stored (measured) loop-edge
        Sim3s against the map's CURRENT relative poses: how well the map
        still honours the seams it closed. Numpy on the host after one
        batched fetch."""
        st = self.state
        L = min(int(st.n_loop_edges), MAX_LOOP_EDGES)
        if L == 0:
            return 0.0
        ei, ej, rt, rs, kf_q, kf_t = (
            x.cpu().numpy() for x in (st.loop_ei, st.loop_ej, st.loop_rt,
                                      st.loop_rs, m.kf_q, m.kf_t))
        rs = rs.reshape(-1)

        def qmul(a, b):
            aw, ax, ay, az = a
            bw, bx, by, bz = b
            return np.array([aw*bw - ax*bx - ay*by - az*bz,
                             aw*bx + ax*bw + ay*bz - az*by,
                             aw*by - ax*bz + ay*bw + az*bx,
                             aw*bz + ax*by - ay*bx + az*bw])

        def qrot(q, v):
            t2 = 2.0 * np.cross(q[1:], v)
            return v + q[0] * t2 + np.cross(q[1:], t2)

        worst = 0.0
        for a in range(L):
            c, k = int(ei[a]), int(ej[a])
            # T_kc = T_kw * T_cw^-1: q = qk*conj(qc), t = tk - R(q) tc
            qc, tc = kf_q[c], kf_t[c]
            qk, tk = kf_q[k], kf_t[k]
            qc_i = np.array([qc[0], -qc[1], -qc[2], -qc[3]])
            q_act = qmul(qk, qc_i)
            t_act = tk - qrot(q_act, tc)
            # the stored edge is a Sim3 whose translation carries the
            # measured scale, while t_act is SE3: compare in the common
            # SE3 frame (t/s, cf. sim3.to_se3)
            worst = max(worst, float(np.linalg.norm(
                rt[a] / max(rs[a], 1e-9) - t_act)))
        return worst

    def step_background(self, m: map_state.MapState):
        """Advance the in-flight GBA by one chunk; on the final chunk,
        reconcile with the live map. Returns (map, finished). The caller
        interleaves this with tracking chunks.

        Divergence guard (the reference's documented deviation): on
        sparsely connected maps the reprojection-only GBA can relax the
        loop correction back toward the pre-closure drift. The finish step
        checks the MEASURED loop-edge Sim3s against the optimised result:
        if the seam residual grew well beyond its value after the
        essential graph (> 15 cm or > 2.5x), the GBA's output is rejected
        and the corrected map kept (``n_gba_rejected`` counts this)."""
        if self.gba is None:
            return m, False
        self.gba = _gba_step(self.gba, self.cfg, self.mesh)
        self._gba_iters_done += GBA_CHUNK_ITERS
        if self._gba_iters_done < self.cfg.solver.global_ba_iters:
            return m, False
        r_before = self._loop_edge_residual(m)
        m2 = _gba_finish(m, self.gba, self.mesh, self.cfg)
        self.gba = None
        self.n_gba_finished += 1
        r_after = self._loop_edge_residual(m2)
        rejected = r_after > max(2.5 * r_before + 1e-3, 0.15)
        self.events.append(dict(kind="gba", seam_before=r_before,
                                seam_after=r_after, rejected=rejected))
        if rejected:
            self.n_gba_rejected += 1
            return m, True
        return m2, True

    def run_gba_to_completion(self, m: map_state.MapState):
        while self.gba is not None:
            m, _ = self.step_background(m)
        return m
