"""Keyframe BoW database: loop / relocalization candidate retrieval.

Port of ``orb_slam_2_ros_tpu/place/database.py`` (``KeyFrameDatabase``):
each keyframe row stores its merged, L1-normalised sparse BoW as fixed-shape
``(P,)`` word-id / weight tensors; a query is scattered once into a dense
``(num_words,)`` vector, and scores and shared-word counts for all keyframes
come from one ``(K, P)`` gather.

Candidate selection keeps the two stages of ``DetectLoopCandidates``
(``KeyFrameDatabase.cc:82-235``): keyframes sharing a word, minus the
excluded set, with ``commonWords > 0.8 * maxCommonWords`` and ``score >=
minScore``; then score accumulation over each candidate's 10 best covisible
neighbours, keeping groups above ``0.75 * bestAccScore`` and returning each
kept group's best member. Where the reference takes a top-k or an argmax
over values full of ties, the lower index comes first here too
(``ops/ties.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax, top_k_stable
from orb_slam_2_ros_tpu_torch.place.vocabulary import dense_bow

GROUP_TOP_K = 10   # covisibility-group size (KeyFrameDatabase.cc:170)


class BowDatabase(NamedTuple):
    kf_word: torch.Tensor    # (K, P) int32 word ids, -1 pad
    kf_wt: torch.Tensor      # (K, P) float32 merged+normalised weights
    kf_valid: torch.Tensor   # (K,) bool

    @property
    def K(self):
        return self.kf_word.shape[0]


def empty(cfg: SlamConfig, device) -> BowDatabase:
    K, P = cfg.map.max_kfs, cfg.map.max_kps
    return BowDatabase(
        kf_word=torch.full((K, P), -1, dtype=torch.int32, device=device),
        kf_wt=torch.zeros((K, P), dtype=torch.float32, device=device),
        kf_valid=torch.zeros((K,), dtype=torch.bool, device=device))


def add(db: BowDatabase, kf_id: int, word_id: torch.Tensor,
        wt: torch.Tensor) -> BowDatabase:
    """Insert or overwrite keyframe row ``kf_id``, a host integer
    (``KeyFrameDatabase::add``, ``KeyFrameDatabase.cc:37-47``)."""
    k = min(max(int(kf_id), 0), db.K - 1)
    kf_word, kf_wt, kf_valid = (db.kf_word.clone(), db.kf_wt.clone(),
                                db.kf_valid.clone())
    kf_word[k] = word_id
    kf_wt[k] = wt
    kf_valid[k] = True
    return BowDatabase(kf_word=kf_word, kf_wt=kf_wt, kf_valid=kf_valid)


def erase(db: BowDatabase, kf_id: int) -> BowDatabase:
    kf_valid = db.kf_valid.clone()
    kf_valid[int(kf_id)] = False
    return db._replace(kf_valid=kf_valid)


def scatter_any(n: int, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(n,) bool: whether any flag was written to each slot (``.at[idx]
    .max(flags)`` on booleans), as an integer max-scatter."""
    out = torch.zeros((n,), dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, idx, flags.to(torch.int32),
                              reduce="amax") > 0


def query(db: BowDatabase, q_word: torch.Tensor, q_wt: torch.Tensor,
          num_words: int):
    """Score the query BoW against every keyframe row.

    Returns (scores (K,) float32 L1 scores, common (K,) int32 shared
    distinct words)."""
    dense = dense_bow(q_word, q_wt, num_words)
    ok = q_word >= 0
    tgt = torch.where(ok, q_word.to(torch.int64),
                      torch.full((), num_words, dtype=torch.int64,
                                 device=q_word.device))
    present = scatter_any(num_words + 1, tgt, ok)

    kw = torch.clamp(db.kf_word, min=0).to(torch.int64)
    has = (db.kf_word >= 0) & (db.kf_wt > 0)          # merged: one slot/word
    qv = torch.where(has, dense[kw], torch.zeros_like(db.kf_wt))   # (K, P)
    scores = torch.sum(torch.minimum(db.kf_wt, qv), dim=1)
    common = torch.sum(has & present[kw], dim=1, dtype=torch.int32)
    scores = torch.where(db.kf_valid, scores, torch.zeros_like(scores))
    common = torch.where(db.kf_valid, common, torch.zeros_like(common))
    return scores, common


def detect_candidates(db: BowDatabase, q_word, q_wt, exclude: torch.Tensor,
                      covis: torch.Tensor, num_words: int,
                      min_score: float = None, queried=None):
    """Loop / relocalization candidates.

    exclude: (K,) bool, the query's covisible set + itself for loops
    (``KeyFrameDatabase.cc:96-107``), empty for relocalization.
    covis: (K, K) int32 covisibility weights (``map_state.covisibility``).
    min_score: BoW floor for loops (None for relocalization).
    queried: the (scores, common) of ``query`` on the same arguments, where
    the caller has them already. Returns (K,) bool candidate mask."""
    scores, common = (query(db, q_word, q_wt, num_words)
                      if queried is None else queried)
    K = scores.shape[0]
    dev = scores.device
    share = db.kf_valid & (common > 0) & ~exclude
    max_common = torch.max(torch.where(share, common,
                                       torch.zeros_like(common)))
    cand = share & (common.to(torch.float32)
                    > 0.8 * max_common.to(torch.float32))
    if min_score is not None:
        cand = cand & (scores >= min_score)

    w_top, idx_top = top_k_stable(covis, GROUP_TOP_K)
    member_ok = (w_top > 0) & cand[idx_top]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    member_sc = torch.where(member_ok, scores[idx_top], zero)
    acc = torch.where(cand, scores + torch.sum(member_sc, dim=1), zero)

    masked = torch.where(member_ok, member_sc, zero - 1.0)
    lead_sc = torch.max(masked, dim=1).values
    lead_arg = first_argmax(masked, dim=1)
    rows = torch.arange(K, dtype=torch.int64, device=dev)
    lead = torch.where(lead_sc > scores,
                       torch.gather(idx_top, 1, lead_arg[:, None])[:, 0], rows)

    best_acc = torch.max(acc)
    keep_group = cand & (acc > 0.75 * best_acc) & (best_acc > 0)
    # max-scatter so a False write never clobbers another group's leader
    out = scatter_any(K, lead, keep_group)
    # group leaders are themselves sharing keyframes; never return excluded
    return out & ~exclude & db.kf_valid
