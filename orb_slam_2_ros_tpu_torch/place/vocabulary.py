"""Bag-of-words vocabulary: a k-ary descriptor tree as dense tensors.

Port of ``orb_slam_2_ros_tpu/place/vocabulary.py`` (DBoW2's
``TemplatedVocabulary``): the tree is ``levels`` flat arrays of node
descriptors, ``transform`` descends all keypoints of a frame at once with
``levels`` gather + Hamming-argmin steps, and scoring is DBoW2's L1 metric
in its ``sum_i min(v_i, w_i)`` form.

Training is hierarchical k-medians over binary descriptors with
bitwise-majority centroids, run once on the host in numpy. It is this
package's own copy of the reference's code and draws from
``np.random.default_rng(seed)`` in the same order, so the same descriptors
give the same tree bit for bit. Descriptor words are int32 with the
reference's uint32 bits. Loading and saving vocabulary files is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.frontend import extractor
from orb_slam_2_ros_tpu_torch.ops.hamming import popcount


class Vocabulary(NamedTuple):
    """Static-shape vocabulary tree.

    Level ``l`` (1-based, root excluded) holds ``k**l`` nodes; the children
    of node ``i`` at level ``l`` are nodes ``i*k .. i*k+k-1`` at level
    ``l+1``. ``node_desc`` concatenates the levels; ``level_offsets[l-1]``
    is the start of level ``l``. Leaves of level ``levels`` are the words.
    """

    node_desc: torch.Tensor     # (n_nodes, 8) int32 words
    word_weight: torch.Tensor   # (k**levels,) float32 idf
    k: int
    levels: int
    levels_up: int              # FeatureVector grouping level distance

    @property
    def num_words(self) -> int:
        return self.k ** self.levels

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for l in range(1, self.levels + 1):
            offs.append(acc)
            acc += self.k ** l
        return tuple(offs)


# --------------------------------------------------------------------- train

def _unpack_bits(desc_u32: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 bits."""
    as_u8 = desc_u32.astype("<u4").view(np.uint8).reshape(desc_u32.shape[0], 32)
    return np.unpackbits(as_u8, axis=1, bitorder="little")


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) bits -> (N, 8) uint32."""
    u8 = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return u8.view("<u4").astype(np.uint32)


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """(N, 256) x (M, 256) -> (N, M) int32 via one matmul-shaped xor-sum."""
    # bits are 0/1; |a xor b| = a + b - 2ab summed over the bit axis
    ab = a_bits.astype(np.int32) @ b_bits.astype(np.int32).T
    return (a_bits.sum(1, dtype=np.int32)[:, None]
            + b_bits.sum(1, dtype=np.int32)[None, :] - 2 * ab)


def _kmedians(bits: np.ndarray, k: int, rng: np.random.Generator,
              iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Binary k-medians: majority-bit centroids (DBoW2 ``HKmeansStep``
    analog). Returns (centers (k, 256), assignment (N,))."""
    n = bits.shape[0]
    if n == 0:
        centers = rng.integers(0, 2, (k, bits.shape[1]), dtype=np.uint8)
        return centers, np.zeros((0,), np.int64)
    init = rng.choice(n, size=min(k, n), replace=False)
    centers = bits[init]
    if centers.shape[0] < k:   # duplicate-pad tiny nodes
        pad = centers[rng.integers(0, centers.shape[0], k - centers.shape[0])]
        centers = np.concatenate([centers, pad], axis=0)
    assign = np.zeros((n,), np.int64)
    for _ in range(iters):
        assign = _hamming_np(bits, centers).argmin(1)
        for j in range(k):
            sel = bits[assign == j]
            if sel.shape[0]:
                centers[j] = (sel.mean(0) > 0.5).astype(np.uint8)
    assign = _hamming_np(bits, centers).argmin(1)
    return centers, assign


def train_vocabulary(descriptors: np.ndarray, cfg: SlamConfig, seed: int = 0,
                     *, device) -> Vocabulary:
    """Hierarchical k-medians training (DBoW2 ``create``) on the host; the
    tree's tensors go to ``device``. descriptors: (N, 8) uint32 (or int32
    words with the same bits). idf weights follow DBoW2 TF_IDF: ``log(N /
    N_i)`` with N_i = training features landing in word i."""
    k, L = cfg.vocab.k, cfg.vocab.levels
    rng = np.random.default_rng(seed)
    descriptors = np.asarray(descriptors)
    if descriptors.dtype == np.int32:
        descriptors = descriptors.view(np.uint32)
    bits = _unpack_bits(np.asarray(descriptors, np.uint32))
    n = bits.shape[0]

    level_descs = []
    groups = [np.arange(n)]            # member indices per node of prev level
    for l in range(1, L + 1):
        descs_l = np.zeros((k ** l, 256), np.uint8)
        next_groups = []
        for i, g in enumerate(groups):
            centers, assign = _kmedians(bits[g], k, rng)
            descs_l[i * k:(i + 1) * k] = centers
            for j in range(k):
                next_groups.append(g[assign == j] if g.size else g)
        level_descs.append(_pack_bits(descs_l))
        groups = next_groups

    counts = np.array([g.size for g in groups], np.float64)
    weights = np.log(max(n, 1) / np.maximum(counts, 1.0))
    weights[counts == 0] = 0.0

    nodes = np.ascontiguousarray(np.concatenate(level_descs, axis=0))
    return Vocabulary(
        node_desc=torch.from_numpy(nodes.view(np.int32)).to(device),
        word_weight=torch.from_numpy(weights.astype(np.float32)).to(device),
        k=k, levels=L, levels_up=cfg.vocab.levels_up)


def frame_descriptors(grays, frames, cfg: SlamConfig, device) -> np.ndarray:
    """The valid ORB descriptors of the gray images ``grays[i]`` for i in
    ``frames``, extracted on ``device``: (N, 8) int32 words on the host."""
    descs = [np.zeros((0, 8), np.int32)]
    for i in frames:
        kps = extractor.extract(
            torch.from_numpy(np.asarray(grays[i], np.float32)).to(device),
            cfg.orb)
        descs.append(kps.desc[kps.valid].cpu().numpy())
    return np.concatenate(descs)


def train_vocabulary_from_frames(grays, every: int, cfg: SlamConfig,
                                 seed: int = 0, *, device) -> Vocabulary:
    """An in-domain vocabulary: ``train_vocabulary`` on the descriptors of
    every ``every``-th image of ``grays``."""
    train = frame_descriptors(grays, range(0, len(grays), every), cfg, device)
    return train_vocabulary(train, cfg, seed=seed, device=device)


# ----------------------------------------------------------------- transform

def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Descend all descriptors through the tree at once.

    desc: (P, 8) int32 words, valid: (P,) bool.
    Returns (word_id (P,) int32 [-1 invalid], node_id (P,) int32 the
    FeatureVector grouping node at level ``levels - levels_up``, tf_idf (P,)
    float32 un-normalised word weights).

    Per level, the k candidate child descriptors of each keypoint's current
    node are gathered and the nearest is taken; among equal distances the
    lowest child wins, by a composite key (an ``argmin`` on CUDA promises
    no tie order)."""
    P = desc.shape[0]
    k = vocab.k
    dev = desc.device
    offsets = vocab.level_offsets
    kk = torch.arange(k, dtype=torch.int64, device=dev)
    idx = torch.zeros((P,), dtype=torch.int64, device=dev)
    node_id = idx
    for l in range(1, vocab.levels + 1):
        child_rows = offsets[l - 1] + idx[:, None] * k + kk[None, :]
        cand = vocab.node_desc[child_rows]                   # (P, k, 8)
        d = torch.sum(popcount(desc[:, None, :] ^ cand), dim=-1)   # int64
        best = torch.min(d * k + kk[None, :], dim=1).values % k
        idx = idx * k + best
        if l == vocab.levels - vocab.levels_up:
            node_id = idx
    none = torch.full((P,), -1, dtype=torch.int32, device=dev)
    word_id = torch.where(valid, idx.to(torch.int32), none)
    node_id = torch.where(valid, node_id.to(torch.int32), none)
    tf_idf = torch.where(valid, vocab.word_weight[idx],
                         torch.zeros((), dtype=torch.float32, device=dev))
    return word_id, node_id, tf_idf


def bow_weights(word_id: torch.Tensor, tf_idf: torch.Tensor, num_words: int):
    """Merge duplicate words and L1-normalise, keeping the sparse (per
    keypoint) layout: the weight lands on the FIRST keypoint of each word,
    later duplicates get 0 (the BowVector accumulation of
    ``TemplatedVocabulary.h:1195-1201``).

    Every keypoint of a word carries the same ``tf_idf`` (the word's idf),
    so the merged weight is taken as count x idf: exact, and the same
    whatever order a device would add in. Returns (P,) float32 weights
    aligned with word_id; their sum is 1 (or 0 without valid words)."""
    P = word_id.shape[0]
    dev = word_id.device
    ok = word_id >= 0
    tgt = torch.where(ok, word_id.to(torch.int64),
                      torch.full((), num_words, dtype=torch.int64, device=dev))
    count = torch.zeros((num_words + 1,), dtype=torch.int32, device=dev)
    count = count.index_add(0, tgt, ok.to(torch.int32))
    slots = torch.arange(P, dtype=torch.int32, device=dev)
    first = torch.full((num_words + 1,), P, dtype=torch.int32, device=dev)
    first = first.scatter_reduce(
        0, tgt, torch.where(ok, slots, torch.full_like(slots, P)),
        reduce="amin")
    is_first = ok & (first[tgt] == slots)
    w = torch.where(is_first, count[tgt].to(torch.float32) * tf_idf,
                    torch.zeros_like(tf_idf))
    total = torch.sum(w)
    return torch.where(total > 0, w / torch.clamp(total, min=1e-12),
                       torch.zeros_like(w))


def dense_bow(word: torch.Tensor, wt: torch.Tensor,
              num_words: int) -> torch.Tensor:
    """(num_words + 1,) dense vector of a merged sparse BoW row (the spare
    last slot takes the padding). After ``bow_weights`` one slot per word
    is non-zero and the rest add 0.0, so the scatter-add is exact in any
    order."""
    ok = word >= 0
    tgt = torch.where(ok, word.to(torch.int64),
                      torch.full((), num_words, dtype=torch.int64,
                                 device=word.device))
    dense = torch.zeros((num_words + 1,), dtype=torch.float32,
                        device=word.device)
    return dense.index_add(0, tgt, torch.where(ok, wt, torch.zeros_like(wt)))


def l1_score(word_a, w_a, word_b, w_b, num_words: int):
    """DBoW2 L1 score between two sparse BoW rows: sum_i min(a_i, b_i)
    (``ScoringObject.cpp`` L1Scoring). Inputs are (P,) word ids (-1 pad)
    and merged, normalised weights."""
    gb = dense_bow(word_b, w_b, num_words)[
        torch.clamp(word_a, min=0).to(torch.int64)]
    return torch.sum(torch.where(word_a >= 0, torch.minimum(w_a, gb),
                                 torch.zeros_like(w_a)))
