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
reference's uint32 bits.

Vocabulary files: DBoW2's binary format (``load_orbvoc_binary``; the text
format too through ``load_orbvoc``, which writes the binary file beside a
text one, as ``System.cc:68-88`` does) and the npz layout of the
reference (``save_npz`` / ``load_npz``). The files are parsed by the
port's native C++ reader (``native/vocab_loader.cc``) or by this module's
Python readers: ``use_native`` chooses, and without it the native reader
runs when its library is already built (``native.is_built``). The Python
binary reader is numpy over the packed 45-byte records; the Python text
reader parses one node per line, which at ORBvoc scale takes minutes.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch import native
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


# ------------------------------------------------------------ vocabulary files

_REC = struct.Struct("<i?32sd")   # parent, isLeaf, descriptor, weight


def _parse_bin_py(path: str):
    """DBoW2 binary format (``TemplatedVocabulary.h:1473-1546``): header
    ``k L scoring weighting`` (int32), then per non-root node a packed
    45-byte record ``parent (int32) isLeaf (u8) desc (32 B) weight (f64)``.
    Returns (k, L, parents int32, is_leaf bool, descs (n, 32) u8, weights
    float64)."""
    with open(path, "rb") as f:
        k, L, _scoring, _weighting = struct.unpack("<iiii", f.read(16))
        raw = f.read()
    n_nodes = len(raw) // _REC.size
    arr = np.frombuffer(raw[:n_nodes * _REC.size], np.uint8).reshape(
        n_nodes, _REC.size)
    parents = arr[:, :4].copy().view("<i4")[:, 0]
    is_leaf = arr[:, 4].astype(bool)
    descs = arr[:, 5:37].copy()
    weights = arr[:, 37:45].copy().view("<f8")[:, 0]
    return k, L, parents.astype(np.int32), is_leaf, descs, weights


def _parse_txt_py(path: str):
    """DBoW2 text format (``loadFromTextFile``): a first line ``k L scoring
    weighting``, then one node per line, ``parent isLeaf b0 .. b31
    weight``. Same return as ``_parse_bin_py``."""
    with open(path, "r") as f:
        k, L = (int(v) for v in f.readline().split()[:2])
        rows = [line.split() for line in f if line.strip()]
    ints = np.array([r[:34] for r in rows], np.int64).reshape(-1, 34)
    weights = np.array([r[34] for r in rows], np.float64)
    return (k, L, ints[:, 0].astype(np.int32), ints[:, 1].astype(bool),
            ints[:, 2:].astype(np.uint8), weights)


def write_orbvoc_bin(path: str, k: int, L: int, parents, is_leaf, descs,
                     weights):
    """Write the DBoW2 binary format (``saveToBinFile``'s layout)."""
    n = len(parents)
    rec = np.zeros((n, _REC.size), np.uint8)
    rec[:, :4] = np.ascontiguousarray(parents, "<i4").view(np.uint8).reshape(
        n, 4)
    rec[:, 4] = np.asarray(is_leaf, np.uint8)
    rec[:, 5:37] = np.asarray(descs, np.uint8)
    rec[:, 37:45] = np.ascontiguousarray(weights, "<f8").view(
        np.uint8).reshape(n, 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", k, L, 0, 0))
        f.write(rec.tobytes())


def _parser(use_native):
    """The native reader and writer or the Python ones: ``use_native``, or
    without it whether the native library is built."""
    if use_native is None:
        use_native = native.is_built()
    if use_native:
        return native.parse_orbvoc, native.write_orbvoc_bin
    return (lambda path: _parse_txt_py(path) if path.endswith(".txt")
            else _parse_bin_py(path)), write_orbvoc_bin


def load_orbvoc(path: str, cfg: SlamConfig, auto_convert: bool = True, *,
                device, use_native: bool = None) -> Vocabulary:
    """Load a DBoW2 vocabulary, binary (``.bin``) or text (``.txt``),
    replicating ``System.cc:68-88``: a text vocabulary is parsed once and
    re-saved beside it in the binary format (``auto_convert``), so later
    loads take the binary path (``README.md:12``)."""
    parse, write = _parser(use_native)
    k, L, parents, is_leaf, descs, weights = parse(path)
    if path.endswith(".txt") and auto_convert:
        write(path[:-4] + ".bin", k, L, parents, is_leaf, descs, weights)
    return _relayout(k, L, parents, descs, weights, cfg, device)


def load_orbvoc_binary(path: str, cfg: SlamConfig, *, device,
                       use_native: bool = None) -> Vocabulary:
    """Binary-format loader (``TemplatedVocabulary.h:1473-1546``)."""
    k, L, parents, _, descs, weights = _parser(use_native)[0](path)
    return _relayout(k, L, parents, descs, weights, cfg, device)


def _vocab(node_desc: np.ndarray, word_weight: np.ndarray, k: int, L: int,
           levels_up: int, device) -> Vocabulary:
    return Vocabulary(
        node_desc=torch.from_numpy(np.ascontiguousarray(
            node_desc, np.uint32).view(np.int32)).to(device),
        word_weight=torch.from_numpy(np.asarray(
            word_weight, np.float32)).to(device),
        k=k, levels=L, levels_up=levels_up)


def _relayout(k, L, parents, descs, weights, cfg: SlamConfig,
              device) -> Vocabulary:
    """Re-lay the parent-linked node list into the dense level arrays of
    ``transform``. Nodes beyond a level's dense slots (DBoW2 trees are
    ragged where clusters were small) keep their parent's descriptor, so
    the descent stays well defined."""
    n_nodes = len(parents)

    # fast path: a COMPLETE tree in breadth-first id order (every level
    # full, children contiguous) re-lays with array reshapes, which ORBvoc
    # scale (k=10, L=6, 1.1 M nodes) needs
    sizes = [k ** lvl for lvl in range(1, L + 1)]
    if n_nodes == sum(sizes):
        starts = np.cumsum([0] + sizes)
        ids = np.arange(1, n_nodes + 1)
        lvl = np.searchsorted(starts[1:], ids - 1, side="right")
        slot = (ids - 1) - starts[lvl]
        expect_parent = np.where(
            lvl == 0, 0, starts[np.maximum(lvl - 1, 0)] + slot // k + 1)
        if np.array_equal(parents[:n_nodes].astype(np.int64), expect_parent):
            node_desc = np.ascontiguousarray(descs[:n_nodes]).view(
                "<u4").reshape(n_nodes, 8)
            return _vocab(node_desc, weights[starts[L - 1]:], k, L,
                          cfg.vocab.levels_up, device)

    # breadth-first from the root: record i holds node id i+1 (the root,
    # id 0, is not written); child j of dense node i sits at dense slot
    # i*k+j of the next level
    children = {}
    for i in range(n_nodes):
        children.setdefault(int(parents[i]), []).append(i + 1)
    level_descs, level_weights = [], []
    frontier = [(c, j) for j, c in enumerate(children.get(0, [])[:k])]
    for lvl in range(1, L + 1):
        n_l = k ** lvl
        d_l = np.zeros((n_l, 32), np.uint8)
        w_l = np.zeros((n_l,), np.float64)
        filled = np.zeros((n_l,), bool)
        nxt = []
        for nid, dense in frontier:
            d_l[dense] = descs[nid - 1]
            w_l[dense] = weights[nid - 1]
            filled[dense] = True
            for j, c in enumerate(children.get(nid, [])[:k]):
                nxt.append((c, dense * k + j))
        if lvl > 1 and level_descs:     # ragged holes: the parent's desc
            parent_d = np.repeat(level_descs[-1], k, axis=0)
            d_l[~filled] = parent_d[~filled]
        level_descs.append(d_l)
        level_weights.append(w_l)
        frontier = nxt
    node_desc = np.concatenate(
        [d.view("<u4").reshape(d.shape[0], 8) for d in level_descs], axis=0)
    return _vocab(node_desc, level_weights[-1], k, L, cfg.vocab.levels_up,
                  device)


def save_npz(vocab: Vocabulary, path: str):
    """The reference's npz layout (descriptor words as uint32)."""
    np.savez_compressed(
        path, node_desc=vocab.node_desc.cpu().numpy().view(np.uint32),
        word_weight=vocab.word_weight.cpu().numpy(), k=vocab.k,
        levels=vocab.levels, levels_up=vocab.levels_up)


def load_npz(path: str, *, device) -> Vocabulary:
    d = np.load(path)
    return _vocab(d["node_desc"], d["word_weight"], int(d["k"]),
                  int(d["levels"]), int(d["levels_up"]), device)
