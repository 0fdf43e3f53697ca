"""Port parity of ``place/vocabulary`` and ``place/database``.

``train_vocabulary`` is bit-equal to the reference's (nodes and weights);
``transform`` is exact in ``word_id`` and ``node_id``, also on node
descriptors and words whose top bit is set; ``bow_weights``, ``l1_score`` and
the database's scores agree within 1e-6; ``common`` and the candidate mask
are exact, on a covisibility matrix built to have tied counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import (MapConfig, OrbConfig, SlamConfig as
                                       JSlamConfig, VocabConfig)
from orb_slam_2_ros_tpu.place import database as jdb
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.ops import ties
from orb_slam_2_ros_tpu_torch.place import database as tdb
from orb_slam_2_ros_tpu_torch.place import vocabulary as tvoc

import dataclasses

# Several test processes share the machine's cores; PyTorch's default of
# one thread per core in each of them makes the many small operations of
# these tests spin against each other (a 16 s fixture took 540 s in a run
# with six workers). Two threads per process keep them out of each other's way.
torch.set_num_threads(2)

K, P = 16, 96


def _cfgs(k=6, levels=3):
    jcfg = JSlamConfig(orb=OrbConfig(n_features=P, max_kps=P),
                       map=MapConfig(max_kfs=K, max_mps=256, max_kps=P),
                       vocab=VocabConfig(k=k, levels=levels))
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _descs(rng, n, top_bit=False):
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    if top_bit:
        d |= np.uint32(0x80000000)
    return d


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def vocs():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    # clustered training data, so that the tree's words are not all alike
    centres = _descs(rng, 40)
    train = centres[rng.integers(0, 40, 3000)] ^ (
        (rng.uniform(size=(3000, 8, 32)) < 0.04)
        @ (1 << np.arange(32, dtype=np.uint64))).astype(np.uint32)
    jv = jvoc.train_vocabulary(train, jcfg, seed=3)
    tv = tvoc.train_vocabulary(train, tcfg, seed=3, device="cpu")
    return jcfg, tcfg, jv, tv, train


def test_train_vocabulary_bit_equal(vocs):
    _, _, jv, tv, train = vocs
    np.testing.assert_array_equal(
        tv.node_desc.numpy().view(np.uint32), np.asarray(jv.node_desc))
    np.testing.assert_array_equal(tv.word_weight.numpy(),
                                  np.asarray(jv.word_weight))
    assert (tv.k, tv.levels, tv.levels_up) == (jv.k, jv.levels, jv.levels_up)
    assert tv.num_words == jv.num_words == 216
    assert tv.level_offsets == jv.level_offsets
    assert (np.asarray(jv.node_desc) >> 31).any()    # top bits are in play
    # int32 words with the same bits train the same tree
    tv2 = tvoc.train_vocabulary(train.view(np.int32), vocs[1], seed=3,
                                device="cpu")
    assert torch.equal(tv2.node_desc, tv.node_desc)
    # the conversion carries the reference's tree over unchanged
    tv3 = convert.vocabulary_from_numpy(
        dict(node_desc=np.asarray(jv.node_desc),
             word_weight=np.asarray(jv.word_weight), k=jv.k,
             levels=jv.levels, levels_up=jv.levels_up), "cpu")
    assert torch.equal(tv3.node_desc, tv.node_desc)
    back = convert.to_numpy(tv3)
    assert back["node_desc"].dtype == np.uint32 and back["k"] == jv.k


@pytest.mark.parametrize("top_bit", [False, True])
def test_transform_exact(vocs, top_bit):
    _, _, jv, tv, train = vocs
    rng = np.random.default_rng(1)
    desc = np.concatenate([train[rng.integers(0, len(train), P // 2)],
                           _descs(rng, P // 2, top_bit)])
    if top_bit:
        desc |= np.uint32(0x80000000)
    valid = rng.uniform(size=P) > 0.2
    jw, jn, jtf = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
    tw, tn, ttf = tvoc.transform(tv, _t(desc), _t(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ttf.numpy(), np.asarray(jtf))
    assert tw.dtype == tn.dtype == torch.int32


def test_transform_ties_go_to_the_lowest_child():
    """A tree whose children are all the same descriptor: every level is a
    tie, and both sides must walk down child 0."""
    jcfg, tcfg = _cfgs(k=4, levels=2)
    nodes = np.tile(np.array([[0x80000001] * 8], np.uint32), (4 + 16, 1))
    weights = np.arange(16, dtype=np.float32)
    jv = jvoc.Vocabulary(jnp.asarray(nodes), jnp.asarray(weights), 4, 2, 1)
    tv = tvoc.Vocabulary(_t(nodes), _t(weights), 4, 2, 1)
    desc = _descs(np.random.default_rng(2), 8, top_bit=True)
    valid = np.ones(8, bool)
    jw, jn, _ = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
    tw, tn, _ = tvoc.transform(tv, _t(desc), _t(valid))
    assert (tw.numpy() == 0).all() and (np.asarray(jw) == 0).all()
    assert (tn.numpy() == np.asarray(jn)).all()


def _bows(vocs, rng, n_rows, dup=True):
    """BoW rows of both sides for n_rows random descriptor sets (drawn from
    few clusters, so that words repeat within and across rows)."""
    _, _, jv, tv, train = vocs
    rows = []
    for _ in range(n_rows):
        desc = train[rng.integers(0, 400 if dup else len(train), P)]
        valid = rng.uniform(size=P) > 0.15
        jw, _, jtf = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
        tw, _, ttf = tvoc.transform(tv, _t(desc), _t(valid))
        rows.append((jw, jvoc.bow_weights(jw, jtf, jv.num_words),
                     tw, tvoc.bow_weights(tw, ttf, tv.num_words)))
    return rows


def test_bow_weights_and_l1_score(vocs):
    rng = np.random.default_rng(3)
    rows = _bows(vocs, rng, 4)
    nw = vocs[2].num_words
    for jw, jwt, tw, twt in rows:
        np.testing.assert_allclose(twt.numpy(), np.asarray(jwt), atol=1e-6)
        assert abs(float(twt.sum()) - 1.0) < 1e-5
        # one non-zero slot per distinct word, on its first keypoint
        nz = twt.numpy() > 0
        assert len(set(tw.numpy()[nz])) == nz.sum() < (tw.numpy() >= 0).sum()
    (jw0, jwt0, tw0, twt0), (jw1, jwt1, tw1, twt1) = rows[:2]
    js = jvoc.l1_score(jw0, jwt0, jw1, jwt1, nw)
    ts = tvoc.l1_score(tw0, twt0, tw1, twt1, nw)
    assert abs(float(ts) - float(js)) < 1e-6 and float(ts) > 0
    assert abs(float(tvoc.l1_score(tw0, twt0, tw0, twt0, nw)) - 1.0) < 1e-5
    # no valid word: all-zero weights
    none = torch.full((P,), -1, dtype=torch.int32)
    assert float(tvoc.bow_weights(none, torch.zeros(P), nw).abs().sum()) == 0


def _tied_covis(rng):
    """A covisibility matrix with few distinct values (many ties) and
    zeros, symmetric with an empty diagonal."""
    c = rng.integers(0, 4, (K, K)) * 10
    c = np.triu(c, 1)
    return (c + c.T).astype(np.int32)


def test_database_add_query_detect(vocs):
    jcfg, tcfg, jv, tv, _ = vocs
    rng = np.random.default_rng(4)
    rows = _bows(vocs, rng, K - 2)
    nw = jv.num_words
    jd, td = jdb.empty(jcfg), tdb.empty(tcfg, "cpu")
    for i, (jw, jwt, tw, twt) in enumerate(rows):
        jd = jdb.add(jd, i, jw, jwt)
        td = tdb.add(td, i, tw, twt)
    jd, td = jdb.erase(jd, 3), tdb.erase(td, 3)
    np.testing.assert_array_equal(td.kf_word.numpy(), np.asarray(jd.kf_word))
    np.testing.assert_array_equal(td.kf_valid.numpy(), np.asarray(jd.kf_valid))
    np.testing.assert_allclose(td.kf_wt.numpy(), np.asarray(jd.kf_wt),
                               atol=1e-6)
    covis = _tied_covis(rng)
    n_cand = 0
    for qi in (0, 5, K - 3):
        jw, jwt, tw, twt = rows[qi]
        jsc, jcm = jdb.query(jd, jw, jwt, nw)
        tsc, tcm = tdb.query(td, tw, twt, nw)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-6)
        np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
        assert tcm.dtype == torch.int32 and int(tcm[qi]) > 0
        exclude = np.zeros(K, bool)
        exclude[qi] = True
        exclude[(qi + 1) % K] = True
        for min_score in (None, float(np.median(np.asarray(jsc)))):
            jc = jdb.detect_candidates(jd, jw, jwt, jnp.asarray(exclude),
                                       jnp.asarray(covis), nw,
                                       min_score=min_score)
            tc = tdb.detect_candidates(td, tw, twt, _t(exclude), _t(covis),
                                       nw, min_score=min_score)
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            tc2 = tdb.detect_candidates(td, tw, twt, _t(exclude), _t(covis),
                                        nw, min_score=min_score,
                                        queried=(tsc, tcm))
            assert torch.equal(tc2, tc)
            n_cand += int(tc.sum())
            assert not bool(tc[qi]) and not bool(tc[3])
    assert n_cand > 0


def test_tie_rules():
    x = torch.tensor([[3, 7, 7, 1, 7], [0, 0, 0, 0, 0]])
    vals, idx = ties.top_k_stable(x, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == [[7, 7, 7], [0, 0, 0]]
    assert ties.first_argmax(x.float(), dim=1).tolist() == [1, 0]
    assert ties.first_argmax(torch.tensor([-1.0, -1.0])).item() == 0
    out = tdb.scatter_any(4, torch.tensor([1, 1, 2]),
                          torch.tensor([True, False, False]))
    assert out.tolist() == [False, True, False, False]
