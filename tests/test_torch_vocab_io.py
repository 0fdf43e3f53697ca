"""Vocabulary files on the port against the reference (Slice 7a).

The tree is the generator of ``tests/test_orbvoc_scale.py`` at a small
depth (k = 10, L = 3: 1,110 nodes, a complete tree in breadth-first
order), written in DBoW2's binary format by both packages' writers and in
the text format by this test; and a ragged variant (every tenth level-2
node without children) that takes the general re-layout path.

- ``load_orbvoc_binary`` and ``load_orbvoc`` (binary and text) give the
  reference's tree exactly: node descriptors bit for bit, word weights
  equal in float32, k, levels and levels_up equal; the port's binary
  writer writes the same bytes as the reference's native writer; loading
  a text file writes the binary file beside it.
- ``save_npz`` / ``load_npz`` round trip exactly, and each side loads the
  other's npz.
- ``transform`` of one frame's descriptors through the loaded tree equals
  the reference's word ids.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu import native
from orb_slam_2_ros_tpu.config import SlamConfig, VocabConfig
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.place import vocabulary as tvoc

import test_orbvoc_scale as scale

torch.set_num_threads(2)

K, L = 10, 3


@pytest.fixture(scope="module")
def tree():
    saved = scale.K_ORB, scale.L_ORB, scale.N_NODES
    scale.K_ORB, scale.L_ORB = K, L
    scale.N_NODES = sum(K ** lvl for lvl in range(1, L + 1))
    try:
        parents, is_leaf, descs, weights, _ = scale._synth_complete_tree(
            np.random.default_rng(0))
    finally:
        scale.K_ORB, scale.L_ORB, scale.N_NODES = saved
    cfg = SlamConfig(vocab=VocabConfig(k=K, levels=L, levels_up=2))
    return dict(cfg=cfg, tcfg=convert.config_from_dict(
        dataclasses.asdict(cfg)), parents=parents,
        is_leaf=is_leaf, descs=descs, weights=weights)


def _write_txt(path, k, lv, parents, is_leaf, descs, weights):
    with open(path, "w") as f:
        f.write(f"{k} {lv} 0 0\n")
        for p, lf, d, w in zip(parents, is_leaf, descs, weights):
            f.write(f"{p} {int(lf)} " + " ".join(str(int(b)) for b in d)
                    + f" {float(w)!r}\n")


def _ragged(t):
    """The tree without the children of every tenth level-2 node."""
    first2, n2 = K, K * K
    drop = {first2 + 1 + i for i in range(0, n2, 10)}    # node ids
    keep = np.array([p not in drop for p in t["parents"]])
    ids = np.flatnonzero(keep) + 1
    new_id = {0: 0, **{int(old): new for new, old in
                       enumerate(ids, start=1)}}
    parents = np.array([new_id[int(p)] for p in t["parents"][keep]],
                       np.int32)
    return parents, t["is_leaf"][keep], t["descs"][keep], t["weights"][keep]


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_same_vocab(tv, jv):
    np.testing.assert_array_equal(_np(tv.node_desc), _np(jv.node_desc))
    np.testing.assert_array_equal(_np(tv.word_weight), _np(jv.word_weight))
    assert (tv.k, tv.levels, tv.levels_up) == (jv.k, jv.levels,
                                               jv.levels_up)


@pytest.mark.parametrize("shape", ["complete", "ragged"])
def test_binary_and_text_loaders_like_the_reference(tree, tmp_path, shape):
    args = ((tree["parents"], tree["is_leaf"], tree["descs"],
             tree["weights"]) if shape == "complete" else _ragged(tree))
    path = str(tmp_path / "voc.bin")
    tvoc.write_orbvoc_bin(path, K, L, *args)
    want = jvoc._relayout(K, L, args[0], args[2], args[3], tree["cfg"])
    _assert_same_vocab(tvoc.load_orbvoc_binary(path, tree["tcfg"],
                                               device="cpu"), want)
    _assert_same_vocab(jvoc.load_orbvoc_binary(path, tree["cfg"]), want)
    _assert_same_vocab(tvoc.load_orbvoc(path, tree["tcfg"], device="cpu"),
                       want)
    if native.load() is not None:
        ref_path = str(tmp_path / "voc_ref.bin")
        assert native.write_orbvoc_bin(ref_path, K, L, *args)
        with open(ref_path, "rb") as a, open(path, "rb") as b:
            assert a.read() == b.read()
    txt = str(tmp_path / "voc_txt.txt")
    _write_txt(txt, K, L, *args)
    _assert_same_vocab(tvoc.load_orbvoc(txt, tree["tcfg"], device="cpu"),
                       want)
    assert os.path.exists(txt[:-4] + ".bin")     # converted once
    if native.load() is not None:     # the reference reads text natively
        _assert_same_vocab(jvoc.load_orbvoc(txt, tree["cfg"],
                                            auto_convert=False), want)
    _assert_same_vocab(tvoc.load_orbvoc_binary(txt[:-4] + ".bin",
                                               tree["tcfg"], device="cpu"),
                       want)


def test_npz_round_trip_both_ways(tree, tmp_path):
    jv = jvoc._relayout(K, L, tree["parents"], tree["descs"],
                        tree["weights"], tree["cfg"])
    tv = convert.vocabulary_from_numpy(jax.device_get(jv._asdict()), "cpu")
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tvoc.save_npz(tv, tp)
    jvoc.save_npz(jv, jp)
    _assert_same_vocab(tvoc.load_npz(tp, device="cpu"), jv)
    _assert_same_vocab(tvoc.load_npz(jp, device="cpu"), jv)
    _assert_same_vocab(tvoc.load_npz(tp, device="cpu"), jvoc.load_npz(tp))
    with np.load(tp) as a, np.load(jp) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


def test_transform_through_a_loaded_tree(tree, tmp_path):
    path = str(tmp_path / "voc.bin")
    tvoc.write_orbvoc_bin(path, K, L, tree["parents"], tree["is_leaf"],
                          tree["descs"], tree["weights"])
    tv = tvoc.load_orbvoc_binary(path, tree["tcfg"], device="cpu")
    jv = jvoc.load_orbvoc_binary(path, tree["cfg"])
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2 ** 32, (640, 8), dtype=np.uint32)
    valid = rng.uniform(size=640) < 0.9
    jw = jax.jit(lambda d, v: jvoc.transform(jv, d, v))(jnp.asarray(desc),
                                                        jnp.asarray(valid))
    tw = tvoc.transform(tv, torch.from_numpy(desc.view(np.int32)),
                        torch.from_numpy(valid))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
