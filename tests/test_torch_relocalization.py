"""Port parity of ``pipeline/relocalization.py`` on the small configuration of
``tests/test_torch_tracking.py`` with a 6^3 vocabulary.

The reference ``System`` (loop closing on) builds a map and its BoW index
over 32 frames of the synthetic orbit; the map, the index (with its
``kf_node`` table), the vocabulary and the query frame cross over through
``convert``, so both relocalizers see identical inputs. Against the
reference's ``Relocalizer.relocalize``:

- fed the reference's own RANSAC draw (``jax.random.split`` of the key into
  the 5 candidates' ``jax.random.choice``, recomputed here): the same
  ``ok``, the same candidate keyframe, ``n_inliers`` within 2, the camera
  centre within 1e-3 m;
- with the port's own ``torch.Generator``: the same outcome, the centre
  within 0.01 m;
- a blind frame fails on both sides;
- the BoW decoy of ``tests/test_slam_system.py``: a planted keyframe that
  wins retrieval with garbage geometry does not sink the attempt on either
  side, and neither picks it.

``System`` with relocalization, against the reference's, after the same 32
frames: the forced loss of ``tests/test_hard_sequences.py`` (a chunk whose
first half is blind and whose second half revisits frames 8 onwards) gives
the same per-frame states, the first visible frame relocalized (lost-lag
<= 1), each frame recorded once, the relocalized poses within 0.08 m of
the ground truth; and a map with too few keyframes is reset on both sides
when relocalization fails.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam_2_ros_tpu.config import VocabConfig
from orb_slam_2_ros_tpu.frontend import frame as jframe
from orb_slam_2_ros_tpu.frontend import matcher as jmatcher
from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.map import state as jmap
from orb_slam_2_ros_tpu.pipeline import relocalization as jreloc
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.place import database as jdb
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.geometry import se3 as tse3
from orb_slam_2_ros_tpu_torch.pipeline import relocalization as treloc
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_torch_tracking import small_cfg

torch.set_num_threads(2)

N_FRAMES = 32
QUERY = 20


@pytest.fixture(scope="module")
def world():
    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    ds = SyntheticRGBD(cfg, n_frames=N_FRAMES, seed=0)
    grays = np.stack([ds[i][0] for i in range(N_FRAMES)])
    depths = np.stack([ds[i][1] for i in range(N_FRAMES)])
    rng = np.random.default_rng(0)
    train = rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32)
    voc = jvoc.train_vocabulary(train, cfg, seed=0)
    js = jslam.System(cfg, ba_window=8, vocab=voc)
    js.track_chunk(grays, depths, list(ds.timestamps))
    js.flush()
    lc = js.loop_closer
    assert int(lc.state.n_ingested) == js.tracker.n_kfs >= 3
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return dict(cfg=cfg, tcfg=tcfg, ds=ds, jvoc=voc, js=js, grays=grays,
                depths=depths,
                tvoc=convert.vocabulary_from_numpy(jax.device_get(
                    voc._asdict()), "cpu"),
                m=js.tracker.map, db=lc.state.db, kf_node=lc.state.kf_node,
                jreloc=jreloc.Relocalizer(cfg, voc),
                jsamples=_samples_program(cfg, voc),
                jbuild=jax.jit(jframe.build_rgbd, static_argnums=2))


def reference_samples(w, m, db, kf_node, frame, key):
    """The (5, 256, 6) draw that the reference's relocalization program
    makes from ``key``: its candidate ladder up to ``pnp.ransac_pnp``'s
    ``jax.random.choice``, one split key per candidate."""
    return torch.from_numpy(np.asarray(
        w["jsamples"](m, db, kf_node, frame, key)))


def _samples_program(cfg, voc):
    @jax.jit
    def draw(m, db, kf_node, frame, key):
        wid, nid, tfidf = jvoc.transform(voc, frame.kps.desc, frame.valid)
        wt = jvoc.bow_weights(wid, tfidf, voc.num_words)
        cand = jdb.detect_candidates(db, wid, wt, jnp.zeros((m.K,), bool),
                                     jmap.covisibility(m), voc.num_words,
                                     min_score=None)
        scores, _ = jdb.query(db, wid, wt, voc.num_words)
        top_scores, top_idx = jax.lax.top_k(jnp.where(cand, scores, -1.0),
                                            treloc.N_CANDIDATES)
        subs = jax.random.split(key, treloc.N_CANDIDATES)
        P = frame.uv.shape[0]
        out = []
        for i in range(treloc.N_CANDIDATES):
            c = top_idx[i]
            valid_c = (m.kf_kp_valid[c] & (m.kf_mp[c] >= 0) & m.kf_valid[c]
                       & (top_scores[i] > 0))
            f_to_c = jmatcher.search_by_node(
                m.kf_desc[c], kf_node[c], valid_c, m.kf_angle[c],
                frame.kps.desc, nid, frame.valid, frame.kps.angle, cfg)[0]
            ok = (f_to_c >= 0) & (m.kf_mp[c][jnp.clip(f_to_c, 0)] >= 0)
            pw = ok.astype(jnp.float32)
            pw = pw / jnp.maximum(jnp.sum(pw), 1e-9)
            out.append(jax.random.choice(subs[i], P, shape=(256, 6),
                                         replace=True, p=pw))
        return jnp.stack(out)
    return draw


def both(w, m, db, kf_node, frame, key, own_draw=False):
    """(reference result, port result) as numpy / python values."""
    jout = w["jreloc"].relocalize(m, db, kf_node, frame, key)
    tm = convert.map_state_from_numpy(jax.device_get(m._asdict()), "cpu")
    tdb = convert.bow_database_from_numpy(jax.device_get(db._asdict()), "cpu")
    tnode = torch.from_numpy(np.array(kf_node))
    tframe = convert.frame_from_numpy(jax.device_get(frame._asdict()), "cpu")
    reloc = treloc.Relocalizer(w["tcfg"], w["tvoc"])
    if own_draw:
        tout = reloc.relocalize(tm, tdb, tnode, tframe,
                                generator=torch.Generator().manual_seed(1))
    else:
        tout = reloc.relocalize(tm, tdb, tnode, tframe, sample_idx=
                                reference_samples(w, m, db, kf_node, frame,
                                                  key))
    return jout, tout


def centre(q, t):
    return tse3.camera_center(torch.as_tensor(np.asarray(q)),
                              torch.as_tensor(np.asarray(t))).numpy()


def query_frame(w, i):
    g, d = w["ds"][i]
    return w["jbuild"](jnp.asarray(g, jnp.float32),
                       jnp.asarray(d, jnp.float32), w["cfg"])


def gt_centre(w, i):
    R0, c0 = w["ds"].gt_pose_wc(0)
    return R0.T @ (w["ds"].gt_pose_wc(i)[1] - c0)


@pytest.mark.parametrize("query,own_draw", [(QUERY, False), (QUERY, True),
                                            (12, False)])
def test_relocalize_matches_reference(world, query, own_draw):
    w = world
    frame = query_frame(w, query)
    (jok, jq, jt, jkp, jn, jc), (tok, tq, tt, tkp, tn, tc) = both(
        w, w["m"], w["db"], w["kf_node"], frame, jax.random.PRNGKey(query),
        own_draw)
    assert bool(tok) == bool(jok) is True
    assert int(tc) == int(jc)
    assert tok.dtype == torch.bool and tkp.shape == (w["cfg"].orb.max_kps,)
    tol = 1e-2 if own_draw else 1e-3
    np.testing.assert_allclose(centre(tq, tt), centre(jq, jt), atol=tol)
    np.testing.assert_allclose(centre(tq, tt), gt_centre(w, query), atol=0.08)
    if not own_draw:
        assert abs(int(tn) - int(jn)) <= 2
        agree = (tkp.numpy() == np.asarray(jkp)).mean()
        assert agree > 0.98, agree


def test_blind_frame_fails_on_both_sides(world):
    w = world
    cfg = w["cfg"]
    zeros = jnp.zeros((cfg.camera.height, cfg.camera.width), jnp.float32)
    frame = w["jbuild"](zeros, zeros, cfg)
    (jok, *_), (tok, _, _, tkp, tn, _) = both(
        w, w["m"], w["db"], w["kf_node"], frame, jax.random.PRNGKey(0))
    assert not bool(jok) and not bool(tok)
    assert int(tn) == 0 and bool((tkp < 0).all())


def test_relocalization_survives_bow_decoy(world):
    """``tests/test_slam_system.py::test_relocalization_survives_bow_decoy``
    on both sides: the decoy (the newest keyframe's descriptors with 10% of
    the query's mixed in, its landmarks dead rows) wins retrieval, yet both
    relocalize through a geometrically consistent candidate."""
    w = world
    m, cfg, voc = w["m"], w["cfg"], w["jvoc"]
    frame = query_frame(w, QUERY)
    n = int(np.asarray(m.n_kfs))
    rng = np.random.default_rng(5)
    dead_ids = np.flatnonzero(~np.asarray(m.mp_valid))
    fake_mp = rng.choice(dead_ids, size=m.P).astype(np.int32)
    fake_mp = np.where(np.asarray(frame.valid), fake_mp, -1)
    decoy_desc = np.asarray(m.kf_desc[n - 1]).copy()
    mix = rng.random(m.P) < 0.1
    decoy_desc[mix] = np.asarray(frame.kps.desc)[mix]
    m2 = m._replace(
        kf_desc=m.kf_desc.at[n].set(jnp.asarray(decoy_desc)),
        kf_uv=m.kf_uv.at[n].set(frame.uv),
        kf_angle=m.kf_angle.at[n].set(frame.kps.angle),
        kf_octave=m.kf_octave.at[n].set(frame.kps.octave),
        kf_kp_valid=m.kf_kp_valid.at[n].set(frame.valid),
        kf_valid=m.kf_valid.at[n].set(True),
        kf_mp=m.kf_mp.at[n].set(jnp.asarray(fake_mp)),
        n_kfs=jnp.int32(n + 1))
    db = jdb.empty(cfg)
    kf_node = jnp.full((m.K, m.P), -1, jnp.int32)
    for row in range(n + 1):
        wid, nid, tfidf = jvoc.transform(
            voc, m2.kf_desc[row], m2.kf_kp_valid[row] & m2.kf_valid[row])
        db = jdb.add(db, row, wid, jvoc.bow_weights(wid, tfidf,
                                                    voc.num_words))
        kf_node = kf_node.at[row].set(nid)
    wid, _, tfidf = jvoc.transform(voc, frame.kps.desc, frame.valid)
    scores, _ = jdb.query(db, wid, jvoc.bow_weights(wid, tfidf,
                                                    voc.num_words),
                          voc.num_words)
    assert int(np.argmax(np.asarray(scores)[:n + 1])) == n

    (jok, jq, jt, _, jn, jc), (tok, tq, tt, _, tn, tc) = both(
        w, m2, db, kf_node, frame, jax.random.PRNGKey(0))
    assert bool(jok) and bool(tok)
    assert int(tc) == int(jc) != n
    assert abs(int(tn) - int(jn)) <= 2
    np.testing.assert_allclose(centre(tq, tt), centre(jq, jt), atol=1e-3)
    np.testing.assert_allclose(centre(tq, tt), gt_centre(w, QUERY), atol=0.08)


def port_system(w, n):
    """The port's System (loop closing on) over the first n frames, then
    ``flush``, as the fixture's reference System ran."""
    system = tslam.System(w["tcfg"], ba_window=8, vocab=w["tvoc"],
                          device="cpu")
    system.track_chunk(w["grays"][:n], w["depths"][:n],
                       list(w["ds"].timestamps[:n]))
    system.flush()
    return system


def test_system_forced_loss_matches_reference(world):
    w = world
    js = w["js"]
    ts = port_system(w, N_FRAMES)
    assert ts.tracker.n_kfs == js.tracker.n_kfs
    grays, depths = w["grays"], w["depths"]
    C = ts.tracker.CHUNK
    h = C // 2
    g2 = np.concatenate([np.zeros_like(grays[:h]), grays[8:8 + C - h]])
    d2 = np.concatenate([np.zeros_like(depths[:h]), depths[8:8 + C - h]])
    ts2 = [w["ds"].timestamps[-1] + (i + 1) / 30.0 for i in range(C)]
    jrecs = js.track_chunk(g2, d2, ts2)
    trecs = ts.track_chunk(g2, d2, ts2)
    states = [r.state for r in trecs]
    assert states == [r.state for r in jrecs]
    assert states == [ttrack.LOST] * h + [ttrack.OK] * (C - h), states
    assert ts.n_reloc_attempts == h + 1 and ts.n_relocalized == 1
    assert ts.n_resets == js.n_resets == 0
    assert len(ts.records) == len(js.records) == N_FRAMES + C
    assert [r.frame_id for r in ts.records] == list(range(N_FRAMES + C))
    assert [r.timestamp for r in ts.records[N_FRAMES:]] == ts2
    for i, r in enumerate(trecs[h:]):
        assert np.linalg.norm(r.c_w - gt_centre(w, 8 + i)) < 0.08, i
    # the replay tracked the visible frames once more from the forced pose
    assert int(ts.tracker.carry.since_reloc) == C - h


def test_system_resets_a_barely_started_map(world):
    w = world
    cfg = w["cfg"]
    n = 16
    js = jslam.System(cfg, ba_window=8, vocab=w["jvoc"])
    js.track_chunk(w["grays"][:n], w["depths"][:n],
                   list(w["ds"].timestamps[:n]))
    ts = port_system(w, n)
    js.flush()
    assert ts.tracker.n_kfs == js.tracker.n_kfs <= cfg.tracking.min_num_kf_in_map
    blind = np.zeros_like(w["grays"][:2])
    ts2 = [w["ds"].timestamps[n - 1] + (i + 1) / 30.0 for i in range(2)]
    jrecs = js.track_chunk(blind, blind, ts2)
    trecs = ts.track_chunk(blind, blind, ts2)
    assert [r.state for r in trecs] == [r.state for r in jrecs] \
        == [ttrack.LOST] * 2
    assert ts.n_resets == js.n_resets == 1
    assert ts.n_reloc_attempts == 2 and ts.n_relocalized == 0
    assert ts.tracker.n_kfs == 0 and ts.loop_closer._n_ingested == 0
    # the next frame initializes a fresh map
    recs = ts.track_chunk(w["grays"][n:n + 1], w["depths"][n:n + 1],
                          [ts2[-1] + 1 / 30.0])
    assert recs[0].state == ttrack.OK and ts.tracker.n_kfs == 1
