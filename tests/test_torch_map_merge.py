"""Port parity of ``pipeline/map_merge.py`` (Slice 7a): the three cases of
``tests/test_map_merge.py`` on the synthetic ring of
``tests/test_loop_closing.py`` (16 keyframes, a 6^3 vocabulary trained on
the ring's descriptors).

The maps cross over through ``convert``. Where the Sim3 RANSAC runs, the
port is fed the reference's own draw (trap 8): ``jax.random.choice`` with
the key the reference's ``merge_maps`` uses (``PRNGKey(cfg.seed + 7)``)
over the matched pairs of the chosen keyframes, recomputed here.

- Two sessions over overlapping halves of the ring, the second in its own
  world frame. On the reference's keyframe pair with its draw: the Sim3
  within 1e-4 (rotation, scale) and 1e-3 m, the inlier counts within 2,
  the merged keyframe validity, counts and observation table equal, the
  merged poses within 1e-3 rad and 1e-3 m of the reference's. The port's
  own merge (its place recognition and draw) aligns too, on a pair of one
  overlap keyframe with itself (those pairs tie at a score of 1.0 up to
  the last bits, so either side may take any of them). Both merged maps
  put the appended keyframes within 0.02 m of the ground truth, every
  observation naming a valid point.
- Unrelated scenes: both sides reject.
- ``System.merge_map`` from a session file the port saved (its own draw):
  the merged map holds 10 + 10 keyframes, as the reference's does from the
  same file.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu.pipeline import map_merge as jmerge
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import map_merge as tmerge
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam

from test_loop_closing import N_KF, build_looped_map, pose_err_deg_m
from test_map_merge import _crop, merge_cfg

torch.set_num_threads(2)


def _t(m):
    return convert.map_state_from_numpy(jax.device_get(m._asdict()), "cpu")


@pytest.fixture(scope="module")
def ring():
    cfg = merge_cfg()
    m_full, gt, descs = build_looped_map(cfg, drift_xi=(0, 0, 0, 0, 0, 0))
    voc = jvoc.train_vocabulary(descs, cfg, seed=0)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tvoc = convert.vocabulary_from_numpy(jax.device_get(voc._asdict()), "cpu")
    return dict(cfg=cfg, tcfg=tcfg, m_full=m_full, gt=gt, descs=descs,
                voc=voc, tvoc=tvoc)


def _sessions(ring, q_d=(0.1, -0.3, 0.05), t_d=(1.5, -0.7, 2.0)):
    m1 = _crop(ring["m_full"], range(0, 10))
    m2 = _crop(ring["m_full"], range(6, N_KF))
    m2 = jmerge.transform_map(m2, jse3.quat_exp(jnp.asarray(q_d)),
                              jnp.asarray(t_d), jnp.asarray(1.0))
    return m1, m2


def _reference_draw(tm1, tm2, pair, tcfg, seed):
    """The (256, 3) draw of the reference's ``ransac_sim3`` for the pair."""
    pair_ok = tmerge.match_pair(tm1, tm2, *pair, tcfg)[0].numpy()
    pw = jnp.asarray(pair_ok).astype(jnp.float32)
    pw = pw / jnp.maximum(jnp.sum(pw), 1e-9)
    idx = jax.random.choice(jax.random.PRNGKey(seed + 7), pw.shape[0],
                            shape=(256, 3), replace=True, p=pw)
    return torch.from_numpy(np.asarray(idx))


def _merge_both(ring, m1, m2):
    """The reference's merge, and the port's on the reference's keyframe
    pair with the reference's draw."""
    cfg, tcfg = ring["cfg"], ring["tcfg"]
    jmerged, jinfo = jmerge.merge_maps(m1, m2, ring["voc"], cfg)
    tm1, tm2 = _t(m1), _t(m2)
    c1, k2 = jinfo["pair"]
    if c1 < 0:
        return jmerged, jinfo, None, None
    ok, q, t, s, n_inl = tmerge.solve_pair(
        tm1, tm2, c1, k2, tcfg,
        sample_idx=_reference_draw(tm1, tm2, (c1, k2), tcfg, cfg.seed))
    tmerged = tmerge.append_map(tm1, tm2, q, t, s, tcfg) if ok else None
    return jmerged, jinfo, tmerged, dict(aligned=ok, inliers=n_inl,
                                         sim3=(q, t, s))


def _assert_on_ground_truth(ring, got, n1):
    kf_valid = got["kf_valid"]
    assert int(kf_valid.sum()) == 10 + (N_KF - 6)
    for i in range(6, N_KF):
        if kf_valid[n1 + i]:
            _, trn = pose_err_deg_m(jnp.asarray(got["kf_q"][n1 + i]),
                                    jnp.asarray(got["kf_t"][n1 + i]),
                                    *ring["gt"][i])
            assert trn < 0.02, (i, trn)
    obs = got["kf_mp"][kf_valid]
    assert got["mp_valid"][obs[obs >= 0]].all()


def test_two_sessions_merge_like_the_reference(ring):
    m1, m2 = _sessions(ring)
    jmerged, jinfo, tmerged, tinfo = _merge_both(ring, m1, m2)
    assert jinfo["aligned"] and tinfo["aligned"], (jinfo, tinfo)
    assert abs(tinfo["inliers"] - jinfo["inliers"]) <= 2
    jq, jt, js = jinfo["sim3"]
    tq, tt, ts = (x.numpy().reshape(-1) for x in tinfo["sim3"])
    np.testing.assert_allclose(tq * np.sign(tq[0] * jq[0]), jq, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=1e-3)
    np.testing.assert_allclose(ts, js, atol=1e-4)
    got = convert.to_numpy(tmerged)
    want = jax.device_get(jmerged._asdict())
    for f in ("kf_valid", "kf_mp", "mp_valid", "mp_obs_tbl", "mp_first_kf",
              "n_kfs", "n_mps", "kf_frame_id"):
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
    for r in np.flatnonzero(got["kf_valid"]):
        rot, trn = pose_err_deg_m(jnp.asarray(got["kf_q"][r]),
                                  jnp.asarray(got["kf_t"][r]),
                                  want["kf_q"][r], want["kf_t"][r])
        assert rot < 1e-3 and trn < 1e-3, (r, rot, trn)
    n1 = int(np.asarray(m1.n_kfs))
    _assert_on_ground_truth(ring, got, n1)

    # the port's own merge: its place recognition and its own draw. The
    # overlap's keyframes are the same images in both sessions, so several
    # pairs score 1.0 up to the last bits and either side may take any of
    # them: a pair of one keyframe with itself in the overlap
    own, info = tmerge.merge_maps(_t(m1), _t(m2), ring["tvoc"],
                                  ring["tcfg"])
    c1, k2 = info["pair"]
    assert info["aligned"] and c1 == k2 and 6 <= c1 < 10, info
    _assert_on_ground_truth(ring, convert.to_numpy(own), n1)


def test_unrelated_sessions_are_rejected_on_both_sides(ring):
    cfg = ring["cfg"]
    m1, _, descs1 = build_looped_map(cfg, drift_xi=(0, 0, 0, 0, 0, 0),
                                     seed=5)
    m2, _, _ = build_looped_map(cfg, drift_xi=(0, 0, 0, 0, 0, 0), seed=11)
    voc = jvoc.train_vocabulary(descs1, cfg, seed=0)
    ring = dict(ring, voc=voc, tvoc=convert.vocabulary_from_numpy(
        jax.device_get(voc._asdict()), "cpu"))
    jmerged, jinfo, tmerged, tinfo = _merge_both(ring, m1, m2)
    assert jmerged is None and tmerged is None
    assert not jinfo["aligned"] and not tinfo["aligned"]


def test_system_merge_map_from_a_port_session(ring, tmp_path):
    m1, m2 = _sessions(ring, q_d=(0.0, 0.2, 0.0), t_d=(0.5, 0.0, -1.0))
    off = dict(enable_local_ba=False, enable_loop_closing=False)
    s2 = tslam.System(ring["tcfg"], vocab=ring["tvoc"], device="cpu", **off)
    s2.tracker.attach_map(_t(m2))
    path = str(tmp_path / "session2.npz")
    assert s2.save_map(path)
    s1 = tslam.System(ring["tcfg"], vocab=ring["tvoc"], device="cpu", **off)
    s1.tracker.attach_map(_t(m1))
    assert s1.merge_map(path)
    assert int(s1.tracker.map.kf_valid.sum()) == 10 + (N_KF - 6)
    assert s1.n_merges == 1 and s1.last_big_change_idx == 1
    j1 = jslam.System(ring["cfg"], vocab=ring["voc"], **off)
    j1.tracker.attach_map(m1)
    assert j1.merge_map(path)
    assert int(np.asarray(j1.tracker.map.kf_valid).sum()) == 10 + (N_KF - 6)
