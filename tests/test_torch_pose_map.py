"""Port parity: pose_optimization and the map-state updates of the tracking
step (commit_keyframe, bump_visibility) against the JAX reference.

Pose: translation within 1e-4 m and rotation within 1e-4 rad (the LM
solves its 6x6 systems in float64 here and with an unrolled float32
Cholesky in the reference); inlier masks may differ only on edges whose
chi2 lies within 1e-3 (relative) of the gate. Map updates: integer fields
exactly, float fields within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                       SlamConfig)
from orb_slam_2_ros_tpu.frontend.extractor import Keypoints as JKeypoints
from orb_slam_2_ros_tpu.frontend.frame import Frame as JFrame
from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu.map import state as jstate
from orb_slam_2_ros_tpu.solvers.pose_opt import pose_optimization as j_pose_opt
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints as TKeypoints
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame as TFrame
from orb_slam_2_ros_tpu_torch.map import state as tstate
from orb_slam_2_ros_tpu_torch.ops.linalg import solve_spd
from orb_slam_2_ros_tpu_torch.solvers.pose_opt import pose_optimization as t_pose_opt


def _pose_case(seed, n=300):
    cfg = SlamConfig()
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    q = np.asarray(jse3.quat_exp(jnp.asarray(rng.normal(0, 0.1, 3),
                                             jnp.float32)))
    t = rng.normal(0, 0.2, 3).astype(np.float32)
    xc = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                         rng.uniform(1.0, 6.0, (n, 1))], -1)
    qi, ti = (np.asarray(v) for v in jse3.inverse(jnp.asarray(q),
                                                  jnp.asarray(t)))
    pts = np.asarray(jse3.apply(jnp.asarray(qi), jnp.asarray(ti),
                                jnp.asarray(xc, jnp.float32)))
    u = cam.fx * xc[:, 0] / xc[:, 2] + cam.cx
    v = cam.fy * xc[:, 1] / xc[:, 2] + cam.cy
    octave = rng.integers(0, 4, n).astype(np.int32)
    noise = rng.normal(0, 0.7, (n, 3)) * 1.2 ** octave[:, None]
    obs_uv = np.stack([u, v], -1) + noise[:, :2]
    obs_ur = np.where(rng.uniform(size=n) < 0.6,
                      u - cam.bf / xc[:, 2] + noise[:, 2], -1.0)
    out = rng.uniform(size=n) < 0.1                  # gross outliers
    obs_uv[out] += rng.uniform(15, 40, (out.sum(), 2))
    valid = rng.uniform(size=n) < 0.95
    dq = np.asarray(jse3.quat_exp(jnp.asarray([0.02, -0.015, 0.01])))
    q0 = np.asarray(jse3.quat_mul(jnp.asarray(dq), jnp.asarray(q)))
    t0 = (t + np.array([0.04, -0.03, 0.05])).astype(np.float32)
    f32 = np.float32
    return cfg, [q0.astype(f32), t0, pts.astype(f32), obs_uv.astype(f32),
                 obs_ur.astype(f32), octave, valid]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization(seed):
    cfg, args = _pose_case(seed)
    jq, jt, jin, jn = jax.jit(lambda *a: j_pose_opt(*a, cfg))(
        *(jnp.asarray(a) for a in args))
    tq, tt, tin, tn = t_pose_opt(*(torch.from_numpy(a) for a in args), cfg)
    jq, jt, jin = np.asarray(jq), np.asarray(jt), np.asarray(jin)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-4)
    dq = np.asarray(jse3.quat_mul(jnp.asarray(tq.numpy()),
                                  jse3.quat_conj(jnp.asarray(jq))))
    assert 2 * np.arcsin(min(1.0, np.linalg.norm(dq[1:]))) < 1e-4
    # inlier masks: differences only at the chi2 gate
    diff = np.nonzero(jin != tin.numpy())[0]
    if diff.size:
        _, _, pts, obs_uv, obs_ur, octave, _ = args
        cam = cfg.camera
        xc = np.asarray(jse3.apply(jnp.asarray(jq), jnp.asarray(jt),
                                   jnp.asarray(pts[diff])))
        u = cam.fx * xc[:, 0] / xc[:, 2] + cam.cx
        v = cam.fy * xc[:, 1] / xc[:, 2] + cam.cy
        e2 = (u - obs_uv[diff, 0]) ** 2 + (v - obs_uv[diff, 1]) ** 2
        st = obs_ur[diff] > 0
        e2 = e2 + np.where(st, (u - cam.bf / xc[:, 2] - obs_ur[diff]) ** 2, 0)
        chi2 = e2 * 1.2 ** (-2.0 * octave[diff])
        gate = np.where(st, cfg.solver.huber_stereo2, cfg.solver.huber_mono2)
        np.testing.assert_array_less(np.abs(chi2 / gate - 1.0), 1e-3)
    assert abs(int(tn) - int(jn)) == diff.size
    assert int(tn) > 200


def test_solve_spd_batched_and_not_pd():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 6, 6))
    H = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    x = solve_spd(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(np.einsum("nij,nj->ni", H, x), b, atol=1e-3)
    bad = -np.eye(6, dtype=np.float32)
    assert np.isnan(solve_spd(torch.from_numpy(bad),
                              torch.from_numpy(b[0])).numpy()).all()


# ------------------------------------------------------------ map updates

P = 128
CFG = SlamConfig(camera=CameraConfig(width=320, height=240, fx=260.0,
                                     fy=260.0, cx=159.5, cy=119.5, bf=20.0,
                                     th_depth=50.0),
                 orb=OrbConfig(n_features=P, max_kps=P),
                 map=MapConfig(max_kfs=4, max_mps=512, max_kps=P))


def _frame(rng):
    xy = rng.uniform([0, 0], [320, 240], (P, 2)).astype(np.float32)
    depth = np.where(rng.uniform(size=P) < 0.2, -1.0,
                     rng.uniform(0.5, 12, P)).astype(np.float32)
    f = dict(xy=xy, response=np.zeros(P, np.float32),
             angle=rng.uniform(-3, 3, P).astype(np.float32),
             octave=rng.integers(0, 8, P).astype(np.int32),
             desc=rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32),
             valid=rng.uniform(size=P) < 0.9)
    ur = np.where(depth > 0, xy[:, 0] - 20.0 / np.maximum(depth, 1e-9), -1.0)
    jf = JFrame(kps=JKeypoints(**{k: jnp.asarray(v) for k, v in f.items()}),
                uv=jnp.asarray(xy), u_right=jnp.asarray(ur, jnp.float32),
                depth=jnp.asarray(depth))
    tk = {k: torch.from_numpy(v.view(np.int32) if k == "desc" else v)
          for k, v in f.items()}
    tf = TFrame(kps=TKeypoints(**tk), uv=torch.from_numpy(xy),
                u_right=torch.from_numpy(ur.astype(np.float32)),
                depth=torch.from_numpy(depth))
    return jf, tf


def _assert_state_equal(jm, tm):
    jd = jax.device_get(jm._asdict())
    td = convert.to_numpy(tm)
    for name in jstate.MapState._fields:
        a, b = np.asarray(jd[name]), td[name]
        assert a.dtype == b.dtype, name
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_commit_keyframe_and_bump_visibility():
    rng = np.random.default_rng(4)
    jm = jstate.empty(CFG)
    tm = convert.map_state_from_numpy(jax.device_get(jm._asdict()))
    q = np.asarray(jse3.quat_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t = np.array([0.1, -0.2, 0.3], np.float32)
    commit_j = jax.jit(lambda m, f, q, t, fid, kp, need, far:
                       jstate.commit_keyframe(m, f, q, t, fid, kp, need, CFG,
                                              close_only=True, max_spawn=P,
                                              allow_far=far))
    none = np.full(P, -1, np.int32)
    # 1: initialization-style commit, spawns every valid depth
    # 2: a keyframe that re-observes spawned points, one of them from two
    #    keypoints in the same frame (the duplicate scatter of trap 5)
    # 3: not needed -- a data-flow no-op apart from the uncommitted row
    for step, (need, far) in enumerate([(True, True), (True, False),
                                        (False, False)]):
        jf, tf = _frame(rng)
        kp_to_mp = none.copy()
        if step > 0:
            n_mps = int(jm.n_mps)
            kp_to_mp[:40] = rng.integers(0, n_mps, 40)
            kp_to_mp[40] = kp_to_mp[41] = kp_to_mp[0]
            kp_to_mp[42:45] = kp_to_mp[1]
        jm, jrow = commit_j(jm, jf, jnp.asarray(q), jnp.asarray(t),
                            jnp.int32(step), jnp.asarray(kp_to_mp),
                            jnp.asarray(need), jnp.asarray(far))
        tm, trow = tstate.commit_keyframe(
            tm, tf, torch.from_numpy(q), torch.from_numpy(t),
            torch.tensor(step, dtype=torch.int32), torch.from_numpy(kp_to_mp),
            torch.tensor(need), torch.tensor(far), CFG)
        np.testing.assert_array_equal(np.asarray(jrow), trow.numpy())
        _assert_state_equal(jm, tm)
    assert int(tm.n_kfs) == 2 and int(tm.n_mps) > 100

    for enable in (True, False):
        vis = rng.uniform(size=CFG.map.max_mps) < 0.3
        found = rng.integers(-1, int(tm.n_mps), P).astype(np.int32)
        found[:5] = found[5]                               # repeated ids
        jm = jstate.bump_visibility(jm, jnp.asarray(vis), jnp.asarray(found),
                                    jnp.asarray(enable))
        tm = tstate.bump_visibility(tm, torch.from_numpy(vis),
                                    torch.from_numpy(found),
                                    torch.tensor(enable))
        _assert_state_equal(jm, tm)


def test_convert_round_trip():
    jm = jstate.empty(CFG)
    d = {k: np.array(v) for k, v in jax.device_get(jm._asdict()).items()}
    d["mp_desc"][:3] = np.uint32(0xFFFFFFFF)
    tm = convert.map_state_from_numpy(d)
    assert tm.mp_desc.dtype == torch.int32 and int(tm.mp_desc[0, 0]) == -1
    back = convert.to_numpy(tm)
    for name, a in d.items():
        np.testing.assert_array_equal(np.asarray(a), back[name])
        assert np.asarray(a).dtype == back[name].dtype
