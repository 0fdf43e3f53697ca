"""Port parity: ``solvers/ba.py::windowed_bundle_adjustment`` against the JAX
reference on the synthetic problem of ``tests/test_ba.py`` (8 cameras, 150
points, every pair observed, camera 0 fixed, one padded ``-1`` window row).

Cases: the plain problem; 150 gross outliers with mixed octaves and mono
edges (the Huber phase and the re-gating between phases decide); a compact
landmark axis of 64 slots that the 150 free points overflow (the newest 64
stay free); a window of 3 free cameras with 4 fixed observers (the
bounded-influence entry weight of fixed rows). Tolerances: poses 1e-4,
points 1e-3 (5e-3 for a point that only one camera observes),
``edge_inlier`` and ``edge_loose`` equal on >= 99% of the edges, the free
count exact. ``_inv3x3`` within 1e-5 relative, finite on a
singular block.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.solvers import ba as jba
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.solvers import ba as tba

from test_ba import _problem_as_table, make_ba_problem

N_CAMS, N_PTS = 8, 150


def _case(name):
    (cfg, prob, q0, t0, pos0, _, q_true, t_true, _) = make_ba_problem(
        n_cams=N_CAMS, n_pts=N_PTS)
    kf_uv, kf_ur, kf_oct, kf_mp, kp_valid = (
        np.array(a) for a in _problem_as_table(N_CAMS, N_PTS, prob, cfg))
    window_rows = np.array([1, 2, 3, 4, 5, 6, 7, -1], np.int32)
    mp_free = np.ones(N_PTS, bool)
    q0, t0 = np.array(q0), np.array(t0)
    rng = np.random.default_rng(5)
    if name == "outliers":
        idx = rng.choice(N_CAMS * N_PTS, 150, replace=False)
        uv = kf_uv.reshape(-1, 2)
        uv[idx] += rng.uniform(20, 80, (150, 2)) * rng.choice([-1, 1], (150, 2))
        kf_oct = rng.integers(0, 4, kf_oct.shape).astype(np.int32)
        kf_ur[rng.uniform(size=kf_ur.shape) < 0.3] = -1.0
        kf_mp[rng.uniform(size=kf_mp.shape) < 0.1] = -1
    elif name == "overflow":
        cfg = cfg.replace(solver=dataclasses.replace(
            cfg.solver, local_ba_max_points=64))
        mp_free[::7] = False
    elif name == "fixed_rows":
        # cameras 1-4 observe but stay fixed at their perturbed poses
        window_rows = np.array([5, 6, 7, -1], np.int32)
        q0[:5], t0[:5] = np.array(q_true[:5]), np.array(t_true[:5])
        far = rng.choice(N_PTS, 30, replace=False)
        kf_uv[2, far] += 15.0       # stale observations on a fixed row
    args = (q0, t0, window_rows, kf_uv, kf_ur, kf_oct, kf_mp, kp_valid,
            np.array(pos0), mp_free)
    return cfg, args


@pytest.mark.parametrize("name", ["plain", "outliers", "overflow",
                                  "fixed_rows"])
def test_windowed_bundle_adjustment(name):
    cfg, args = _case(name)
    want = jba.windowed_bundle_adjustment(*(jnp.asarray(a) for a in args), cfg)
    stats = {}
    got = tba.windowed_bundle_adjustment(
        *(torch.from_numpy(a) for a in args),
        convert.config_from_dict(dataclasses.asdict(cfg)), stats=stats)
    jq, jt, jpos, jinl, jloose, jfree = (np.asarray(x) for x in want)
    tq, tt, tpos, tinl, tloose, tfree = (x.numpy() for x in got)
    np.testing.assert_allclose(tq, jq, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    # a point that a single camera observes is held along its ray only by
    # that one stereo edge, so it follows the last LM step more loosely
    seen = np.zeros(N_PTS, int)
    np.add.at(seen, args[6][(args[6] >= 0) & args[7]], 1)
    np.testing.assert_allclose(tpos[seen >= 2], jpos[seen >= 2], atol=1e-3)
    np.testing.assert_allclose(tpos, jpos, atol=5e-3)
    assert (tinl == jinl).mean() >= 0.99
    assert (tloose == jloose).mean() >= 0.99
    assert tfree == jfree and got[5].dtype == torch.int32
    # the fixed cameras and the frozen points did not move
    q0, t0, window_rows, pos0, mp_free = (args[0], args[1], args[2], args[8],
                                          args[9])
    fixed = np.setdiff1d(np.arange(N_CAMS), window_rows)
    np.testing.assert_array_equal(tq[fixed], q0[fixed])
    np.testing.assert_array_equal(tt[fixed], t0[fixed])
    np.testing.assert_array_equal(tpos[~mp_free], pos0[~mp_free])
    if name == "overflow":
        # 128 free points on 64 slots: the oldest free rows stay frozen
        frozen = np.flatnonzero(mp_free)[:-64]
        np.testing.assert_array_equal(tpos[frozen], pos0[frozen])
        assert tfree == mp_free.sum() > 64
    # the LM only ever accepts a lower cost, and says how long it ran
    assert len(stats["iters"]) == 2
    assert 1 <= stats["iters"][0] <= 5 and 1 <= stats["iters"][1] <= 10
    for start, end in stats["cost"]:
        assert np.isfinite(end) and end <= start


def test_inv3x3():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(3, dtype=np.float32)
    A[-1] = 0.0
    want = np.asarray(jba._inv3x3(jnp.asarray(A)))
    got = tba._inv3x3(torch.from_numpy(A)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:-1] @ A[:-1],
                               np.broadcast_to(np.eye(3), (63, 3, 3)),
                               atol=1e-3)
