"""Port parity of the dense chunked global BA (``solvers/ba.dense_gba_init``
/ ``dense_gba_chunk``) on the drifted ring of ``tests/test_loop_closing.py``.

Against the reference on the same snapshot: positions and poses within
1e-3 after chunks of 3 and 7 iterations, ``err`` within 1e-3 relative, the
same ``lam`` path over the first chunk (every accept/reject decision
equal), with every other
camera free, with all cameras fixed, and with seam priors (``loop_w > 0``);
with every camera free but the first the problem is ill-conditioned in
float32 and is held to 5 cm (see that test). The ring's keypoints get the right coordinate of an
RGB-D frame from their depth, as on the port's path, and half a pixel of
noise. The port's structure-only body equals its full body when
``cam_free`` is all false, within 1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.solvers import ba as jba
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.solvers import ba as tba

from test_loop_closing import N_KF, build_looped_map, small_cfg

# Several test processes share the machine's cores; PyTorch's default of
# one thread per core in each of them makes the many small operations of
# these tests spin against each other (a 16 s fixture took 540 s in a run
# with six workers). Two threads per process keep them out of each other's way.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ring():
    return _make_ring()


def _make_ring():
    cfg = small_cfg()
    m, gt, _ = build_looped_map(cfg)
    # perturb the points a little so that the structure has work to do
    rng = np.random.default_rng(0)
    pos = np.asarray(m.mp_pos) + rng.normal(0, 0.01, m.mp_pos.shape).astype(
        np.float32)
    # the ring's keypoints carry depth: give them the right coordinate an
    # RGB-D frame would have. With monocular edges alone the all-free
    # problem is so ill-conditioned in float32 that a last-bit change of
    # the inputs moves the reference's own first step by millimetres.
    depth = np.asarray(m.kf_depth)
    ur = np.where(depth > 0, np.asarray(m.kf_uv)[..., 0]
                  - cfg.camera.bf / np.maximum(depth, 1e-6), -1.0)
    # half a pixel of measurement noise keeps the optimum's error well
    # above float noise, so that every accept/reject decision is clear-cut
    uv = np.asarray(m.kf_uv) + rng.normal(0, 0.5, m.kf_uv.shape)
    ur = np.where(depth > 0, ur + rng.normal(0, 0.5, ur.shape), -1.0)
    m = m._replace(mp_pos=jnp.asarray(pos),
                   kf_uv=jnp.asarray(uv.astype(np.float32)),
                   kf_ur=jnp.asarray(ur.astype(np.float32)))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return cfg, tcfg, m, convert.map_state_from_numpy(
        jax.device_get(m._asdict()), "cpu")


def _loops(weight):
    L = 16
    li = np.zeros(L, np.int32)
    lj = np.zeros(L, np.int32)
    lq = np.tile(np.array([1.0, 0, 0, 0], np.float32), (L, 1))
    lt = np.zeros((L, 3), np.float32)
    lw = np.zeros(L, np.float32)
    # keyframe N_KF-1 revisits keyframe 0's pose: the seam's relative pose
    # is the identity; a second, looser prior between two mid-ring rows
    li[0], lj[0], lw[0] = 0, N_KF - 1, weight
    li[1], lj[1], lw[1] = 3, 5, 0.1 * weight
    lq[1] = np.array([0.98, 0.0, -0.19899749, 0.0], np.float32)
    lt[1] = np.array([0.5, 0.0, 1.2], np.float32)
    return li, lj, lq, lt, lw


def _init_both(ring, cam_free, loop_weight=0.0):
    cfg, tcfg, jm, tm = ring
    kp_valid = jm.kf_kp_valid & jm.kf_valid[:, None]
    loops = _loops(loop_weight) if loop_weight else (None,) * 5
    jst = jba.dense_gba_init(
        jm.kf_uv, jm.kf_ur, jm.kf_octave, jm.kf_mp, kp_valid, jm.kf_q,
        jm.kf_t, jnp.asarray(cam_free), jm.mp_pos, jm.mp_valid, jm.n_kfs,
        jm.n_mps, cfg, *[None if x is None else jnp.asarray(x)
                         for x in loops])
    tst = tba.dense_gba_init(
        tm.kf_uv, tm.kf_ur, tm.kf_octave, tm.kf_mp,
        tm.kf_kp_valid & tm.kf_valid[:, None], tm.kf_q, tm.kf_t,
        torch.from_numpy(cam_free), tm.mp_pos, tm.mp_valid, tm.n_kfs,
        tm.n_mps, tcfg, *[None if x is None else torch.from_numpy(x)
                          for x in loops])
    return cfg, tcfg, jst, tst


def _compare(jst, tst, atol=1e-3, lam=True):
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos), atol=atol)
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), atol=atol)
    np.testing.assert_allclose(tst.t.numpy(), np.asarray(jst.t), atol=atol)
    np.testing.assert_allclose(float(tst.err), float(jst.err), rtol=1e-3)
    if lam:
        np.testing.assert_allclose(float(tst.lam), float(jst.lam), rtol=1e-5)


@pytest.mark.parametrize("case", ["free", "fixed", "prior"])
def test_dense_gba_matches_reference(ring, case):
    K = ring[0].map.max_kfs
    cam_free = np.zeros(K, bool)
    if case != "fixed":
        cam_free[1:N_KF:2] = True
    cfg, tcfg, jst, tst = _init_both(
        ring, cam_free, loop_weight=50.0 if case == "prior" else 0.0)
    np.testing.assert_allclose(float(tst.err), float(jst.err), rtol=1e-4)
    assert np.isfinite(float(tst.err)) and float(tst.err) > 0
    err0 = float(tst.err)
    for chunk, n_iters in enumerate((3, 7)):
        jst = jba.dense_gba_chunk(jst, cfg, n_iters=n_iters)
        tst = tba.dense_gba_chunk(tst, tcfg, n_iters=n_iters)
        # the damping path is held over the first three iterations, while
        # each step still gains more than float noise (Gauss-Newton is at
        # the optimum by then, where an accept is a coin's toss on both
        # sides)
        _compare(jst, tst, lam=chunk == 0)
    assert float(tst.err) < err0
    if case == "fixed":
        assert torch.equal(tst.q, ring[3].kf_q)
    else:
        assert not torch.equal(tst.t, ring[3].kf_t)
    # the conversion carries a reference state over field by field
    carried = convert.dense_gba_state_from_numpy(
        jax.device_get(jst._asdict()), "cpu")
    assert carried.kf_mp.dtype == torch.int32
    again = tba.dense_gba_chunk(carried, tcfg, n_iters=1)
    ref = jba.dense_gba_chunk(jst, cfg, n_iters=1)
    _compare(ref, again)


def test_dense_gba_all_cameras_free(ring):
    """The loop closer's own choice under ``gba_structure_only=False``:
    every camera free but row 0. The explicitly formed Schur complement is
    then ill-conditioned in float32: a last-bit change of the inputs moves
    the REFERENCE's own first step by about a millimetre, so the two sides
    are held to the error they reach (1e-3 relative) and to 5 cm (3 cm
    seen)."""
    K = ring[0].map.max_kfs
    cam_free = np.zeros(K, bool)
    cam_free[1:N_KF] = True
    cfg, tcfg, jst, tst = _init_both(ring, cam_free)
    err0 = float(tst.err)
    jst = jba.dense_gba_chunk(jst, cfg, n_iters=5)
    tst = tba.dense_gba_chunk(tst, tcfg, n_iters=5)
    np.testing.assert_allclose(float(tst.err), float(jst.err), rtol=1e-3)
    assert float(tst.err) < err0
    np.testing.assert_allclose(tst.t.numpy(), np.asarray(jst.t), atol=5e-2)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=5e-2)
    assert bool(torch.isfinite(tst.pos).all() & torch.isfinite(tst.q).all())


@pytest.mark.parametrize("loop_weight", [0.0, 50.0])
def test_structure_only_body_equals_full_body(ring, loop_weight):
    K = ring[0].map.max_kfs
    _, tcfg, _, tst = _init_both(ring, np.zeros(K, bool), loop_weight)
    full = tba.dense_gba_chunk(tst, tcfg, n_iters=5, structure_only=False)
    only = tba.dense_gba_chunk(tst, tcfg, n_iters=5, structure_only=True)
    np.testing.assert_allclose(only.pos.numpy(), full.pos.numpy(), atol=1e-5)
    assert torch.equal(only.q, full.q) and torch.equal(only.t, full.t)
    np.testing.assert_allclose(float(only.err), float(full.err), rtol=1e-6)
    assert float(only.lam) == float(full.lam)
    # structure_only=True holds every camera, whatever cam_free says
    free = np.zeros(K, bool)
    free[1:N_KF:2] = True
    held = tba.dense_gba_chunk(_init_both(ring, free, loop_weight)[3], tcfg,
                               n_iters=5, structure_only=True)
    assert torch.equal(held.q, tst.q) and torch.equal(held.t, tst.t)
    assert torch.equal(held.pos, only.pos)
    # the seam priors' constant is part of the error in both bodies
    if loop_weight:
        bare = _init_both(ring, np.zeros(K, bool), 0.0)[3]
        assert float(tst.err) > float(bare.err)


def test_loop_prior_terms_match_reference(ring):
    K = ring[0].map.max_kfs
    cam_free = np.zeros(K, bool)
    cam_free[1:N_KF] = True
    _, _, jst, tst = _init_both(ring, cam_free, loop_weight=50.0)
    jr, jJk, jJc = jba._loop_prior_terms(jst, jst.q, jst.t)
    tr, tJk, tJc = tba._loop_prior_terms(tst, tst.q, tst.t)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tJk.numpy(), np.asarray(jJk), atol=1e-4)
    np.testing.assert_allclose(tJc.numpy(), np.asarray(jJc), atol=1e-4)
    np.testing.assert_allclose(
        float(tba._loop_prior_error(tst, tst.q, tst.t)),
        float(jba._loop_prior_error(jst, jst.q, jst.t)), rtol=1e-4)
