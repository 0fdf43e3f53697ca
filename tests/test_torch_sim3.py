"""Port parity of ``geometry/sim3`` and ``solvers/sim3_solver``.

The same numpy inputs, made from a seed, go through the JAX function and the
port's. Tolerances: the group operations agree within 1e-5 (2e-4 at a rotation of
1e-3 rad with a log-scale near zero, where the reference's own ``1 - cos``
cancels to a few digits in float32 and the two libraries' last bits of
``cos`` differ); ``horn_sim3``
within 1e-4 rad in rotation, 1e-4 in translation and 1e-5 in scale;
``ransac_sim3`` with the reference's own sample indices handed in gives the
same inlier mask; ``refine_sim3_lm`` the same inlier count and a pose within
1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import SlamConfig as JSlamConfig
from orb_slam_2_ros_tpu.geometry import sim3 as jsim3
from orb_slam_2_ros_tpu.solvers import sim3_solver as jsolver
from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import se3 as tse3
from orb_slam_2_ros_tpu_torch.geometry import sim3 as tsim3
from orb_slam_2_ros_tpu_torch.solvers import sim3_solver as tsolver

# Several test processes share the machine's cores; PyTorch's default of
# one thread per core in each of them makes the many small operations of
# these tests spin against each other (a 16 s fixture took 540 s in a run
# with six workers). Two threads per process keep them out of each other's way.
torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _rand_sim3(rng, n, angle=1.0):
    xi = np.concatenate([rng.normal(0, 1.0, (n, 3)),
                         rng.normal(0, angle, (n, 3)),
                         rng.normal(0, 0.2, (n, 1))], -1).astype(np.float32)
    return xi


def _close(t_out, j_out, atol=1e-5):
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


@pytest.mark.parametrize("angle,atol", [(1e-9, 1e-5), (1e-3, 2e-4),
                                        (1.0, 1e-5), (2.5, 1e-5)])
def test_group_operations(angle, atol):
    rng = np.random.default_rng(0)
    xa, xb = _rand_sim3(rng, 64, angle), _rand_sim3(rng, 64, angle)
    xa[:8, 6] = 0.0                     # the sigma -> 0 branches
    xa[8:16, 6] = 1e-7
    x = rng.normal(0, 2, (64, 3)).astype(np.float32)
    ja, jb = jsim3.exp(jnp.asarray(xa)), jsim3.exp(jnp.asarray(xb))
    ta, tb = tsim3.exp(_t(xa)), tsim3.exp(_t(xb))
    _close(ta, ja, atol)
    # the operations after exp start from the reference's own values
    ta, tb = tuple(map(_t, ja)), tuple(map(_t, jb))
    _close(tsim3.compose(*ta, *tb), jsim3.compose(*ja, *jb))
    _close(tsim3.inverse(*ta), jsim3.inverse(*ja))
    _close([tsim3.apply(*ta, _t(x))], [jsim3.apply(*ja, jnp.asarray(x))])
    _close(tsim3.to_se3(*ta), jsim3.to_se3(*ja))
    _close(tsim3.from_se3(ta[0], ta[1]), jsim3.from_se3(ja[0], ja[1]))
    _close([tsim3.log(*ta)], [jsim3.log(*ja)], atol=2 * atol)
    ti, ji = tsim3.identity((3,), device="cpu"), jsim3.identity((3,))
    _close(ti, ji, atol=0)
    assert ta[2].shape == (64, 1)


@pytest.mark.parametrize("angle", [1e-4, 0.3, 2.0])
def test_exp_log_round_trip(angle):
    rng = np.random.default_rng(1)
    xi = _rand_sim3(rng, 128, 1.0)
    # fixed rotation angle per row (the log is unique below pi)
    phi = xi[:, 3:6]
    xi[:, 3:6] = phi / np.linalg.norm(phi, axis=-1, keepdims=True) * angle
    back = tsim3.log(*tsim3.exp(_t(xi))).numpy()
    np.testing.assert_allclose(back, xi, atol=2e-4 * max(1.0, angle))


def _point_sets(rng, n, noise, scale=1.0):
    x2 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    x2[:, 2] += 5.0
    xi = np.array([[0.3, -0.2, 0.4, 0.1, -0.25, 0.15, np.log(scale)]],
                  np.float32)
    q, t, s = tsim3.exp(_t(xi))
    x1 = tsim3.apply(q, t, s, _t(x2)).numpy()
    x1 = x1 + rng.normal(0, noise, x1.shape).astype(np.float32)
    return x1.astype(np.float32), x2, (q[0].numpy(), t[0].numpy(),
                                       s[0].numpy())


def _rot_angle(qa, qb):
    qa, qb = _t(qa), _t(qb)
    d = tse3.quat_log(tse3.quat_mul(qa, tse3.quat_conj(qb)))
    return float(torch.linalg.norm(d))


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_horn_sim3(fix_scale, weighted):
    rng = np.random.default_rng(2)
    x1, x2, _ = _point_sets(rng, 60, 0.01, scale=1.0 if fix_scale else 1.3)
    w = (rng.uniform(size=60) > 0.3).astype(np.float32) if weighted else None
    jq, jt, js = jsolver.horn_sim3(
        jnp.asarray(x1), jnp.asarray(x2),
        w=None if w is None else jnp.asarray(w), fix_scale=fix_scale)
    tq, tt, ts = tsolver.horn_sim3(
        _t(x1), _t(x2), w=None if w is None else _t(w), fix_scale=fix_scale)
    assert _rot_angle(tq.numpy(), np.asarray(jq)) < 1e-4
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert ts.shape == (1,)
    # a batch of problems equals the problems one by one
    idx = rng.integers(0, 60, (5, 3))
    bq, bt, bs = tsolver.horn_sim3(_t(x1)[idx], _t(x2)[idx],
                                   fix_scale=fix_scale)
    for h in range(5):
        q1, t1, s1 = jsolver.horn_sim3(jnp.asarray(x1[idx[h]]),
                                       jnp.asarray(x2[idx[h]]),
                                       fix_scale=fix_scale)
        assert _rot_angle(bq[h].numpy(), np.asarray(q1)) < 1e-3
        np.testing.assert_allclose(bs[h].numpy(), np.asarray(s1), atol=1e-3)


def _ransac_inputs(seed=3, n=120, n_out=40):
    rng = np.random.default_rng(seed)
    cfg, jcfg = SlamConfig(), JSlamConfig()
    x1, x2, truth = _point_sets(rng, n, 0.002)
    bad = rng.choice(n, n_out, replace=False)
    x1[bad] += rng.normal(0, 0.8, (n_out, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 10, replace=False)] = False
    cam = cfg.camera

    def proj(x):
        return np.stack([cam.fx * x[:, 0] / x[:, 2] + cam.cx,
                         cam.fy * x[:, 1] / x[:, 2] + cam.cy], -1)

    uv1 = proj(x1).astype(np.float32)
    uv2 = proj(x2).astype(np.float32)
    return cfg, jcfg, x1, x2, valid, uv1, uv2, truth


def test_ransac_sim3_with_the_references_draw():
    cfg, jcfg, x1, x2, valid, uv1, uv2, truth = _ransac_inputs()
    key = jax.random.PRNGKey(7)
    n = len(x1)
    pw = valid.astype(np.float32)
    pw = pw / pw.sum()
    # the one line of the reference that draws (``ransac_sim3``)
    idx = np.asarray(jax.random.choice(key, n, shape=(256, 3), replace=True,
                                       p=jnp.asarray(pw)))
    jout = jsolver.ransac_sim3(*map(jnp.asarray, (x1, x2, valid, uv1, uv2)),
                               jcfg, key, fix_scale=True)
    tout = tsolver.ransac_sim3(*map(_t, (x1, x2, valid, uv1, uv2)), cfg,
                               fix_scale=True, sample_idx=_t(idx))
    assert int(tout[4]) == int(jout[4]) >= 60
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert _rot_angle(tout[0].numpy(), np.asarray(jout[0])) < 1e-4
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               atol=1e-4)
    assert _rot_angle(tout[0].numpy(), truth[0]) < 5e-3


def test_ransac_sim3_own_generator():
    cfg, _, x1, x2, valid, uv1, uv2, truth = _ransac_inputs(seed=4)
    args = tuple(map(_t, (x1, x2, valid, uv1, uv2)))

    def run(seed):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return tsolver.ransac_sim3(*args, cfg, generator=g, fix_scale=True)

    a, b = run(0), run(0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[4]) >= 60 and not bool((a[3] & ~args[2]).any())
    assert _rot_angle(a[0].numpy(), truth[0]) < 5e-3
    # without a single valid pair nothing faults and nothing is an inlier
    none = tsolver.ransac_sim3(args[0], args[1], torch.zeros_like(args[2]),
                               args[3], args[4], cfg,
                               generator=torch.Generator().manual_seed(0))
    assert int(none[4]) == 0


@pytest.mark.parametrize("fix_scale", [True, False])
def test_refine_sim3_lm(fix_scale):
    cfg, jcfg, x1, x2, valid, uv1, uv2, truth = _ransac_inputs(seed=5)
    # start a little off the truth
    xi = np.array([0.02, -0.01, 0.015, 0.004, -0.006, 0.003, 0.0], np.float32)
    q0, t0, s0 = tsim3.compose(*tsim3.exp(_t(xi)), *map(_t, truth))
    jout = jsolver.refine_sim3_lm(
        jnp.asarray(q0.numpy()), jnp.asarray(t0.numpy()),
        jnp.asarray(s0.numpy()),
        *map(jnp.asarray, (x1, x2, uv1, uv2, valid)), jcfg,
        fix_scale=fix_scale)
    tout = tsolver.refine_sim3_lm(q0, t0, s0,
                                  *map(_t, (x1, x2, uv1, uv2, valid)), cfg,
                                  fix_scale=fix_scale)
    assert int(tout[4]) == int(jout[4]) >= 60
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert _rot_angle(tout[0].numpy(), np.asarray(jout[0])) < 1e-4
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               atol=1e-4)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                               atol=1e-4)
