"""Port parity of ``solvers/pnp.py`` (EPnP + RANSAC) and of the EPnP null
space (``ops/linalg.min_subspace``), against the JAX reference on the same
numpy inputs.

Tolerances: noise-free EPnP recovers the true pose within 1e-4 (quaternion
and translation entries) on both sides, and the two agree within 1e-4;
RANSAC fed the reference's own sample indices keeps the reference's inlier
set exactly; with the port's own draw, its inlier count is within 2% of the
reference's. A degenerate 6-point set (duplicates from the draw with
replacement) gives a finite pose where the reference's is finite and a
non-finite one where it is not, and never disturbs the other members of a
batch. The null spaces agree as subspaces within 1e-5 (eigenvector signs
and order inside a cluster may differ).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam_2_ros_tpu.config import SlamConfig
from orb_slam_2_ros_tpu.geometry import camera as jcam
from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu.ops import linalg as jlinalg
from orb_slam_2_ros_tpu.solvers import pnp as jpnp
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.ops import linalg as tlinalg
from orb_slam_2_ros_tpu_torch.solvers import pnp as tpnp

torch.set_num_threads(2)

CFG = SlamConfig()
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
K = np.asarray(jcam.intrinsics(CFG.camera), np.float32)
# the reference's functions compiled once per shape (eager JAX dispatches
# each operation on its own, far slower on the CPU)
jepnp = jax.jit(jpnp.epnp)
jransac = jax.jit(jpnp.ransac_pnp, static_argnums=(3,))
N_RANSAC = 240


def scene(seed, n, outliers=0.0):
    """n world points in front of a camera at a random pose; their pixels,
    a fraction ``outliers`` of them moved by up to 80 px."""
    rng = np.random.default_rng(seed)
    xw = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    q = rng.normal(0, 0.15, 4) + np.array([1.0, 0, 0, 0])
    q = (q / np.linalg.norm(q)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    xc = np.asarray(jse3.apply(jnp.asarray(q), jnp.asarray(t),
                               jnp.asarray(xw)))
    uv = np.array(jcam.project(CFG.camera, jnp.asarray(xc)), np.float32)
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-80, 80, (int(bad.sum()), 2)).astype(np.float32)
    return xw, uv.copy(), q, t, bad


def t_(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed,n", [(0, 6), (1, 6), (2, 300), (3, 300)])
def test_epnp_noise_free(seed, n):
    xw, uv, q, t, _ = scene(seed, n)
    w = np.ones(n, np.float32)
    jq, jt = jepnp(jnp.asarray(xw), jnp.asarray(uv), jnp.asarray(w),
                       jnp.asarray(K))
    tq, tt = tpnp.epnp(t_(xw), t_(uv), t_(w), t_(K))
    np.testing.assert_allclose(tq.numpy(), q, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), t, atol=1e-4)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)


DEGENERATE = [[0, 0, 0, 0, 0, 0], [0, 1, 0, 1, 0, 1], [0, 1, 2, 0, 1, 2],
              [0, 1, 2, 3, 0, 1], [0, 1, 2, 3, 4, 4], [5, 5, 5, 5, 6, 7]]


@pytest.mark.parametrize("ids", DEGENERATE)
def test_epnp_degenerate_sets(ids):
    xw, uv, q, t, _ = scene(4, 20)
    sel = np.array(ids)
    ones = np.ones(6, np.float32)
    jq, jt = jepnp(jnp.asarray(xw[sel]), jnp.asarray(uv[sel]),
                       jnp.asarray(ones), jnp.asarray(K))
    # a batch: a good set, the degenerate one, a good set
    good = np.arange(6)
    batch = np.stack([good, sel, good + 6])
    tq, tt = tpnp.epnp(t_(xw[batch]), t_(uv[batch]),
                       torch.ones(3, 6), t_(K))
    j_finite = bool(np.isfinite(np.asarray(jq)).all()
                    and np.isfinite(np.asarray(jt)).all())
    t_finite = bool(torch.isfinite(tq[1]).all() and torch.isfinite(tt[1]).all())
    assert t_finite == j_finite
    for row, ids_good in ((0, good), (2, good + 6)):
        q1, t1 = tpnp.epnp(t_(xw[ids_good]), t_(uv[ids_good]), t_(ones), t_(K))
        np.testing.assert_allclose(tq[row].numpy(), q1.numpy(), atol=1e-5)
        np.testing.assert_allclose(tq[row].numpy(), q, atol=1e-4)
    if len(set(ids)) >= 5:      # enough distinct points: the true pose
        np.testing.assert_allclose(tq[1].numpy(), q, atol=1e-3)


def reference_draw(key, valid, n_hyp=256):
    pw = valid.astype(np.float32)
    pw = pw / max(pw.sum(), 1e-9)
    return np.asarray(jax.random.choice(key, len(valid), shape=(n_hyp, 6),
                                        replace=True, p=jnp.asarray(pw)))


@pytest.mark.parametrize("seed,outliers", [(5, 0.3), (6, 0.1), (7, 0.5)])
def test_ransac_with_the_reference_samples(seed, outliers):
    xw, uv, q, t, bad = scene(seed, N_RANSAC, outliers)
    valid = np.random.default_rng(seed).random(N_RANSAC) < 0.9
    key = jax.random.PRNGKey(seed)
    jq, jt, jinl, jn = jransac(jnp.asarray(xw), jnp.asarray(uv),
                                       jnp.asarray(valid), CFG, key)
    idx = reference_draw(key, valid)
    tq, tt, tinl, tn = tpnp.ransac_pnp(t_(xw), t_(uv), t_(valid), TCFG,
                                       sample_idx=t_(idx))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) == int(tinl.sum())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    # the inliers are the valid, untouched points
    assert not (tinl.numpy() & bad).any() or outliers == 0.5


@pytest.mark.parametrize("seed", [8, 9])
def test_ransac_own_draw_with_outliers(seed):
    xw, uv, q, t, bad = scene(seed, N_RANSAC, 0.3)
    valid = np.ones(N_RANSAC, bool)
    _, _, _, jn = jransac(jnp.asarray(xw), jnp.asarray(uv),
                                  jnp.asarray(valid), CFG,
                                  jax.random.PRNGKey(seed))
    g = torch.Generator().manual_seed(seed)
    tq, tt, tinl, tn = tpnp.ransac_pnp(t_(xw), t_(uv), t_(valid), TCFG,
                                       generator=g)
    assert abs(int(tn) - int(jn)) <= 0.02 * int(jn)
    np.testing.assert_allclose(tq.numpy(), q, atol=1e-3)


def test_ransac_batch_equals_single_problems():
    probs = [scene(s, 100, 0.3) for s in (10, 11, 12)]
    xw = np.stack([p[0] for p in probs])
    uv = np.stack([p[1] for p in probs])
    valid = np.ones((3, 100), bool)
    valid[1, 50:] = False
    valid[2] = False            # nothing to draw from: uniform, 0 inliers
    idx = tpnp.draw_samples(t_(valid), 64, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 64, 6)
    assert int(idx[1].max()) < 50
    bq, bt, binl, bn = tpnp.ransac_pnp(t_(xw), t_(uv), t_(valid), TCFG,
                                       sample_idx=idx)
    assert int(bn[2]) == 0
    for i in range(2):
        q, t, inl, n = tpnp.ransac_pnp(t_(xw[i]), t_(uv[i]), t_(valid[i]),
                                       TCFG, sample_idx=idx[i])
        assert int(n) == int(bn[i])
        np.testing.assert_array_equal(inl.numpy(), binl[i].numpy())
        np.testing.assert_allclose(q.numpy(), bq[i].numpy(), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_min_subspace_spans_the_references(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(40, 12)).astype(np.float32)
    A[:, 8:] = A[:, :4] * 1e-3            # a near-null cluster of 4
    G = (A.T @ A).astype(np.float32)
    Vj = np.asarray(jlinalg.min_subspace(jnp.asarray(G), 4))
    Vt = tlinalg.min_subspace(t_(G), 4).numpy()
    assert Vt.shape == (12, 4) and Vt.dtype == np.float32
    np.testing.assert_allclose(Vt.T @ Vt, np.eye(4), atol=1e-5)
    np.testing.assert_allclose(Vt @ Vt.T, Vj @ Vj.T, atol=1e-5)
