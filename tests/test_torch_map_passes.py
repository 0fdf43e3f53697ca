"""Port parity: the local-mapping passes of ``map/state.py`` against the JAX
reference on random maps made with numpy.

``observation_count``, ``covisibility``, ``compact_points`` and
``compact_keyframes`` are exact in every field (floats are only moved).
``refresh_point_stats`` and ``_distinctive_descriptors``: integer fields and
descriptors exact, floats within 1e-5. The maps hold culled keyframes and
map points, points seen twice by one keyframe, ring buffers with stale
entries (fused or culled observations) and, in the ``few_desc`` cases,
keyframe descriptors drawn from 3 patterns so that the medians tie.
``map_state_from_numpy`` must carry every field of both ``MapState``s.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import MapConfig, OrbConfig, SlamConfig
from orb_slam_2_ros_tpu.map import state as jstate
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.map import state as tstate

K, P, M = 12, 48, 160
NOBS = jstate.NOBS_DESC


def _cfg():
    return SlamConfig(orb=OrbConfig(n_features=P, max_kps=P),
                      map=MapConfig(max_kfs=K, max_mps=M, max_kps=P))


def random_map(seed, few_desc=False):
    """A dict of numpy arrays with the fields of MapState."""
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32
    n_kfs, n_mps = 9, 120
    kf_valid = (np.arange(K) < n_kfs) & (rng.uniform(size=K) < 0.8)
    kf_valid[0] = True
    mp_valid = (np.arange(M) < n_mps) & (rng.uniform(size=M) < 0.85)
    live = np.flatnonzero(mp_valid)
    kf_mp = np.where(rng.uniform(size=(K, P)) < 0.6,
                     rng.choice(live, size=(K, P)), -1).astype(i32)
    kf_mp[n_kfs:] = -1
    kf_mp[1, :4] = live[0]          # one point seen 4 times by keyframe 1
    q = rng.normal(size=(K, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(f32)
    if few_desc:
        pats = rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint32)
        kf_desc = pats[rng.integers(0, 3, (K, P))]
    else:
        kf_desc = rng.integers(0, 2 ** 32, (K, P, 8), dtype=np.uint32)
    # ring buffers: the point's live observations, newest last, then stale
    # entries: a slot of another point, a slot of a culled keyframe, -1
    tbl = np.full((M, NOBS), -1, i32)
    cnt = np.zeros(M, i32)
    for k in range(n_kfs):
        for p in range(P):
            j = kf_mp[k, p]
            if j >= 0:
                tbl[j, cnt[j] % NOBS] = k * P + p
                cnt[j] += 1
    stale = rng.uniform(size=(M, NOBS)) < 0.2
    tbl = np.where(stale, rng.integers(-1, n_kfs * P, (M, NOBS)), tbl).astype(i32)
    tbl[live[1]] = -1               # a whole buffer empty: re-seeded
    return dict(
        kf_q=q, kf_t=rng.normal(size=(K, 3)).astype(f32), kf_valid=kf_valid,
        kf_frame_id=rng.integers(0, 500, K).astype(i32),
        kf_uv=rng.uniform(0, 640, (K, P, 2)).astype(f32),
        kf_ur=rng.uniform(-1, 600, (K, P)).astype(f32),
        kf_depth=rng.uniform(-1, 9, (K, P)).astype(f32),
        kf_octave=rng.integers(0, 8, (K, P)).astype(i32),
        kf_angle=rng.uniform(-3, 3, (K, P)).astype(f32),
        kf_desc=kf_desc, kf_kp_valid=rng.uniform(size=(K, P)) < 0.9,
        kf_mp=kf_mp,
        mp_pos=rng.normal(0, 3, (M, 3)).astype(f32), mp_valid=mp_valid,
        mp_desc=rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32),
        mp_normal=rng.normal(size=(M, 3)).astype(f32),
        mp_min_dist=rng.uniform(0.1, 1, M).astype(f32),
        mp_max_dist=rng.uniform(5, 20, M).astype(f32),
        mp_first_kf=np.where(mp_valid, rng.integers(0, n_kfs, M), -1).astype(i32),
        mp_dir_sum=rng.normal(size=(M, 3)).astype(f32),
        mp_obs_cnt=cnt, mp_visible=rng.integers(1, 30, M).astype(i32),
        mp_found=rng.integers(1, 30, M).astype(i32), mp_obs_tbl=tbl,
        n_kfs=np.array(n_kfs, i32), n_mps=np.array(n_mps, i32))


def both(d):
    jm = jstate.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    return jm, convert.map_state_from_numpy(d, "cpu")


def assert_maps_equal(jm, tm, float_tol=0.0):
    got = convert.to_numpy(tm)
    for name, want in jm._asdict().items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype, name
        if float_tol and want.dtype == np.float32:
            np.testing.assert_allclose(got[name], want, atol=float_tol,
                                       rtol=float_tol, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_map_state_fields_cross_over():
    """Both MapStates name the same fields in the same order, and the
    conversion carries each one, among them the ones only the mapper reads
    (mp_obs_tbl, mp_dir_sum, mp_obs_cnt, mp_first_kf, kf_depth)."""
    assert tstate.MapState._fields == jstate.MapState._fields
    assert tstate.NOBS_DESC == jstate.NOBS_DESC
    jm, tm = both(random_map(0))
    assert_maps_equal(jm, tm)
    cfg = convert.config_from_dict(dataclasses.asdict(_cfg()))
    empty = tstate.empty(cfg, "cpu")
    assert_maps_equal(jstate.empty(_cfg()), empty)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observation_count_and_covisibility(seed):
    jm, tm = both(random_map(seed))
    cnt = tstate.observation_count(tm)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(),
                                  np.asarray(jstate.observation_count(jm)))
    cov = tstate.covisibility(tm)
    assert cov.dtype == torch.int32
    np.testing.assert_array_equal(cov.numpy(),
                                  np.asarray(jstate.covisibility(jm)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_points(seed):
    jm, tm = both(random_map(seed))
    jm2, jremap = jstate.compact_points(jm)
    tm2, tremap = tstate.compact_points(tm)
    np.testing.assert_array_equal(tremap.numpy(), np.asarray(jremap))
    assert tremap.dtype == torch.int32 and tm2.n_mps.dtype == torch.int32
    assert_maps_equal(jm2, tm2)
    assert int(tm2.n_mps) == int(tm2.mp_valid.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_keyframes(seed):
    jm, tm = both(random_map(seed))
    jm2, jremap = jstate.compact_keyframes(jm)
    tm2, tremap = tstate.compact_keyframes(tm)
    np.testing.assert_array_equal(tremap.numpy(), np.asarray(jremap))
    assert tm2.n_kfs.dtype == torch.int32
    assert_maps_equal(jm2, tm2)
    assert int(tm2.n_kfs) == int(tm2.kf_valid.sum()) < int(tm.n_kfs)


@pytest.mark.parametrize("seed,few_desc", [(0, False), (1, False), (2, True),
                                           (3, True)])
def test_refresh_point_stats(seed, few_desc):
    jm, tm = both(random_map(seed, few_desc))
    cfg = _cfg()
    jm2 = jstate.refresh_point_stats(jm, cfg)
    tm2 = tstate.refresh_point_stats(
        tm, convert.config_from_dict(dataclasses.asdict(cfg)))
    assert_maps_equal(jm2, tm2, float_tol=1e-5)
    # the case is what it says: stale entries were met and a buffer re-seeded
    assert (np.asarray(jm2.mp_obs_tbl) != np.asarray(jm.mp_obs_tbl)).any()


@pytest.mark.parametrize("few_desc", [False, True])
def test_distinctive_descriptors(few_desc):
    d = random_map(4, few_desc)
    tbl = d["mp_obs_tbl"]
    have = (tbl >= 0) & (np.random.default_rng(0).uniform(size=tbl.shape) < 0.8)
    desc_flat = d["kf_desc"].reshape(-1, 8)
    want = np.asarray(jstate._distinctive_descriptors(
        jnp.asarray(tbl), jnp.asarray(have), jnp.asarray(desc_flat)))
    got = tstate._distinctive_descriptors(
        torch.from_numpy(tbl), torch.from_numpy(have),
        torch.from_numpy(desc_flat.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
