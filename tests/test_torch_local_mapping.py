"""Port parity: the pieces of ``pipeline/local_mapping.py`` and the two
matcher searches they use, against the JAX reference on the same numpy
inputs.

``search_for_triangulation`` and ``search_by_projection_pose(
check_rotation=False)``: exact. ``create_new_map_points``,
``fuse_duplicates`` and ``cull_keyframes`` on the maps of
``tests/test_triangulation_mapping.py`` and ``tests/test_fusion_culling.py``
(with the RGB-D sensor): every integer and bool field of the map and the
returned count exact, float fields within 1e-4.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.config import (MapConfig, OrbConfig, SENSOR_RGBD,
                                       SlamConfig)
from orb_slam_2_ros_tpu.frontend import matcher as jm
from orb_slam_2_ros_tpu.geometry import camera as jcamera
from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu.map import state as jstate
from orb_slam_2_ros_tpu.pipeline import local_mapping as jlm
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.frontend import matcher as tm
from orb_slam_2_ros_tpu_torch.pipeline import local_mapping as tlm

from test_torch_map_passes import assert_maps_equal
from test_torch_matching import CFG, _eq, _frames, _i32, _projection_case
from test_triangulation_mapping import build_two_kf_map


def port_cfg(cfg):
    return convert.config_from_dict(dataclasses.asdict(cfg))


def to_port(jmap):
    return convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in jmap._asdict().items()}, "cpu")


def rgbd_cfg(max_kfs=8, max_mps=1024):
    return SlamConfig(
        sensor=SENSOR_RGBD, orb=OrbConfig(n_features=256, max_kps=256),
        map=MapConfig(max_kfs=max_kfs, max_mps=max_mps, max_kps=256))


# ------------------------------------------------------------- the searches

@pytest.mark.parametrize("seed", [0, 1])
def test_search_for_triangulation_exact(seed):
    """Two views of the same points plus clutter; descriptors with flipped
    bits and some equal ones, so distances tie."""
    rng = np.random.default_rng(seed)
    cfg = rgbd_cfg()
    cam = cfg.camera
    N = 200
    q1, t1 = (np.array(x) for x in jse3.identity())
    q2, t2 = (np.array(x) for x in jse3.exp(
        jnp.asarray([0.3, 0.02, 0.01, 0.01, -0.04, 0.02])))
    pts = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                    rng.uniform(3, 8, N)], -1).astype(np.float32)
    uv1 = np.array(jcamera.project(cam, jse3.apply(q1, t1, jnp.asarray(pts))))
    uv2 = np.array(jcamera.project(cam, jse3.apply(q2, t2, jnp.asarray(pts))))
    uv2 = (uv2 + rng.normal(0, 0.7, uv2.shape)).astype(np.float32)
    uv2[150:] = rng.uniform(0, 480, (50, 2))            # clutter
    desc1 = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    desc1[10:20] = desc1[0]                             # ties
    desc2 = desc1.copy()
    flips = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    desc2 ^= flips & rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32) \
        & np.uint32(0x01010101)
    oct2 = rng.integers(0, 4, N).astype(np.int32)
    v1 = rng.uniform(size=N) < 0.9
    v2 = rng.uniform(size=N) < 0.9
    # F12 as create_new_map_points builds it
    rq, rt = jse3.relative(jnp.asarray(q2), jnp.asarray(t2), jnp.asarray(q1),
                           jnp.asarray(t1))
    tx = jnp.array([[0, -rt[2], rt[1]], [rt[2], 0, -rt[0]],
                    [-rt[1], rt[0], 0.0]])
    Kinv = jnp.linalg.inv(jcamera.intrinsics(cam))
    F12 = np.array(Kinv.T @ (tx @ jse3.quat_to_matrix(rq)) @ Kinv)
    zeros = jnp.zeros((N,))
    jo = jm.search_for_triangulation(
        jnp.asarray(desc1), jnp.asarray(uv1), zeros, zeros, zeros,
        jnp.asarray(v1), jnp.asarray(desc2), jnp.asarray(uv2), zeros,
        jnp.asarray(oct2), zeros, jnp.asarray(v2), jnp.asarray(F12), cfg)
    to = tm.search_for_triangulation(
        _i32(desc1), torch.from_numpy(uv1), torch.from_numpy(v1),
        _i32(desc2), torch.from_numpy(uv2), torch.from_numpy(oct2),
        torch.from_numpy(v2), torch.from_numpy(F12), port_cfg(cfg))
    _eq(jo[0], to[0])
    _eq(jo[1], to[1])
    assert (to[0].numpy() >= 0).sum() > 80


@pytest.mark.parametrize("seed", [6, 7])
def test_search_by_projection_pose_without_rotation_check(seed):
    """The fusion caller's mode: no source angle, no rotation histogram."""
    q, t, pw, desc, octv, valid, angle, f = _projection_case(seed)
    jf, tf = _frames(f)
    jo = jm.search_by_projection_pose(
        jnp.asarray(pw), jnp.asarray(desc), jnp.asarray(octv),
        jnp.asarray(valid), jnp.asarray(q), jnp.asarray(t), jf, CFG, th=3.0,
        check_rotation=False)
    to = tm.search_by_projection_pose(
        torch.from_numpy(pw), _i32(desc), torch.from_numpy(octv),
        torch.from_numpy(valid), torch.from_numpy(q), torch.from_numpy(t), tf,
        CFG, th=3.0, check_rotation=False)
    _eq(jo[0], to[0])
    _eq(jo[1], to[1])
    checked = tm.search_by_projection_pose(
        torch.from_numpy(pw), _i32(desc), torch.from_numpy(octv),
        torch.from_numpy(valid), torch.from_numpy(q), torch.from_numpy(t), tf,
        CFG, th=3.0, src_angle=torch.from_numpy(angle))
    assert (to[0] >= 0).sum() >= (checked[0] >= 0).sum() > 20


# ----------------------------------------------------------- triangulation

def ten_neighbour_map(cfg, seed=7, n_neigh=10, n_shared=15, n_free=10):
    """The newest keyframe's unmatched keypoints spread over ``n_neigh``
    covisible neighbours that all tie at the covisibility threshold (the
    map of ``test_reference_breadth_ten_neighbors_single_pass``)."""
    rng = np.random.default_rng(seed)
    K, P, M = cfg.map.max_kfs, cfg.map.max_kps, cfg.map.max_mps
    kf_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_uv = np.zeros((K, P, 2), np.float32)
    kf_desc = np.zeros((K, P, 8), np.uint32)
    kf_kp_valid = np.zeros((K, P), bool)
    kf_mp = np.full((K, P), -1, np.int32)
    kf_oct = rng.integers(0, 3, (K, P)).astype(np.int32)
    mp_pos = np.zeros((M, 3), np.float32)
    mp_valid = np.zeros((M,), bool)
    mp_first = np.full((M,), -1, np.int32)
    k, slot_k, next_mp = n_neigh, 0, 0
    for r in range(n_neigh):
        kf_t[r] = (0.3 * (1 + 0.03 * r), 0.0, 0.0)
        n = n_shared + n_free
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(4, 8, n)], -1).astype(np.float32)
        descs = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        for row, slots in ((k, slice(slot_k, slot_k + n)), (r, slice(0, n))):
            kf_uv[row, slots] = np.array(jcamera.project(cfg.camera, jse3.apply(
                jnp.asarray(kf_q[row]), jnp.asarray(kf_t[row]),
                jnp.asarray(pts))))
            kf_desc[row, slots] = descs
            kf_kp_valid[row, slots] = True
            kf_mp[row, slots][:n_shared] = next_mp + np.arange(n_shared)
        kf_oct[r, :n] = kf_oct[k, slot_k:slot_k + n]
        mp_pos[next_mp:next_mp + n_shared] = pts[:n_shared]
        mp_valid[next_mp:next_mp + n_shared] = True
        mp_first[next_mp:next_mp + n_shared] = r
        next_mp += n_shared
        slot_k += n
    m = jstate.empty(cfg)
    return m._replace(
        kf_q=jnp.asarray(kf_q), kf_t=jnp.asarray(kf_t),
        kf_valid=jnp.asarray(np.arange(K) <= n_neigh),
        kf_uv=jnp.asarray(kf_uv), kf_desc=jnp.asarray(kf_desc),
        kf_octave=jnp.asarray(kf_oct),
        kf_kp_valid=jnp.asarray(kf_kp_valid), kf_mp=jnp.asarray(kf_mp),
        mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
        mp_first_kf=jnp.asarray(mp_first),
        n_kfs=jnp.int32(n_neigh + 1), n_mps=jnp.int32(next_mp)), n_free


def _triangulation_map(name):
    if name == "ten_neighbours":
        cfg = rgbd_cfg(max_kfs=16, max_mps=2048)
        m, n_free = ten_neighbour_map(cfg)
        return cfg, m, 10 * n_free
    cfg = rgbd_cfg()
    m, _, n_shared, n_new = build_two_kf_map(cfg)
    if name == "no_covisibility":
        kf_mp = np.array(m.kf_mp)
        kf_mp[:, :n_shared] = -1
        return cfg, m._replace(kf_mp=jnp.asarray(kf_mp)), 0
    if name == "pool_nearly_full":      # the spawn is cut at the capacity
        return cfg, m._replace(n_mps=jnp.int32(m.M - 7)), 7 / 0.7
    return cfg, m, n_new


@pytest.mark.parametrize("name", ["two_keyframes", "no_covisibility",
                                  "pool_nearly_full", "ten_neighbours"])
def test_create_new_map_points(name):
    cfg, m, n_pairable = _triangulation_map(name)
    jm2, jn = jlm.create_new_map_points(m, cfg)
    tm2, tn = tlm.create_new_map_points(to_port(m), port_cfg(cfg))
    assert int(tn) == int(jn) and tn.dtype == torch.int32
    assert_maps_equal(jm2, tm2, float_tol=1e-4)
    assert int(tn) >= 0.7 * n_pairable
    if name == "no_covisibility":
        assert int(tn) == 0
    if name == "pool_nearly_full":
        assert int(tn) == 7 and int(tm2.n_mps) == m.M


# ------------------------------------------------------------------ fusion

def _fusion_map(name):
    """Keyframe 1 references copies of a third of keyframe 0's landmarks
    (``test_fuse_merges_duplicates``). ``two_losers``: keypoints 4 and 5 of
    keyframe 0 both hold one landmark of their own, whose observation count
    ties with those of landmarks 4 and 5 that keyframe 1 projects onto
    them; the lower id wins a tie, so that landmark is named as loser twice
    in one sweep, with two different winners."""
    cfg = rgbd_cfg()
    m, _, n_shared, _ = build_two_kf_map(cfg, n_shared=40, noise=0.1)
    rng = np.random.default_rng(0)
    mp_pos, mp_valid = np.array(m.mp_pos), np.array(m.mp_valid)
    mp_desc, kf_mp = np.array(m.mp_desc), np.array(m.kf_mp)
    mp_desc[:n_shared] = np.array(m.kf_desc)[0, :n_shared]
    for i in range(n_shared):
        dup = n_shared + i
        mp_pos[dup] = mp_pos[i] + rng.normal(0, 0.01, 3)
        mp_valid[dup] = True
        mp_desc[dup] = mp_desc[i]
        if i % 3 == 0:
            kf_mp[1, i] = dup
    n_mps = 2 * n_shared
    if name == "two_losers":
        own = n_mps
        # behind both cameras: it is never projected itself, only met
        mp_pos[own], mp_valid[own] = (0.0, 0.0, -5.0), True
        kf_mp[0, 4] = kf_mp[0, 5] = own         # 2 observations of `own`
        kf_mp[1, 210], kf_mp[1, 211] = 4, 5     # 2 each of landmarks 4, 5
        n_mps += 1
    m = m._replace(
        mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
        mp_desc=jnp.asarray(mp_desc), kf_mp=jnp.asarray(kf_mp),
        mp_visible=jnp.asarray(rng.integers(1, 20, m.M).astype(np.int32)),
        mp_found=jnp.asarray(rng.integers(1, 20, m.M).astype(np.int32)),
        n_mps=jnp.int32(n_mps))
    return cfg, m


@pytest.mark.parametrize("name", ["duplicates", "two_losers"])
def test_fuse_duplicates(name):
    cfg, m = _fusion_map(name)
    jm2, jn = jlm.fuse_duplicates(m, cfg)
    tm2, tn = tlm.fuse_duplicates(to_port(m), port_cfg(cfg))
    assert int(tn) == int(jn) > 0 and tn.dtype == torch.int32
    assert_maps_equal(jm2, tm2, float_tol=1e-4)
    assert tm2.mp_visible.dtype == tm2.mp_found.dtype == torch.int32
    # no observation names a landmark that fusion invalidated
    kf_mp, valid = tm2.kf_mp.numpy(), tm2.mp_valid.numpy()
    assert valid[kf_mp[kf_mp >= 0]].all()
    if name == "two_losers":
        own = int(m.n_mps) - 1
        assert not valid[own] and kf_mp[0, 4] == kf_mp[0, 5] == 5


# ---------------------------------------------------------------- culling

def _cull_map(name):
    """5 keyframes over 40 slots (``test_cull_redundant_keyframe``,
    ``test_cull_keeps_unique_keyframes``); ``octaves``: shared landmarks
    seen at mixed scale levels, so the scale gate decides."""
    cfg = SlamConfig(orb=OrbConfig(n_features=64, max_kps=64),
                     map=MapConfig(max_kfs=8, max_mps=512, max_kps=64))
    K, P, M = 8, 64, 512
    rng = np.random.default_rng(1)
    kf_mp = np.full((K, P), -1, np.int32)
    kf_oct = np.zeros((K, P), np.int32)
    if name == "unique":
        for i in range(5):
            kf_mp[i, :40] = np.arange(40) + i * 40
    else:
        kf_mp[:5, :40] = np.arange(40)
    if name == "octaves":
        kf_oct = rng.integers(0, 8, (K, P)).astype(np.int32)
    m = jstate.empty(cfg)._replace(
        kf_valid=jnp.asarray(np.arange(K) < 5),
        kf_kp_valid=jnp.asarray(np.tile((np.arange(P) < 40)[None], (K, 1))),
        kf_mp=jnp.asarray(kf_mp), kf_octave=jnp.asarray(kf_oct),
        mp_valid=jnp.asarray(np.arange(M) < 200),
        n_kfs=jnp.int32(5), n_mps=jnp.int32(200))
    return cfg, m


@pytest.mark.parametrize("name,n_expected", [("redundant", 3), ("unique", 0),
                                             ("octaves", None)])
def test_cull_keyframes(name, n_expected):
    cfg, m = _cull_map(name)
    jm2, jn = jlm.cull_keyframes(m, cfg)
    tm2, tn = tlm.cull_keyframes(to_port(m), port_cfg(cfg))
    assert int(tn) == int(jn) and tn.dtype == torch.int32
    if n_expected is not None:
        assert int(tn) == n_expected
    assert_maps_equal(jm2, tm2)
