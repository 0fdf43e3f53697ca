"""Port parity: Hamming distances, the masked best-two matcher (plain
version against the reference's Pallas kernel in interpret mode), and the
tracking searches against the reference's CPU matcher path. All integer
outputs must match exactly. The CUDA kernel is checked against the plain
version in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_pallas_match import make_case

from orb_slam_2_ros_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                       SlamConfig)
from orb_slam_2_ros_tpu.frontend import matcher as jm
from orb_slam_2_ros_tpu.frontend.extractor import Keypoints as JKeypoints
from orb_slam_2_ros_tpu.frontend.frame import Frame as JFrame
from orb_slam_2_ros_tpu.geometry import se3 as jse3
from orb_slam_2_ros_tpu.ops import hamming as jh
from orb_slam_2_ros_tpu.ops import pallas_match
from orb_slam_2_ros_tpu_torch import _build
from orb_slam_2_ros_tpu_torch.frontend import matcher as tm
from orb_slam_2_ros_tpu_torch.frontend.extractor import Keypoints as TKeypoints
from orb_slam_2_ros_tpu_torch.frontend.frame import Frame as TFrame
from orb_slam_2_ros_tpu_torch.ops import hamming as th
from orb_slam_2_ros_tpu_torch.ops import match_kernel

CAM = CameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=159.5,
                   cy=119.5, bf=20.0, th_depth=50.0)
P = 256
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=P, max_kps=P),
                 map=MapConfig(max_kfs=8, max_mps=512, max_kps=P))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


# ------------------------------------------------------------------ Hamming

def test_hamming_matrix_exact_with_top_bits():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (56, 8), dtype=np.uint32)
    a[:5] |= np.uint32(0x80000000)            # sign bit set in int32
    a[5] = 0xFFFFFFFF
    b[0] = a[0]
    jd = jh.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b))
    _eq(jd, th.hamming_matrix(_i32(a), _i32(b)))
    _eq(jh.hamming_pairs(jnp.asarray(a[:40]), jnp.asarray(b[:40])),
        th.hamming_pairs(_i32(a[:40]), _i32(b[:40])))
    _eq(jh.popcount_u32(jnp.asarray(a)), th.popcount(_i32(a)))


def test_best_two_ties_and_empty_rows():
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 6, (64, 48)).astype(np.int32)   # many ties
    mask = rng.uniform(size=(64, 48)) < 0.3
    mask[:3] = False                                        # no candidate
    mask[3] = False
    mask[3, 7] = True                                       # one candidate
    jo = jh.best_two(jnp.asarray(dist), jnp.asarray(mask))
    to = th.best_two(torch.from_numpy(dist), torch.from_numpy(mask))
    for j, t in zip(jo, to):
        _eq(j, t)


# ------------------------------------------- masked best-two: plain vs Pallas

@pytest.mark.parametrize("shape", [None, (1536, 1536)])
def test_masked_best_two_reference_matches_pallas(shape):
    a, b, row_meta, col_meta = (make_case() if shape is None
                                else make_case(*shape, seed=5))
    pb = pallas_match.masked_best_two(
        jh.unpack_pm1(jnp.asarray(a)), jnp.asarray(row_meta),
        jh.unpack_pm1(jnp.asarray(b)), jnp.asarray(col_meta), interpret=True)
    pbi, pbd, psi, psd = (np.asarray(x) for x in pb)
    tbi, tbd, tsi, tsd = (x.numpy() for x in match_kernel.masked_best_two(
        _i32(a), torch.from_numpy(row_meta), _i32(b),
        torch.from_numpy(col_meta)))
    has = pbd <= 256
    np.testing.assert_array_equal(tbd <= 256, has)          # same empty rows
    np.testing.assert_array_equal(tbd[has], pbd[has])
    np.testing.assert_array_equal(tbi[has], pbi[has])
    has2 = psd <= 256
    np.testing.assert_array_equal(tsd <= 256, has2)
    np.testing.assert_array_equal(tsd[has2], psd[has2])
    np.testing.assert_array_equal(tsi[has2], psi[has2])
    # the port's no-candidate convention is the plain path's (INF_DIST, 0)
    assert (tbd[~has] == th.INF_DIST).all() and (tbi[~has] == 0).all()
    assert has.any() and (~has).any() and (has & ~has2).any()


def test_kernel_dispatch_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    a, b, row_meta, col_meta = make_case(128, 128)
    args = [t.to("meta") for t in (_i32(a), torch.from_numpy(row_meta),
                                   _i32(b), torch.from_numpy(col_meta))]
    with pytest.raises(ValueError):
        match_kernel.masked_best_two(*args)


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("masked_best_two", build_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


# -------------------------------------------- conflicts and rotation bins

def test_resolve_conflicts_exact():
    rng = np.random.default_rng(2)
    n_q, n_kps = 300, 64
    best_kp = rng.integers(0, n_kps, n_q).astype(np.int32)
    best_d = rng.integers(0, 8, n_q).astype(np.int32)       # distance ties
    accept = rng.uniform(size=n_q) < 0.6
    jo = jm.resolve_conflicts(jnp.asarray(best_kp), jnp.asarray(best_d),
                              jnp.asarray(accept), n_kps)
    to = tm.resolve_conflicts(torch.from_numpy(best_kp),
                              torch.from_numpy(best_d),
                              torch.from_numpy(accept), n_kps)
    for j, t in zip(jo, to):
        _eq(j, t)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_rotation_consistency_exact(seed):
    rng = np.random.default_rng(seed)
    # a few populated bins with equal counts: the top-3 cut falls among ties
    centres = rng.choice(np.arange(0, 360, 30), size=5, replace=False)
    rot = np.concatenate([np.full(7, c) + rng.uniform(-5, 5, 7)
                          for c in centres] + [rng.uniform(-360, 360, 20)])
    rot = rot.astype(np.float32)
    accept = rng.uniform(size=rot.shape[0]) < 0.9
    _eq(jm.rotation_consistency(jnp.asarray(rot), jnp.asarray(accept)),
        tm.rotation_consistency(torch.from_numpy(rot),
                                torch.from_numpy(accept)))


# ------------------------------------------------------------- the searches

def _frame_np(rng, uv=None, desc=None, octave=None, angle=None):
    u = rng.uniform([0, 0], [CAM.width, CAM.height], (P, 2)).astype(np.float32)
    if uv is not None:
        u[:len(uv)] = uv
    d = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32)
    if desc is not None:
        d[:len(desc)] = desc
    o = rng.integers(0, 8, P).astype(np.int32)
    if octave is not None:
        o[:len(octave)] = octave
    a = rng.uniform(-np.pi, np.pi, P).astype(np.float32)
    if angle is not None:
        a[:len(angle)] = angle
    depth = np.where(rng.uniform(size=P) < 0.3, -1.0,
                     rng.uniform(0.5, 5, P)).astype(np.float32)
    ur = np.where(depth > 0, u[:, 0] - CAM.bf / np.maximum(depth, 1e-9),
                  -1.0).astype(np.float32)
    return dict(xy=u, response=np.zeros(P, np.float32), angle=a, octave=o,
                desc=d, valid=rng.uniform(size=P) > 0.1, uv=u, u_right=ur,
                depth=depth)


def _frames(f):
    jk = JKeypoints(**{k: jnp.asarray(f[k]) for k in JKeypoints._fields})
    tk = TKeypoints(**{k: (_i32(f[k]) if k == "desc"
                           else torch.from_numpy(f[k]))
                       for k in TKeypoints._fields})
    jf = JFrame(kps=jk, uv=jnp.asarray(f["uv"]),
                u_right=jnp.asarray(f["u_right"]),
                depth=jnp.asarray(f["depth"]))
    tf = TFrame(kps=tk, uv=torch.from_numpy(f["uv"]),
                u_right=torch.from_numpy(f["u_right"]),
                depth=torch.from_numpy(f["depth"]))
    return jf, tf


def _flip_bits(rng, desc, max_bits):
    out = desc.copy()
    for row in out:
        for _ in range(rng.integers(0, max_bits)):
            w, bit = rng.integers(0, 8), rng.integers(0, 32)
            row[w] ^= np.uint32(1) << np.uint32(bit)
    return out


def _projection_case(seed, n=P):
    """Source points seen by the frame: keypoints near their projections,
    descriptors with a few flipped bits, octaves within one level."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jse3.quat_exp(jnp.asarray([0.02, -0.03, 0.01])))
    t = np.array([0.05, -0.02, 0.1], np.float32)
    pw = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(1, 5, (n, 1))],
                        -1).astype(np.float32)
    xc = np.asarray(jse3.apply(jnp.asarray(q), jnp.asarray(t), jnp.asarray(pw)))
    uv = np.stack([CAM.fx * xc[:, 0] / xc[:, 2] + CAM.cx,
                   CAM.fy * xc[:, 1] / xc[:, 2] + CAM.cy], -1)
    src_oct = rng.integers(0, 4, n).astype(np.int32)
    src_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    src_angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    m = int(0.7 * n)
    # up to 1.5 x the th=3 window: the narrow pass misses some, 2x gets all
    jitter = rng.uniform(-4.5, 4.5, (m, 2)) * 1.2 ** src_oct[:m, None]
    f = _frame_np(rng, uv=(uv[:m] + jitter).astype(np.float32),
                  desc=_flip_bits(rng, src_desc[:m], 40),
                  octave=np.clip(src_oct[:m] + rng.integers(-1, 2, m), 0, 7),
                  angle=(src_angle[:m] + rng.normal(0, 0.05, m)).astype(np.float32))
    src_valid = rng.uniform(size=n) < 0.9
    return q, t, pw, src_desc, src_oct, src_valid, src_angle, f


@pytest.mark.parametrize("widen_below,seed", [(0, 6), (10 ** 6, 6), (5, 7)])
def test_search_by_projection_pose_exact(widen_below, seed):
    q, t, pw, desc, octv, valid, angle, f = _projection_case(seed)
    jf, tf = _frames(f)
    jo = jm.search_by_projection_pose(
        jnp.asarray(pw), jnp.asarray(desc), jnp.asarray(octv),
        jnp.asarray(valid), jnp.asarray(q), jnp.asarray(t), jf, CFG, th=3.0,
        src_angle=jnp.asarray(angle), check_rotation=True,
        widen_below=widen_below)
    to = tm.search_by_projection_pose(
        torch.from_numpy(pw), _i32(desc), torch.from_numpy(octv),
        torch.from_numpy(valid), torch.from_numpy(q), torch.from_numpy(t), tf,
        CFG, th=3.0, src_angle=torch.from_numpy(angle),
        widen_below=widen_below)
    _eq(jo[0], to[0])
    _eq(jo[1], to[1])
    assert (to[0].numpy() >= 0).sum() > 20
    if widen_below == 10 ** 6:      # the retry fired and changed the result
        narrow = tm.search_by_projection_pose(
            torch.from_numpy(pw), _i32(desc), torch.from_numpy(octv),
            torch.from_numpy(valid), torch.from_numpy(q), torch.from_numpy(t),
            tf, CFG, th=3.0, src_angle=torch.from_numpy(angle))
        assert (to[0] >= 0).sum() > (narrow[0] >= 0).sum()


def test_search_local_map_exact():
    q, t, pw, desc, octv, valid, angle, f = _projection_case(8)
    rng = np.random.default_rng(9)
    jf, tf = _frames(f)
    # max distances that predict each point's source octave
    dist = np.linalg.norm(pw - np.asarray(jse3.camera_center(
        jnp.asarray(q), jnp.asarray(t))), axis=-1)
    max_dist = (dist * 1.2 ** (octv - 0.5)).astype(np.float32)
    jtv = jm.frustum_check(jnp.asarray(q), jnp.asarray(t), jnp.asarray(pw),
                           jnp.asarray(rng.normal(size=(P, 3)) * 0.1
                                       + [0, 0, 1], jnp.float32),
                           jnp.zeros(P), jnp.asarray(max_dist),
                           jnp.asarray(valid), CFG, view_cos_limit=-1.0)
    jtv = jtv._replace(view_cos=jnp.asarray(
        np.where(rng.uniform(size=P) < 0.5, 0.999, 0.9), jnp.float32))
    ttv = tm.TrackInView(*(torch.from_numpy(np.asarray(x)) for x in jtv))
    kp_has = rng.uniform(size=P) < 0.15
    for th_lm in (3.0, 5.0):
        jo = jm.search_local_map(jtv, jnp.asarray(desc), jf,
                                 jnp.asarray(kp_has), CFG, th=jnp.float32(th_lm))
        to = tm.search_local_map(ttv, _i32(desc), tf, torch.from_numpy(kp_has),
                                 CFG, th=torch.tensor(th_lm))
        _eq(jo[0], to[0])
        _eq(jo[1], to[1])
        assert (to[0].numpy() >= 0).sum() > 20


def test_frustum_check_and_predict_level():
    q, t, pw, *_ = _projection_case(10)
    rng = np.random.default_rng(11)
    normal = (rng.normal(size=(P, 3)) * 0.3 + [0, 0, 1]).astype(np.float32)
    args = (pw, normal, rng.uniform(0, 1, P).astype(np.float32),
            rng.uniform(2, 8, P).astype(np.float32), rng.uniform(size=P) < 0.9)
    jtv = jm.frustum_check(jnp.asarray(q), jnp.asarray(t),
                           *(jnp.asarray(a) for a in args), CFG)
    ttv = tm.frustum_check(torch.from_numpy(q), torch.from_numpy(t),
                           *(torch.from_numpy(a) for a in args), CFG)
    for name, j, tt in zip(jtv._fields, jtv, ttv):
        if j.dtype == jnp.float32:
            np.testing.assert_allclose(np.asarray(j), tt.numpy(), atol=1e-3,
                                       err_msg=name)
        else:
            _eq(j, tt)


def test_search_reference_kf_exact():
    rng = np.random.default_rng(12)
    f = _frame_np(rng)
    jf, tf = _frames(f)
    perm = rng.permutation(P)
    ref_desc = _flip_bits(rng, f["desc"][perm], 30)
    ref_desc[::5] = rng.integers(0, 2 ** 32, (len(ref_desc[::5]), 8),
                                 dtype=np.uint32)
    ref_valid = rng.uniform(size=P) < 0.8
    # a common in-plane rotation, so the rotation histogram keeps most
    ref_angle = (f["angle"][perm] + 0.3 + rng.normal(0, 0.02, P)).astype(np.float32)
    jo = jm.search_reference_kf(jnp.asarray(ref_desc), jnp.asarray(ref_valid),
                                jnp.asarray(ref_angle), jf, CFG)
    to = tm.search_reference_kf(_i32(ref_desc), torch.from_numpy(ref_valid),
                                torch.from_numpy(ref_angle), tf, CFG)
    _eq(jo[0], to[0])
    _eq(jo[1], to[1])
    assert (to[0].numpy() >= 0).sum() > 50
