"""Port parity of the monocular modules against the JAX reference, on the
same numpy inputs (Slice 6).

- ``frame.build_mono``: keypoints compared by overlap (>= 98%, trap 4);
  on the keypoints both sides found, descriptors identical, undistorted
  coordinates within 1e-3 px and angles within 1e-3 rad (measured: 4.7e-4
  on 2 of 500 keypoints, the IC moments summed in another order; the
  descriptors, which the angle steers, are identical); depth and right
  coordinate -1.
- ``matcher.search_for_initialization`` on identical frames: exact.
- ``linalg.null_vector``: the same direction up to sign, |cos| > 1 - 1e-5.
- ``initializer.initialize`` with the reference's own draw (its
  ``jax.random.split`` + ``argsort(uniform)`` sets recomputed here and
  injected as ``sample_idx``), on the scenes of
  ``tests/test_initializer.py``: ``ok``, ``used_h`` and the ``good`` mask
  equal; the rotation within 1e-4 (quaternion components), the unit
  translation within 1e-3, the accepted points within 1e-2 m at the
  initializer's unit baseline (measured: 6.5e-3 on the general scene,
  where the float64 null space of the port and the float32 inverse
  iteration of the reference part); the no-parallax pair is rejected on
  both sides. With the port's own draw the general scene must still pass.
- ``bundle_adjustment`` (the CG LM): with every camera fixed, the points
  after 1, 2, 3 and 20 iterations within 1e-4 of the reference's (the
  damping path); with free cameras (stereo and mono edges, the gauge
  fixed) poses within 1e-4 and points within 1e-3 after (5, 10); the
  structure-only path that skips the CG equal to the full path bit for
  bit.
- ``MonoInitializer._build_map`` on the reference's own inputs (its
  matches, pose and triangulation, captured from its initializer on the
  synthetic sequence of ``tests/test_mono_tracking.py``): the point pool,
  ``kf_mp`` and every counter equal, poses equal, the points after the
  structure-only BA and the median step within 1e-5 relative + 1e-4 (at
  the unit baseline they lie 40-50 away; measured 3.5e-6 relative), the
  normals and scale bands within 1e-4 relative.
- The median fault of the reference (``ROADMAP.md``): ``median_or_one``
  equals ``nan_to_num(jnp.median(x), nan=1.0)`` on a masked array (1.0)
  and on a fully valid even-length array (the mean of the two middles).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.frontend import frame as jframe
from orb_slam_2_ros_tpu.frontend import matcher as jmatcher
from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.ops import linalg as jlinalg
from orb_slam_2_ros_tpu.pipeline import mono_init as jmono
from orb_slam_2_ros_tpu.solvers import ba as jba
from orb_slam_2_ros_tpu.solvers import initializer as jinit
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.frontend import frame as tframe
from orb_slam_2_ros_tpu_torch.frontend import matcher as tmatcher
from orb_slam_2_ros_tpu_torch.ops import linalg as tlinalg
from orb_slam_2_ros_tpu_torch.pipeline import local_mapping as tlm
from orb_slam_2_ros_tpu_torch.pipeline import mono_init as tmono
from orb_slam_2_ros_tpu_torch.solvers import ba as tba
from orb_slam_2_ros_tpu_torch.solvers import initializer as tinit

from test_ba import make_ba_problem
from test_initializer import make_two_view
from test_mono_tracking import mono_cfg
from test_torch_frontend import _angle_diff, _keypoint_table

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq():
    cfg = mono_cfg()
    ds = SyntheticRGBD(cfg, n_frames=24, seed=0, radius=1.5, angle_range=0.9)
    grays = np.stack([ds[i][0] for i in range(len(ds))]).astype(np.float32)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    build = jax.jit(jframe.build_mono, static_argnums=1)
    return dict(cfg=cfg, tcfg=tcfg, ds=ds, grays=grays,
                build=lambda i: build(jnp.asarray(grays[i], jnp.float32),
                                      cfg))


def _tframe(jf):
    return convert.frame_from_numpy(jax.device_get(jf._asdict()), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_build_mono_by_overlap(seq):
    jf = seq["build"](5)
    tf = tframe.build_mono(torch.from_numpy(seq["grays"][5]), seq["tcfg"])
    jkp = jax.device_get(jf.kps._asdict())
    jt = _keypoint_table(jkp["xy"], jkp["octave"], jkp["valid"])
    tt = _keypoint_table(tf.kps.xy.numpy(), tf.kps.octave.numpy(),
                         tf.kps.valid.numpy())
    common = sorted(set(jt) & set(tt))
    assert len(common) / max(len(jt), len(tt)) >= 0.98
    ji = np.array([jt[c] for c in common])
    ti = np.array([tt[c] for c in common])
    np.testing.assert_array_equal(np.asarray(jf.kps.desc)[ji].view(np.int32),
                                  tf.kps.desc.numpy()[ti])
    np.testing.assert_allclose(np.asarray(jf.uv)[ji], tf.uv.numpy()[ti],
                               atol=1e-3)
    np.testing.assert_array_less(
        _angle_diff(np.asarray(jf.kps.angle)[ji], tf.kps.angle.numpy()[ti]),
        1e-3)
    assert (tf.depth == -1).all() and (tf.u_right == -1).all()


@pytest.mark.parametrize("pair", [(0, 0), (0, 3), (2, 9)])
def test_search_for_initialization_exact(seq, pair):
    jr, jc = seq["build"](pair[0]), seq["build"](pair[1])
    want = jax.jit(lambda a, b: jmatcher.search_for_initialization(
        a, b, seq["cfg"]))(jr, jc)
    got = tmatcher.search_for_initialization(_tframe(jr), _tframe(jc),
                                             seq["tcfg"])
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert (got[0] >= 0).sum() > 60


def test_null_vector_up_to_sign():
    rng = np.random.default_rng(3)
    for rows in (8, 16, 300):
        A = rng.normal(size=(rows, 9)).astype(np.float32)
        if rows == 300:      # a near-null direction under noise
            A[:, 8] = A[:, :8] @ rng.normal(size=8) + 1e-3 * A[:, 8]
        want = np.asarray(jlinalg.null_vector(jnp.asarray(A)))
        got = tlinalg.null_vector(torch.from_numpy(A)).numpy()
        assert abs(np.dot(want, got)) / (np.linalg.norm(want)
                                         * np.linalg.norm(got)) > 1 - 1e-5
    batch = rng.normal(size=(5, 16, 9)).astype(np.float32)
    got = tlinalg.null_vector(torch.from_numpy(batch)).numpy()
    for b in range(5):
        want = np.asarray(jlinalg.null_vector(jnp.asarray(batch[b])))
        assert abs(np.dot(want, got[b])) > 1 - 1e-5


def _reference_sets(key, valid, n=tinit.N_HYPOTHESES):
    """The reference's 8-point sets: split the key per hypothesis, then
    the 8 smallest uniform keys among the valid matches."""
    keys = jax.random.split(key, n)
    r = jax.vmap(lambda k: jax.random.uniform(k, (valid.shape[0],)))(keys)
    r = jnp.where(valid, r, 2.0)
    return torch.from_numpy(np.asarray(jnp.argsort(r, axis=-1)[:, :8]))


_jinitialize = jax.jit(jinit.initialize)


def _both(uv1, uv2, valid, K, own_draw=False):
    key = jax.random.PRNGKey(0)
    jres = _jinitialize(uv1, uv2, valid, K, key)
    args = [_t(x) for x in (uv1, uv2, valid, K)]
    if own_draw:
        tres = tinit.initialize(*args,
                                generator=torch.Generator().manual_seed(2))
    else:
        tres = tinit.initialize(*args, sample_idx=_reference_sets(key, valid))
    return jres, tres


@pytest.mark.parametrize("scene", [dict(), dict(planar=True),
                                   dict(outlier_frac=0.2)],
                         ids=["general", "planar", "outliers"])
def test_initialize_with_the_reference_draw(scene):
    uv1, uv2, valid, K, _, _ = make_two_view(**scene)
    jres, tres = _both(uv1, uv2, valid, K)
    assert bool(jres.ok) and bool(tres.ok)
    assert bool(tres.used_h) == bool(jres.used_h) == ("planar" in scene)
    good = np.asarray(jres.good)
    np.testing.assert_array_equal(tres.good.numpy(), good)
    q = tres.q.numpy() * np.sign(tres.q.numpy()[0] * np.asarray(jres.q)[0])
    np.testing.assert_allclose(q, np.asarray(jres.q), atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-3)
    np.testing.assert_allclose(tres.points.numpy()[good],
                               np.asarray(jres.points)[good], atol=1e-2)


def test_initialize_rejects_no_parallax_and_draws_its_own():
    rng = np.random.default_rng(43)
    uv1, uv2, valid, K, _, _ = make_two_view()
    _, tres = _both(uv1, uv2, valid, K, own_draw=True)
    assert bool(tres.ok) and not bool(tres.used_h)
    # pure rotation (tests/test_initializer.py::test_init_rejects_no_parallax)
    from orb_slam_2_ros_tpu.config import SlamConfig
    from orb_slam_2_ros_tpu.geometry import camera, se3
    cam = SlamConfig().camera
    pts = np.stack([rng.uniform(-2, 2, 150), rng.uniform(-1.5, 1.5, 150),
                    rng.uniform(3, 8, 150)], -1).astype(np.float32)
    q2, _ = se3.exp(jnp.asarray([0.0, 0, 0, 0.02, -0.04, 0.01]))
    p1 = np.asarray(camera.project(cam, jnp.asarray(pts)))
    p2 = np.asarray(camera.project(cam, se3.apply(q2, jnp.zeros(3),
                                                  jnp.asarray(pts))))
    p1 = p1 + rng.normal(0, 0.3, p1.shape)
    p2 = p2 + rng.normal(0, 0.3, p2.shape)
    jres, tres = _both(jnp.asarray(p1, jnp.float32),
                       jnp.asarray(p2, jnp.float32),
                       jnp.ones(150, bool), K)
    assert not bool(jres.ok) and not bool(tres.ok)


def _ba_both(stereo, phases, fixed_cams):
    cfg, prob, q0, t0, pos0, cam_free, _, _, _ = make_ba_problem(
        n_cams=4, n_pts=80, stereo=stereo)
    if fixed_cams:
        cam_free = jnp.zeros_like(cam_free)
    mp_free = jnp.ones(pos0.shape[0], bool)
    jq, jt, jpos, jinl = jax.jit(lambda *a: jba.bundle_adjustment(
        *a, cfg, phases=phases))(q0, t0, cam_free, pos0, mp_free, prob)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tprob = tba.BAProblem(**{f: _t(getattr(prob, f)) for f in
                             tba.BAProblem._fields})
    tprob = tprob._replace(cam_idx=tprob.cam_idx.long(),
                           mp_idx=tprob.mp_idx.long())
    args = (_t(q0), _t(t0), _t(cam_free), _t(pos0), _t(mp_free), tprob, tcfg)
    got = tba.bundle_adjustment(*args, phases=phases)
    return (jq, jt, jpos, jinl), got, args


@pytest.mark.parametrize("n_iters", [1, 2, 3, 20])
def test_structure_only_ba_follows_the_reference(n_iters):
    want, got, args = _ba_both(False, (n_iters,), True)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # every camera fixed: the CG is skipped with the same result
    q, t, _, pos, mp_free, prob, cfg = args
    skip = tba.bundle_adjustment(q, t, None, pos, mp_free, prob, cfg,
                                 phases=(n_iters,))
    for a, b in zip(skip, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stereo", [True, False], ids=["stereo", "mono"])
def test_ba_with_free_cameras_like_the_reference(stereo):
    want, got, _ = _ba_both(stereo, (5, 10), False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3)
    assert (got[3].numpy() == np.asarray(want[3])).mean() > 0.99


@pytest.fixture(scope="module")
def build_map_inputs(seq):
    """The reference initializer over the sequence until it succeeds; the
    arguments and the result of its ``_build_map`` call."""
    mi = jmono.MonoInitializer(seq["cfg"])
    calls = []
    build = mi._build_map

    def recorded(*a):
        out = build(*a)
        calls.append((a, out))
        return out

    mi._build_map = recorded
    for i in range(len(seq["grays"])):
        if mi.process(seq["grays"][i], i) is not None:
            break
    assert len(calls) == 1
    return calls[0]


def test_build_map_like_the_reference(seq, build_map_inputs):
    (ref, cur, c2r, q, t, points, good, rid, cid), jout = build_map_inputs
    m, q1, t1, kp_mp = tmono._build_map(
        seq["tcfg"], _tframe(ref), _tframe(cur), _t(c2r), _t(q), _t(t),
        _t(points), _t(good), int(rid), int(cid))
    jm = jax.device_get(jout[0]._asdict())
    tm = convert.to_numpy(m)
    for f in ("kf_valid", "kf_frame_id", "kf_mp", "kf_kp_valid", "mp_valid",
              "mp_first_kf", "mp_obs_cnt", "mp_visible", "mp_found",
              "mp_desc", "kf_desc", "mp_obs_tbl", "n_kfs", "n_mps"):
        np.testing.assert_array_equal(tm[f], jm[f], err_msg=f)
    assert int(tm["n_mps"]) > 50
    for f in ("kf_q", "kf_t"):
        np.testing.assert_allclose(tm[f], jm[f], atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tm["mp_pos"], jm["mp_pos"], rtol=1e-5,
                               atol=1e-4)
    for f in ("mp_normal", "mp_min_dist", "mp_max_dist"):
        np.testing.assert_allclose(tm[f], jm[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(kp_mp.numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(t1.numpy(), np.asarray(jout[2]), atol=1e-6)


@pytest.mark.parametrize("case", ["masked", "even"])
def test_median_like_the_reference(case):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.5, 9.0, 64).astype(np.float32)
    if case == "masked":
        x[rng.uniform(size=64) < 0.2] = np.nan
    want = float(jnp.nan_to_num(jnp.median(jnp.asarray(x)), nan=1.0))
    got = float(tmono.median_or_one(torch.from_numpy(x)))
    assert got == want
    if case == "masked":
        assert got == 1.0
    else:
        s = np.sort(x)
        assert got == pytest.approx(0.5 * (s[31] + s[32]), rel=1e-6)
    # the triangulation's baseline gate takes the same function
    assert tlm.median_or_one is tmono.median_or_one
