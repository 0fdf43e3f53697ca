"""The port keeps its own copies of the reference's configuration, synthetic
sequence, trajectory metric and rBRIEF pattern. These tests hold each copy
against its original, so that the two cannot drift: configurations field by
field through ``dataclasses.asdict``, rendered frames bit for bit, ATE to
1e-12, the pattern element by element.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu import config as jconfig
from orb_slam_2_ros_tpu.frontend import extractor as jextractor
from orb_slam_2_ros_tpu.io import synthetic as jsyn
from orb_slam_2_ros_tpu.io import trajectory as jtraj
from orb_slam_2_ros_tpu_torch import config as tconfig
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch import io as tio
from orb_slam_2_ros_tpu_torch.frontend import extractor as textractor
from orb_slam_2_ros_tpu_torch.io import synthetic as tsyn
from orb_slam_2_ros_tpu_torch.io import trajectory as ttraj


def _small(mod):
    """The small test configuration of tests/test_tracking_e2e.py."""
    cam = mod.CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                           cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    return mod.SlamConfig(
        sensor=mod.SENSOR_RGBD, camera=cam,
        orb=mod.OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=mod.MapConfig(max_kfs=16, max_mps=4096, max_kps=640,
                          local_map_cap=1024),
        tracking=mod.TrackingConfig(min_init_stereo_kps=200))


CONFIGS = {
    "default": lambda mod: mod.SlamConfig(),
    "rgbd": lambda mod: mod.SlamConfig(sensor=mod.SENSOR_RGBD),
    "small": _small,
    "tum_fr1": lambda mod: mod.tum_fr1_config(),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_agrees_field_by_field(name):
    jcfg, tcfg = CONFIGS[name](jconfig), CONFIGS[name](tconfig)
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert list(jd) == list(td)                     # same fields, same order
    for section in jd:
        assert jd[section] == td[section], section
    assert type(tcfg.camera) is tconfig.CameraConfig
    assert tcfg.orb.scale_factors() == jcfg.orb.scale_factors()
    assert tcfg.camera.has_distortion == jcfg.camera.has_distortion
    assert tcfg.vocab.num_words == jcfg.vocab.num_words


def test_config_classes_and_constants_match():
    for cls in ("CameraConfig", "OrbConfig", "MatcherConfig", "SolverConfig",
                "MapConfig", "TrackingConfig", "VocabConfig", "MeshConfig",
                "SlamConfig"):
        jf = [(f.name, f.type) for f in dataclasses.fields(getattr(jconfig, cls))]
        tf = [(f.name, f.type) for f in dataclasses.fields(getattr(tconfig, cls))]
        assert jf == tf, cls
    for const in ("SENSOR_MONOCULAR", "SENSOR_STEREO", "SENSOR_RGBD"):
        assert getattr(jconfig, const) == getattr(tconfig, const)
    cfg = tconfig.SlamConfig()
    assert cfg.replace(seed=3).seed == 3 and cfg.seed == 0
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.seed = 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_from_dict_round_trips(name):
    jcfg = CONFIGS[name](jconfig)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, tconfig.SlamConfig)
    assert isinstance(tcfg.map, tconfig.MapConfig)
    assert tcfg == CONFIGS[name](tconfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert convert.config_from_dict(dataclasses.asdict(tcfg)) == tcfg


def test_config_from_dict_rejects_unknown_and_missing_fields():
    d = dataclasses.asdict(tconfig.SlamConfig())
    with pytest.raises(TypeError, match="no field"):
        convert.config_from_dict({**d, "orb": {**d["orb"], "n_octaves": 8}})
    missing = {k: v for k, v in d["camera"].items() if k != "fx"}
    with pytest.raises(TypeError, match="missing"):
        convert.config_from_dict({**d, "camera": missing})


@pytest.mark.parametrize("trajectory,drift", [("orbit", 0.0), ("loop", 0.0),
                                              ("fastrot", 0.25)])
def test_synthetic_rgbd_bit_for_bit(trajectory, drift):
    n = 3
    jds = jsyn.SyntheticRGBD(_small(jconfig), n_frames=n, seed=7,
                             trajectory=trajectory, exposure_drift=drift)
    tds = tio.SyntheticRGBD(_small(tconfig), n_frames=n, seed=7,
                            trajectory=trajectory, exposure_drift=drift)
    assert len(jds) == len(tds) == n
    np.testing.assert_array_equal(jds.timestamps, tds.timestamps)
    for i in range(n):
        jg, jd = jds[i]
        tg, td = tds[i]
        assert tg.shape == (240, 320) and tg.dtype == jg.dtype
        np.testing.assert_array_equal(jg, tg)
        np.testing.assert_array_equal(jd, td)
        for jp, tp in zip(jds.gt_pose_wc(i) + jds.gt_pose_cw(i),
                          tds.gt_pose_wc(i) + tds.gt_pose_cw(i)):
            np.testing.assert_array_equal(jp, tp)
    assert tio.SyntheticRGBD is tsyn.SyntheticRGBD


@pytest.mark.parametrize("trajectory", ["orbit", "loop"])
def test_synthetic_stereo_bit_for_bit(trajectory):
    n = 2
    jds = jsyn.SyntheticStereo(_small(jconfig), n_frames=n, seed=3,
                               trajectory=trajectory)
    tds = tio.SyntheticStereo(_small(tconfig), n_frames=n, seed=3,
                              trajectory=trajectory)
    for i in range(n):
        (jl, jr), (tl, tr) = jds[i], tds[i]
        assert tl.shape == tr.shape == (240, 320)
        np.testing.assert_array_equal(jl, tl)
        np.testing.assert_array_equal(jr, tr)
        assert not np.array_equal(tl, tr)
    ds, lefts, rights = tio.render_frames(_small(tconfig), n, workers=2,
                                          stereo=True, seed=3,
                                          trajectory=trajectory)
    assert isinstance(ds, tio.SyntheticStereo)
    for i in range(n):
        np.testing.assert_array_equal(lefts[i], jds[i][0])
        np.testing.assert_array_equal(rights[i], jds[i][1])


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rmse_agrees(with_scale):
    rng = np.random.default_rng(11)
    gt = np.cumsum(rng.normal(0, 0.05, (60, 3)), axis=0)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]])
    est = 1.3 * (gt @ R.T) + np.array([0.5, -1.0, 2.0]) \
        + rng.normal(0, 0.01, gt.shape)
    ja = jtraj.ate_rmse(est, gt, with_scale)
    ta = ttraj.ate_rmse(est, gt, with_scale)
    assert abs(ja - ta) <= 1e-12
    assert tio.ate_rmse is ttraj.ate_rmse
    for j, t in zip(jtraj.umeyama_align(est, gt, with_scale),
                    ttraj.umeyama_align(est, gt, with_scale)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    if with_scale:
        assert ta < 0.02        # the similarity is recovered


def test_brief_pattern_equals_the_reference():
    """The port's own copy of the 512 rBRIEF offsets (OpenCV's
    ``bit_pattern_31_``) against the array the reference's extractor loads:
    the same shape, type and every element; and the copy is the port's
    file, not the reference's."""
    ref = jextractor._brief_pattern()
    port = np.load(textractor._PATTERN_PATH)
    assert ref.shape == port.shape == (512, 2)
    assert ref.dtype == port.dtype
    np.testing.assert_array_equal(port, ref)
    assert os.path.dirname(textractor._PATTERN_PATH).startswith(
        os.path.dirname(textractor.__file__))
    assert not os.path.samefile(textractor._PATTERN_PATH,
                                jextractor._PATTERN_PATH)
    pat = textractor._brief_pattern("cpu")
    assert pat.dtype == torch.float32
    np.testing.assert_array_equal(pat.numpy(), ref.astype(np.float32))
