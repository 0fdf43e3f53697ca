"""The port's dataset loaders (``io/datasets.py``), rectification
(``geometry/rectify.py``) and camera presets (``presets.py``) against the
reference's, on the same inputs.

The cases of ``tests/test_datasets.py`` and ``tests/test_rectify.py`` run
on both packages. Tolerances: every frame, timestamp, calibration value,
rectification matrix, remap table and remapped image equal (both are the
same numpy or integer code over the same files); the presets equal field
by field; the property checks of ``tests/test_rectify.py`` keep that file's
bounds. Frames are written with OpenCV and PIL, which the port itself never
imports.

The reference's loaders decode depth natively when its library loads
(rounded to millimetres, then scaled by 1e-3) and with OpenCV otherwise
(divided by the factor): the two differ by up to 4e-4 m. The port decodes as
the native path does, so the comparisons hold it against the reference's
native decode whatever the reference's lazy build gave this worker: where
``native.load()`` cached ``None`` (a half-written library seen while another
process built it), ``reference_native`` builds the reference's sources with
its own Makefile into a private directory and loads that.
"""

import contextlib
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu import native as jnative
from orb_slam_2_ros_tpu import presets as jpresets
from orb_slam_2_ros_tpu.config import SENSOR_MONOCULAR, SENSOR_RGBD, SENSOR_STEREO
from orb_slam_2_ros_tpu.geometry import rectify as jrect
from orb_slam_2_ros_tpu.io import datasets as jds
from orb_slam_2_ros_tpu_torch import presets as tpresets
from orb_slam_2_ros_tpu_torch.geometry import rectify as trect
from orb_slam_2_ros_tpu_torch.io import datasets as tds

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

MINI_TUM = os.path.join(os.path.dirname(__file__), "data", "mini_tum")
EUROC_YAML = """%YAML:1.0
sensor_type: camera
T_BS:
  cols: 4
  rows: 4
  data: [{r00}, -0.99, 0.0, {tx},
         0.99, {r00}, 0.0, -0.06,
         0.0, 0.0, 1.0, 0.01,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [64, 48]
camera_model: pinhole
intrinsics: [{fx}, 45.7, 31.7, 24.8]
distortion_model: radial-tangential
distortion_coefficients: [-0.2834, 0.0739, 0.00019, 1.76e-05]
"""


@contextlib.contextmanager
def native_reference(build_dir):
    """The reference's native library loaded for the duration: as its lazy
    build left it if that loaded, else built afresh from its sources into
    ``build_dir``. Only this module's state is patched, and restored."""
    with pytest.MonkeyPatch.context() as mp:
        if jnative.load() is None:
            for name in ("Makefile", "vocab_loader.cc", "dataset_loader.cc"):
                shutil.copy(os.path.join(jnative._DIR, name), build_dir)
            out = subprocess.run(["make", "-C", str(build_dir), "-s"],
                                 capture_output=True, text=True, timeout=300)
            assert out.returncode == 0, out.stderr
            mp.setattr(jnative, "_SO",
                       os.path.join(str(build_dir), "libslamnative.so"))
            mp.setattr(jnative, "_tried", False)
            mp.setattr(jnative, "_lib", None)
            assert jnative.load() is not None
        yield jnative.load()


@pytest.fixture
def reference_native(tmp_path_factory):
    with native_reference(tmp_path_factory.mktemp("ref_native")) as lib:
        yield lib


def _png(path, value, size=(32, 24), depth16=False):
    img = np.full((size[1], size[0]), value,
                  np.uint16 if depth16 else np.uint8)
    cv2.imwrite(path, img)


def _equal_frames(a, b):
    assert len(a) == len(b)
    assert list(a.timestamps) == list(b.timestamps)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_associate_like_the_reference():
    a = np.array([0.0, 1.0, 2.0, 3.0])
    b = np.array([0.01, 1.5, 2.005, 2.995, 10.0])
    assert tds.associate(a, b, max_dt=0.02) == jds.associate(a, b, 0.02) \
        == [(0, 0), (2, 2), (3, 3)]
    rng = np.random.default_rng(0)
    ta = np.sort(rng.uniform(0, 10, 200))
    tb = np.sort(rng.uniform(0, 10, 230))
    assert tds.associate(ta, tb) == jds.associate(ta, tb)


def test_tum_loader_like_the_reference(tmp_path, reference_native):
    root = str(tmp_path)
    os.makedirs(f"{root}/rgb")
    os.makedirs(f"{root}/depth")
    with open(f"{root}/rgb.txt", "w") as fr, \
            open(f"{root}/depth.txt", "w") as fd:
        fr.write("# comment\n")
        fd.write("# comment\n")
        for i in range(3):
            t = 100.0 + i * 0.033
            _png(f"{root}/rgb/{t:.6f}.png", 50 + i)
            _png(f"{root}/depth/{t + 0.01:.6f}.png", 5000 * (i + 1),
                 depth16=True)
            fr.write(f"{t:.6f} rgb/{t:.6f}.png\n")
            fd.write(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png\n")
    ds = tds.TumRGBD(root)
    _equal_frames(ds, jds.TumRGBD(root))
    gray, depth = ds[1]
    assert gray.shape == (24, 32) and gray.dtype == np.float32
    assert abs(float(gray[0, 0]) - 51.0) < 1e-6
    assert abs(float(depth[0, 0]) - 2.0) < 1e-6


def test_kitti_loader_like_the_reference(tmp_path):
    root = str(tmp_path)
    os.makedirs(f"{root}/image_0")
    os.makedirs(f"{root}/image_1")
    with open(f"{root}/times.txt", "w") as f:
        for i in range(2):
            f.write(f"{i * 0.1:.6f}\n")
            _png(f"{root}/image_0/{i:06d}.png", 10 + i)
            _png(f"{root}/image_1/{i:06d}.png", 20 + i)
    ds = tds.KittiOdometry(root)
    _equal_frames(ds, jds.KittiOdometry(root))
    left, right = ds[1]
    assert abs(float(left[0, 0]) - 11.0) < 1e-6
    assert abs(float(right[0, 0]) - 21.0) < 1e-6


def _euroc_dir(root, with_yaml):
    rng = np.random.default_rng(1)
    for k, cam in enumerate(("cam0", "cam1")):
        os.makedirs(f"{root}/mav0/{cam}/data")
        if with_yaml:
            with open(f"{root}/mav0/{cam}/sensor.yaml", "w") as f:
                f.write(EUROC_YAML.format(r00=0.01 + 0.002 * k,
                                          tx=-0.02 + 0.11 * k,
                                          fx=45.8 - 0.1 * k))
        with open(f"{root}/mav0/{cam}/data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i in range(2):
                ns = 1000000000 * (i + 1)
                name = f"{ns}.png"
                img = (rng.integers(0, 256, (48, 64), np.uint8) if with_yaml
                       else np.full((24, 32), (30 if k == 0 else 40) + i,
                                    np.uint8))
                cv2.imwrite(f"{root}/mav0/{cam}/data/{name}", img)
                f.write(f"{ns},{name}\n")


@pytest.mark.parametrize("with_yaml", [False, True])
def test_euroc_loader_like_the_reference(tmp_path, with_yaml):
    """Without ``sensor.yaml`` the frames pass through; with it both
    packages rectify every pair with the same tables and report the same
    rectified intrinsics."""
    root = str(tmp_path)
    _euroc_dir(root, with_yaml)
    ds, ref = tds.EurocMav(root), jds.EurocMav(root)
    _equal_frames(ds, ref)
    assert ds.calibration() == ref.calibration()
    if with_yaml:
        assert ds.calibration() is not None and ds.wire_paths() is None
        assert tds.make_prefetcher(ds) is None
    else:
        l, r = ds[0]
        assert abs(float(l[0, 0]) - 30.0) < 1e-6
        assert abs(float(r[0, 0]) - 40.0) < 1e-6
        assert abs(ds.timestamps[0] - 1.0) < 1e-9


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
@pytest.mark.parametrize("sensor", [None, SENSOR_MONOCULAR, SENSOR_STEREO,
                                    SENSOR_RGBD])
def test_presets_field_by_field(name, sensor):
    want = dataclasses.asdict(jpresets.get(name, sensor))
    got = dataclasses.asdict(tpresets.get(name, sensor))
    assert got == want


def test_presets_cover_the_launch_files():
    """``tests/test_datasets.py``'s preset case, on the port."""
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    zed = tpresets.get("zed2")
    assert zed.sensor == SENSOR_STEREO
    assert abs(zed.camera.fx - 527.43) < 1e-9
    assert abs(zed.camera.bf - 63.2916) < 1e-9
    r200_st = tpresets.get("r200", SENSOR_STEREO)
    assert abs(r200_st.camera.bf - 30.464328718) < 1e-9
    d435 = tpresets.get("d435")
    assert abs(d435.camera.bf - 9.052) < 1e-9
    assert d435.orb.n_features == 1000
    with pytest.raises(KeyError):
        tpresets.get("nope")


def test_kitti_calibration_like_the_reference(tmp_path):
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    (seq / "times.txt").write_text("0.0\n0.1\n")
    img = np.zeros((376, 1241), np.uint8)
    for d in ("image_0", "image_1"):
        for i in range(2):
            cv2.imwrite(str(seq / d / f"{i:06d}.png"), img)
    fx, cx, cy, base = 718.856, 607.1928, 185.2157, 0.5371657
    (seq / "calib.txt").write_text(
        f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n"
        f"P1: {fx} 0 {cx} {-fx * base} 0 {fx} {cy} 0 0 0 1 0\n")
    cal = tds.KittiOdometry(str(seq)).calibration()
    assert cal == jds.KittiOdometry(str(seq)).calibration()
    assert abs(cal["bf"] - fx * base) < 1e-3
    assert cal["width"] == 1241 and cal["height"] == 376


def test_mini_tum_like_the_reference(reference_native):
    """The checked-in sequence through both loaders, and the prefetcher's
    wire-format frames against the indexed float frames."""
    ds = tds.TumRGBD(MINI_TUM)
    _equal_frames(ds, jds.TumRGBD(MINI_TUM))
    gt_t = ds.gt_trajectory()
    gt_j = jds.TumRGBD(MINI_TUM).gt_trajectory()
    np.testing.assert_array_equal(gt_t[0], gt_j[0])
    pf = tds.make_prefetcher(ds)
    for i, (g8, mm) in enumerate(pf):
        gray, depth = ds[i]
        assert g8.dtype == np.uint8 and mm.dtype == np.uint16
        np.testing.assert_array_equal(g8.astype(np.float32), gray)
        np.testing.assert_array_equal(
            np.where(mm == 0, -1.0, mm.astype(np.float32) * 1e-3)
            .astype(np.float32), depth)
    assert i == len(ds) - 1
    pf.close()


@pytest.mark.parametrize("case", ["tum_loader", "mini_tum"])
def test_reference_comparisons_survive_a_lost_native_build(
        case, tmp_path, tmp_path_factory, monkeypatch):
    """A worker whose ``native.load()`` cached ``None``, as one that saw
    another process's half-written library does: the reference falls back
    to OpenCV and the comparison fails; with ``native_reference`` it holds,
    and the worker's cached state comes back as it was."""
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    run = {"tum_loader": lambda: test_tum_loader_like_the_reference(
               tmp_path / "a", None),
           "mini_tum": lambda: test_mini_tum_like_the_reference(None)}[case]
    os.makedirs(tmp_path / "a")
    with pytest.raises(AssertionError, match="Max absolute difference"):
        run()
    shutil.rmtree(tmp_path / "a")
    os.makedirs(tmp_path / "a")
    with native_reference(tmp_path_factory.mktemp("ref_native")) as lib:
        assert lib is not None
        run()
    assert jnative._tried and jnative._lib is None


def _rig():
    K0 = np.array([[458.6, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1.0]])
    K1 = np.array([[457.6, 0, 379.0], [0, 456.1, 255.2], [0, 0, 1.0]])
    D0 = np.array([-0.2834, 0.0739, 0.0002, 1.76e-5])
    D1 = np.array([-0.2837, 0.0745, -0.0001, -3.55e-5, 0.001])
    R = jrect.rodrigues(np.array([0.003, -0.007, 0.002]))
    t = -R @ np.array([0.110, 0.0004, -0.0008])
    return K0, D0, K1, D1, R, t


def test_rectify_functions_like_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(10):
        r = rng.normal(0, 1, 3)
        np.testing.assert_array_equal(trect.rodrigues(r), jrect.rodrigues(r))
        R = jrect.rodrigues(r)
        np.testing.assert_array_equal(trect.log_so3(R), jrect.log_so3(R))
    np.testing.assert_array_equal(trect.rodrigues(np.zeros(3)), np.eye(3))
    K0, D0, K1, D1, R, t = _rig()
    xn = rng.normal(0, 0.4, (50, 2))
    for D in (D0, D1):
        np.testing.assert_array_equal(trect.distort_radtan(xn, D),
                                      jrect.distort_radtan(xn, D))
    size = (96, 64)
    got = trect.stereo_rectify(K0, D0, K1, D1, R, t, size)
    want = jrect.stereo_rectify(K0, D0, K1, D1, R, t, size)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    R0, R1, Kn, b = got
    for Rr, K, D in ((R0, K0, D0), (R1, K1, D1)):
        mt = trect.build_rectify_map(Kn, Rr, K, D, size)
        np.testing.assert_array_equal(
            mt, jrect.build_rectify_map(Kn, Rr, K, D, size))
        img = rng.uniform(0, 255, (64, 96)).astype(np.float32)
        np.testing.assert_array_equal(trect.remap_bilinear(img, mt),
                                      jrect.remap_bilinear(img, mt))


def test_rectified_rows_align_and_disparity_exact():
    """``tests/test_rectify.py``'s geometry check, on the port."""
    K0, D0, K1, D1, R, t = _rig()
    R0, R1, Kn, b = trect.stereo_rectify(K0, D0, K1, D1[:4], R, t, (752, 480))
    np.testing.assert_allclose(b, 0.110, atol=1e-4)
    rng = np.random.default_rng(1)
    pts0 = np.stack([rng.uniform(-1.5, 1.5, 200), rng.uniform(-1.0, 1.0, 200),
                     rng.uniform(2.0, 8.0, 200)], -1)
    xr0 = pts0 @ R0.T
    xr1 = (pts0 @ R.T + t) @ R1.T
    v0 = Kn[1, 1] * xr0[:, 1] / xr0[:, 2] + Kn[1, 2]
    v1 = Kn[1, 1] * xr1[:, 1] / xr1[:, 2] + Kn[1, 2]
    u0 = Kn[0, 0] * xr0[:, 0] / xr0[:, 2] + Kn[0, 2]
    u1 = Kn[0, 0] * xr1[:, 0] / xr1[:, 2] + Kn[0, 2]
    np.testing.assert_allclose(v1, v0, atol=1e-6)
    np.testing.assert_allclose(u0 - u1, Kn[0, 0] * b / xr0[:, 2], atol=1e-6)


def test_remap_bilinear_identity_and_shift():
    """``tests/test_rectify.py``'s remap check, on the port."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    u, v = np.meshgrid(np.arange(64, dtype=np.float32),
                       np.arange(48, dtype=np.float32))
    ident = np.stack([u, v], -1)
    np.testing.assert_allclose(trect.remap_bilinear(img, ident)[:-1, :-1],
                               img[:-1, :-1], atol=1e-4)
    out = trect.remap_bilinear(img, ident + np.array([0.5, 0.0], np.float32))
    np.testing.assert_allclose(out[:-1, :-2],
                               0.5 * (img[:-1, :-2] + img[:-1, 1:-1]),
                               atol=1e-3)


def test_euroc_yaml_parse_like_the_reference(tmp_path):
    y = tmp_path / "sensor.yaml"
    y.write_text(EUROC_YAML.format(r00=0.01, tx=-0.02, fx=458.654))
    got = tds._parse_euroc_yaml(str(y))
    want = jds._parse_euroc_yaml(str(y))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["T_BS"].shape == (4, 4)
    assert len(got["distortion_coefficients"]) == 4
