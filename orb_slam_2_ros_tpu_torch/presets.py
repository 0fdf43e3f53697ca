"""Per-camera configuration presets.

The reference ships one launch file per supported camera
(``ros/launch/*.launch``): topic remaps, the ORB operating point, the
intrinsics, distortion and baseline. Datasets replace the topics; the rest
goes into ``SlamConfig`` as the launch parameters go into
``ORBParameters`` (``ros/src/Node.cc:318-379``). Each preset carries the
calibration of its launch file (cited per function); ``PRESETS`` maps the
CLI's ``--preset`` name to its factory.

The port's own copy of ``orb_slam_2_ros_tpu/presets.py``, built on the
port's ``config.py``; ``tests/test_torch_datasets.py`` holds every preset
to the reference's field by field.
"""

from __future__ import annotations

import dataclasses

from orb_slam_2_ros_tpu_torch.config import (CameraConfig, SENSOR_RGBD,
                                             SENSOR_STEREO, SlamConfig)


def _cfg(sensor, cam, n_features=1200, **kw) -> SlamConfig:
    base = SlamConfig(sensor=sensor, camera=cam)
    orb = dataclasses.replace(base.orb, n_features=n_features)
    return dataclasses.replace(base, orb=orb, **kw)


def tum1(sensor: int = SENSOR_RGBD) -> SlamConfig:
    """TUM freiburg1 (fr1/xyz, fr1/desk — the ATE benchmark sequences)."""
    cam = CameraConfig(
        width=640, height=480,
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        bf=40.0, th_depth=40.0, depth_map_factor=5000.0)
    return _cfg(sensor, cam, n_features=1000)


def tum2(sensor: int = SENSOR_RGBD) -> SlamConfig:
    """TUM freiburg2 (``orb_slam2/config/TUM2.yaml``, used by the tum2
    rosbag launch ``ros/launch/orb_slam2_tum2_rgbd.launch``)."""
    cam = CameraConfig(
        width=640, height=480, fx=535.4, fy=539.2, cx=320.1, cy=247.6,
        bf=40.0, th_depth=40.0, depth_map_factor=5000.0)
    return _cfg(sensor, cam, n_features=1000)


def tum3(sensor: int = SENSOR_RGBD) -> SlamConfig:
    """TUM freiburg3 (standard TUM3 calibration, distortion-free)."""
    cam = CameraConfig(
        width=640, height=480, fx=535.4, fy=539.2, cx=320.1, cy=247.6,
        bf=40.0, th_depth=40.0, depth_map_factor=5000.0)
    return _cfg(sensor, cam, n_features=1000)


def kitti(sensor: int = SENSOR_STEREO, seq: str = "00") -> SlamConfig:
    """KITTI odometry grayscale (sequences 00-02 calibration; the KITTI
    loader in io/datasets.py overrides intrinsics from calib.txt when a
    real sequence directory is given)."""
    cam = CameraConfig(
        width=1241, height=376,
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        bf=386.1448, th_depth=35.0, depth_map_factor=1.0)
    c = _cfg(sensor, cam, n_features=2000)
    orb = dataclasses.replace(c.orb, max_kps=2048)
    mp = dataclasses.replace(c.map, max_kps=2048)
    return dataclasses.replace(c, orb=orb, map=mp)


def euroc(sensor: int = SENSOR_STEREO) -> SlamConfig:
    """EuRoC MAV cam0 (MH01-05, V1-V2)."""
    cam = CameraConfig(
        width=752, height=480,
        fx=435.2046959714599, fy=435.2046959714599,
        cx=367.4517211914062, cy=252.2008514404297,
        bf=47.90639384423901, th_depth=35.0, depth_map_factor=1.0)
    return _cfg(sensor, cam, n_features=1200)


def realsense_r200(sensor: int = SENSOR_RGBD) -> SlamConfig:
    """Intel RealSense R200 (``ros/launch/orb_slam2_r200_rgbd.launch:41-53``;
    the stereo launch shares intrinsics with baseline 30.46, mono drops the
    depth channel)."""
    cam = CameraConfig(
        width=640, height=480,
        fx=632.7927856445312, fy=626.8605346679688,
        cx=311.43603515625, cy=248.0950164794922,
        k1=-0.09097914397716522, k2=0.06503549218177795,
        p1=0.000849052332341671, p2=0.001785792293958366,
        bf=37.2925 if sensor == SENSOR_RGBD else 30.464328718,
        th_depth=40.0, depth_map_factor=1.0)
    n = 1000 if sensor == SENSOR_RGBD else 1200
    return _cfg(sensor, cam, n_features=n)


def realsense_d435(sensor: int = SENSOR_RGBD) -> SlamConfig:
    """Intel RealSense D435 (``ros/launch/orb_slam2_d435_rgbd.launch:42-52``)."""
    cam = CameraConfig(
        width=640, height=480,
        fx=615.6707153320312, fy=615.962158203125,
        cx=328.0010681152344, cy=241.31031799316406,
        bf=9.052, th_depth=40.0, depth_map_factor=1.0)
    return _cfg(sensor, cam, n_features=1000)


def mynteye_s(sensor: int = SENSOR_STEREO) -> SlamConfig:
    """MYNT EYE S (``ros/launch/orb_slam2_mynteye_s_stereo.launch:44-56``)."""
    cam = CameraConfig(
        width=752, height=480,
        fx=332.97713134460906, fy=332.97713134460906,
        cx=398.9270935058594, cy=252.28187370300293,
        bf=47.90639384423901, th_depth=35.0, depth_map_factor=1.0)
    return _cfg(sensor, cam, n_features=1200)


def zed2(sensor: int = SENSOR_STEREO) -> SlamConfig:
    """Stereolabs ZED 2 (``ros/launch/orb_slam2_zed2_stereo.launch:56-69``)."""
    cam = CameraConfig(
        width=1280, height=720,
        fx=527.43, fy=527.185, cx=628.97, cy=355.755,
        bf=63.2916, th_depth=40.0, depth_map_factor=1.0)
    return _cfg(sensor, cam, n_features=1200)


PRESETS = {
    "tum1": tum1,
    "tum2": tum2,
    "tum3": tum3,
    "kitti": kitti,
    "euroc": euroc,
    "r200": realsense_r200,
    "d435": realsense_d435,
    "mynteye": mynteye_s,
    "zed2": zed2,
}


def get(name: str, sensor: int = None) -> SlamConfig:
    """Look up a preset by name, optionally overriding the sensor
    (``--preset`` CLI flag; ≙ choosing a launch file)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    fn = PRESETS[name]
    return fn(sensor) if sensor is not None else fn()
