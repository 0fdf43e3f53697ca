"""The harness's tests. They import neither JAX nor the repository's
``tests/conftest.py``; those marked ``cuda`` skip without a card:

    python -m pytest -q slambench/tests                # CPU
    python -m pytest -q -m cuda slambench/tests        # on the card
"""

import dataclasses
import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SLAMBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(SLAMBENCH)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# an RGB-D cell of the ROS node's live path, one frame a call, which the
# tiny tree adds as files and entries only: it holds the harness's RGB-D,
# one-frame and session paths, which no cell of BENCHMARK.json runs yet
LIVE = {"trajectory": "loop", "trajectory_frames": 224, "frames": 112,
        "order": "sessions", "hand_in": 1, "warm_frames": 32,
        "reset_after_warm": True, "trace_frames": 24}
CELLS = ["rgbd.live_explore", "stereo.chunk_sweep"]


def tiny_tree(dest: str) -> str:
    """A copy of the harness under ``dest`` with its cells cut to a size
    the CPU runs in seconds (320 x 240, 800 features, small pools, short
    sessions), an RGB-D live cell added, and its own limits file per cell;
    returns the path of its BENCHMARK.json. Everything is found by the same
    file lookups as the real cells."""
    from orb_slam_2_ros_tpu_torch.config import (CameraConfig, MapConfig,
                                                 OrbConfig, SENSOR_RGBD,
                                                 SENSOR_STEREO, SlamConfig,
                                                 TrackingConfig)
    root = os.path.join(dest, "slambench")
    shutil.copytree(SLAMBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "configs", "stereo_ros.json")) as f:
        stereo = json.load(f)
    for name, sensor in (("rgbd_ros", SENSOR_RGBD),
                         ("stereo_ros", SENSOR_STEREO)):
        d = dict(stereo, name=name)
        d["slam_config"] = dataclasses.asdict(SlamConfig(
            sensor=sensor,
            camera=CameraConfig(width=320, height=240, fx=262.5, fy=262.5,
                                cx=159.5, cy=119.5, bf=20.0),
            orb=OrbConfig(n_features=800, max_kps=1024),
            map=MapConfig(max_kps=1024, max_mps=4096, max_kfs=64),
            tracking=TrackingConfig(min_init_stereo_kps=150)))
        with open(os.path.join(root, "configs", name + ".json"), "w") as f:
            json.dump(d, f)
    bench["configs"].append(dict(bench["configs"][0], name="rgbd_ros",
                                 file="slambench/configs/rgbd_ros.json"))
    bench["workloads"].append({"name": "rgbd.live_explore",
                               "config": "rgbd_ros",
                               "traffic": "live_explore", "chips": 1,
                               "why": "the live path"})
    with open(os.path.join(root, "traffic", "live_explore.json"), "w") as f:
        json.dump(LIVE, f)
    for t, frames, warm, trace in (("live_explore", 12, 6, 2),
                                   ("chunk_sweep", 64, 16, 16)):
        path = os.path.join(root, "traffic", t + ".json")
        with open(path) as f:
            d = json.load(f)
        d.update(frames=frames, warm_frames=warm, trace_frames=trace)
        if t == "chunk_sweep":
            d["hand_in"] = 8
        with open(path, "w") as f:
            json.dump(d, f)
    # the tiny cells' own limits: between their sound readings and the
    # faults' (the full-size limits hold the full-size cell); the RGB-D
    # cell's right coordinates come from its depth maps, rounded to 1 mm
    for cell in CELLS:
        limits = {"kp_mismatch": 0.02, "desc_bits": 0.02, "b1_wrong": 0,
                  "pose_dev_um": 100.0, "ur_err_px": 0.5}
        with open(os.path.join(root, "limits", cell + ".json"), "w") as f:
            json.dump(limits, f)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path
