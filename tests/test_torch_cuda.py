"""Card-only checks of the PyTorch port; they skip without a CUDA device.

This file imports neither JAX nor the JAX package's tests, so it runs on
the card's machine, which has no JAX (tests/conftest.py imports it, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_case
from orb_slam_2_ros_tpu_torch.config import (CameraConfig, MapConfig,
                                             OrbConfig, SENSOR_RGBD,
                                             SlamConfig, TrackingConfig)
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD
from orb_slam_2_ros_tpu_torch.ops import match_kernel
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(256, 640), (1536, 1536), (4096, 1536)])
def test_cuda_masked_best_two_matches_plain(cuda, shape):
    args = [torch.from_numpy(x).to(cuda) for x in make_case(*shape, seed=3)]
    before = match_kernel.LAUNCHES
    got = match_kernel.masked_best_two(*args)
    assert match_kernel.LAUNCHES == before + 1
    want = match_kernel.masked_best_two_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_tracker_matches_cpu(cuda):
    """The slice on the card against the same slice on the CPU: same
    states, inliers within 5%, camera centres within 5 mm (float sums run
    in another order on the card)."""
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    cfg = SlamConfig(
        sensor=SENSOR_RGBD, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640,
                      local_map_cap=1024),
        tracking=TrackingConfig(min_init_stereo_kps=200))
    ds = SyntheticRGBD(cfg, n_frames=8, seed=0)
    grays = np.stack([ds[i][0] for i in range(8)])
    depths = np.stack([ds[i][1] for i in range(8)])
    recs = {}
    for dev in ("cpu", cuda):
        before = match_kernel.LAUNCHES
        recs[str(dev)] = Tracker(cfg, device=dev).process_chunk(
            grays, depths, ds.timestamps)
        launches = match_kernel.LAUNCHES - before
        assert launches == (0 if dev == "cpu" else 4 * 8)
    cpu, gpu = recs["cpu"], recs["cuda"]
    assert [r.state for r in gpu] == [r.state for r in cpu] == [OK] * 8
    for c, g in zip(cpu, gpu):
        assert abs(g.n_inliers - c.n_inliers) <= 0.05 * c.n_inliers
    np.testing.assert_allclose(np.stack([r.c_w for r in gpu]),
                               np.stack([r.c_w for r in cpu]), atol=5e-3)
