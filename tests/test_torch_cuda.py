"""Card-only checks of the PyTorch port; they skip without a CUDA device.

This file imports neither JAX nor the JAX package's tests, so it runs on
the card's machine, which has no JAX (tests/conftest.py imports it, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import EDGE_CASES
from orb_slam_2_ros_tpu_torch.bench_match_kernel import (assert_equal,
                                                        make_case)
from orb_slam_2_ros_tpu_torch.config import (CameraConfig, MapConfig,
                                             OrbConfig, SENSOR_RGBD,
                                             SlamConfig, TrackingConfig)
from orb_slam_2_ros_tpu_torch import kernel_timing
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD
from orb_slam_2_ros_tpu_torch.map.state import MapState
from orb_slam_2_ros_tpu_torch.ops import match_kernel
from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker


pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_masked_best_two_edge_cases(cuda, case):
    """Ragged shapes (no multiple of any tile), M = 1, the largest M, no
    column passing, every gate open: all four outputs equal the plain
    version's."""
    N, M, gates = case
    args = [torch.from_numpy(x).to(cuda)
            for x in make_case(N, M, seed=4, gates=gates)]
    got = match_kernel.masked_best_two(*args)
    want = match_kernel.masked_best_two_reference(*args)
    assert assert_equal(got, want, f"{N}x{M} {gates}") == 0
    assert got[0]._base is not None and got[0]._base.shape == (4, N)
    has = int((want[1] < 1024).sum())
    assert has == {"closed": 0, "open": N}.get(gates, has)


def test_cuda_tracker_defaults_to_the_card(cuda):
    assert Tracker(SlamConfig()).device.type == "cuda"


def small_cfg():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    return SlamConfig(
        sensor=SENSOR_RGBD, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640,
                      local_map_cap=1024),
        tracking=TrackingConfig(min_init_stereo_kps=200))


def test_cuda_tracker_matches_cpu(cuda):
    """The slice on the card against the same slice on the CPU: same
    states, inliers within 5%, camera centres within 5 mm (float sums run
    in another order on the card)."""
    cfg = small_cfg()
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


def test_cuda_system_defaults_to_the_card(cuda):
    system = System(SlamConfig(), enable_loop_closing=False)
    assert system.device.type == "cuda"
    assert all(v.is_cuda for v in system.tracker.map._asdict().values())


def test_cuda_mapping_step_matches_cpu(cuda):
    """One mapping step from one map, on the CPU and on the card. The map is
    built on the CPU (40 frames: 3 keyframes). The step's 8 fusion calls
    launch the matcher kernel, and each equals its plain version on the
    call's own arguments. Integer outputs: the same keyframe count, spawned
    and fused counts; culled points and the live count within 1%; the
    observation table and the remapped associations equal on >= 98% of
    their entries (the BA's float sums run in another order on the card, so
    an edge at the chi2 gate can fall the other way)."""
    cfg = small_cfg()
    n = 40
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0)
    tracker = Tracker(cfg, device="cpu")
    tracker.process_chunk(np.stack([ds[i][0] for i in range(n)]),
                          np.stack([ds[i][1] for i in range(n)]),
                          ds.timestamps)
    m_cpu, last_cpu = tracker.carry.m, tracker.carry.last_mp
    assert int(m_cpu.n_kfs) >= 3

    out = {}
    for dev in ("cpu", "cuda"):
        m = MapState(*(v.to(dev) for v in m_cpu))
        mapper = LocalMapper(cfg, window=8)
        before = match_kernel.LAUNCHES
        with kernel_timing.capture_calls(matcher, "masked_best_two") as calls:
            m2, n_culled, last2 = mapper.run(m, last_cpu.to(dev))
        assert len(calls) == 8
        assert match_kernel.LAUNCHES - before == (8 if dev == "cuda" else 0)
        if dev == "cuda":
            assert all(v.is_cuda for v in m2._asdict().values())
            for args in calls:
                got = match_kernel.masked_best_two_cuda(*args)
                want = match_kernel.masked_best_two_reference(*args)
                assert assert_equal(got, want, "fusion call") == 0
        step = mapper.last_step
        out[dev] = dict(
            n_kfs=int(m2.n_kfs), n_mps=int(m2.n_mps), n_culled=int(n_culled),
            n_spawned=int(step["n_spawned"]), n_fused=int(step["n_fused"]),
            kf_mp=m2.kf_mp.cpu().numpy(), last=last2.cpu().numpy(),
            valid=int(m2.mp_valid.sum()))
    cpu, gpu = out["cpu"], out["cuda"]
    for key in ("n_kfs", "n_spawned", "n_fused"):
        assert gpu[key] == cpu[key], key
    for key in ("n_mps", "n_culled"):
        assert abs(gpu[key] - cpu[key]) <= 0.01 * cpu[key], key
    assert gpu["n_mps"] == gpu["valid"] and cpu["n_culled"] > 0
    assert (gpu["kf_mp"] == cpu["kf_mp"]).mean() >= 0.98
    assert (gpu["last"] == cpu["last"]).mean() >= 0.98
