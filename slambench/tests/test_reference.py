"""The plain references against the port's own plain code on the CPU, and
their controls against them."""

import numpy as np
import pytest
import torch

from slambench import check
from slambench.reference import b1, orb, poses
from slambench.scene import frozen_np
from slambench.scene import render as scene


@pytest.fixture(scope="module")
def image():
    cam = scene.Camera(320, 240, 262.5, 262.5, 159.5, 119.5, 20.0)
    R_wc, c_w = frozen_np.loop_trajectory(224)[30]
    gray, _ = scene.render(scene.make_room(7, "cpu"), R_wc, c_w, cam)
    return gray


def _np(k):
    return k.xy.numpy(), k.octave.numpy(), k.desc.numpy()


def test_orb_reference_equals_the_port_and_bf16_does_not(image):
    from orb_slam_2_ros_tpu_torch.config import OrbConfig
    from orb_slam_2_ros_tpu_torch.frontend import extractor
    p = orb.Params(n_features=800)
    port = extractor.extract(image, OrbConfig(n_features=800, max_kps=1024))
    v = port.valid
    ref = orb.extract(image, p)
    lack, total, bits, both = check.compare_keypoints(
        port.xy[v].numpy(), port.octave[v].numpy(), port.desc[v].numpy(),
        *_np(ref))
    assert total > 1000 and lack == 0 and bits == 0
    low = orb.extract(image, p, dtype=torch.bfloat16)
    lack, total, bits, both = check.compare_keypoints(*_np(low), *_np(ref))
    assert lack / total > 0.05 and bits / (256 * both) > 0.01


@pytest.mark.parametrize("shape,gates", [((300, 200), "random"),
                                         ((64, 500), "random"),
                                         ((200, 50), "closed"),
                                         ((64, 300), "open")])
def test_b1_reference_equals_the_port_plain_version(shape, gates):
    from orb_slam_2_ros_tpu_torch.bench_match_kernel import make_case
    from orb_slam_2_ros_tpu_torch.ops import match_kernel
    args = [torch.from_numpy(x) for x in make_case(*shape, seed=5,
                                                   gates=gates)]
    want = match_kernel.masked_best_two_reference(*args)
    got = b1.best_two(*args)
    assert b1.wrong_entries(got, want) == 0
    if gates != "closed":
        assert b1.wrong_entries(b1.best_two(*args, fp8=True), want) > 0
        assert b1.work(args)["passes"] == int(
            match_kernel.gate_mask(args[1], args[3]).sum())


def test_relative_errors_and_the_bf16_control():
    gt = frozen_np.loop_trajectory(224)[:20]
    t, r = poses.relative_errors(gt, gt)
    assert max(t) == 0 and max(r) < 1e-7
    low = [(poses.to_bf16(R), poses.to_bf16(c)) for R, c in gt]
    t, r = poses.relative_errors(low, gt)
    assert 1e-3 < poses.rms(t) < 1e-2 and 1e-4 < poses.rms(r) < 1e-2
    frozen = [gt[0]] * len(gt)
    t, _ = poses.relative_errors(frozen, gt)
    assert poses.rms(t) > 0.03


def test_points_on_the_walls_read_zero_and_bf16_does_not():
    R_wc, c_w = frozen_np.loop_trajectory(224)[40]
    rng = np.random.default_rng(0)
    d = rng.normal(size=(500, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1)[:, None]
    dist = poses.wall_distance(c_w, d @ np.asarray(R_wc, np.float64).T)
    p_cam = d * dist[:, None]
    assert np.abs(poses.point_ray_errors(p_cam, R_wc, c_w)).max() < 1e-9
    low = poses.control_points_cam(p_cam, R_wc, c_w)
    assert np.median(np.abs(poses.point_ray_errors(low, R_wc, c_w))) > 1e-3
