"""The PyTorch renderer against the frozen numpy copy of the port's."""

import numpy as np
import pytest

from slambench.scene import frozen_np
from slambench.scene import render as scene

CAM = scene.Camera(640, 480, 525.0, 525.0, 319.5, 239.5, 40.0)


def test_textures_equal_the_frozen_room():
    planes = scene.make_room(987654321012, "cpu")
    ref = frozen_np.make_room(987654321012)
    assert len(planes) == len(ref) == 6
    for p, r in zip(planes, ref):
        assert np.array_equal(p.tex.numpy(), r.tex)
        assert np.array_equal(p.origin.numpy(), r.origin)


@pytest.mark.parametrize("traj,n,i", [("loop", 224, 0), ("loop", 224, 57),
                                      ("loop", 224, 111), ("orbit", 64, 0),
                                      ("orbit", 64, 40)])
def test_render_matches_frozen_numpy(traj, n, i):
    R_wc, c_w = frozen_np.TRAJECTORIES[traj](n)[i]
    gray, depth = scene.render(scene.make_room(3, "cpu"), R_wc, c_w, CAM)
    g_ref, d_ref = frozen_np.render(frozen_np.make_room(3), R_wc, c_w,
                                    CAM.width, CAM.height, CAM.fx, CAM.fy,
                                    CAM.cx, CAM.cy)
    diff = np.abs(gray.numpy() - g_ref)
    # the same float32 operations but for the order of the ray's dot
    # products: a pixel on a rounding edge may move by one grey level
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 1e-3
    assert np.abs(depth.numpy() - d_ref).max() < 1e-4


def test_wire_sequence_formats():
    cam = scene.Camera(64, 48, 52.5, 52.5, 31.5, 23.5, 4.0)
    planes = scene.make_room(1, "cpu")
    poses = frozen_np.orbit_trajectory(4)
    g, d = scene.wire_sequence(planes, poses, cam, stereo=False)
    assert g.dtype == np.uint8 and d.dtype == np.uint16
    assert g.shape == d.shape == (4, 48, 64)
    gray, depth = scene.render(planes, *poses[2], cam)
    assert np.array_equal(g[2], gray.numpy().astype(np.uint8))
    assert np.array_equal(d[2], np.clip(np.round(depth.numpy() * 1e3), 0,
                                        65535).astype(np.uint16))
    gl, gr = scene.wire_sequence(planes, poses, cam, stereo=True)
    assert gl.dtype == gr.dtype == np.uint8
    assert np.array_equal(gl, g)
    assert not np.array_equal(gl, gr)


def test_any_whole_seed():
    assert scene.seed_to_rng_seed(-1) == (1 << 64) - 1
    assert scene.seed_to_rng_seed(2 ** 31 + 5) == 2 ** 31 + 5
    scene.make_room(-7, "cpu")
