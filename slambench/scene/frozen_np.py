"""Frozen copy of the port's synthetic scene, kept so that the yardstick
cannot move with the program.

Copied from ``orb_slam_2_ros_tpu_torch/io/synthetic.py`` at commit
``b77b5cd74ef9125f0ac89662d885404aa9a6b150``: ``Plane``, ``_make_texture``,
``make_room``, ``render``, ``orbit_trajectory`` and ``loop_trajectory``,
unchanged but for ``render`` taking the camera's sizes as arguments instead
of the port's ``CameraConfig``. The harness draws its textures and
trajectories from here, and ``tests/test_scene.py`` holds the PyTorch
renderer (``render.py``) to ``render``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Plane:
    origin: np.ndarray   # (3,) a corner point
    eu: np.ndarray       # (3,) edge vector (texture u axis, full extent)
    ev: np.ndarray       # (3,) edge vector (texture v axis)
    tex: np.ndarray      # (Th, Tw) float32 texture


def _make_texture(rng, size=768, octaves=(3, 9, 27, 81)):
    """Multi-scale value noise: corners at every scale for FAST to latch on."""
    tex = np.zeros((size, size), np.float32)
    for i, cells in enumerate(octaves):
        coarse = rng.uniform(0, 1, (cells, cells)).astype(np.float32)
        reps = int(np.ceil(size / cells))
        up = np.kron(coarse, np.ones((reps, reps), np.float32))[:size, :size]
        tex += up * (0.6 ** i)
    tex -= tex.min()
    tex /= tex.max()
    return 20.0 + 215.0 * tex


def make_room(seed: int = 0, half: float = 3.0) -> List[Plane]:
    """A 6-plane box room of side 2*half metres centred at the origin."""
    rng = np.random.default_rng(seed)
    h = half
    planes = []

    def P(origin, eu, ev):
        planes.append(Plane(np.array(origin, np.float32), np.array(eu, np.float32),
                            np.array(ev, np.float32), _make_texture(rng)))

    P([-h, -h, -h], [2 * h, 0, 0], [0, 2 * h, 0])   # back wall  z=-h
    P([-h, -h, h], [2 * h, 0, 0], [0, 2 * h, 0])    # front wall z=+h
    P([-h, -h, -h], [0, 0, 2 * h], [0, 2 * h, 0])   # left wall  x=-h
    P([h, -h, -h], [0, 0, 2 * h], [0, 2 * h, 0])    # right wall x=+h
    P([-h, -h, -h], [2 * h, 0, 0], [0, 0, 2 * h])   # floor      y=-h
    P([-h, h, -h], [2 * h, 0, 0], [0, 0, 2 * h])    # ceiling    y=+h
    return planes


def render(planes: List[Plane], R_wc: np.ndarray, c_w: np.ndarray,
           width: int, height: int, fx: float, fy: float, cx: float,
           cy: float) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one view. R_wc: camera-to-world rotation, c_w: camera center.

    Returns (gray (H, W) float32 in [0, 255], depth (H, W) float32 metres).
    """
    H, W = height, width
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    dirs_c = np.stack([(u - cx) / fx, (v - cy) / fy,
                       np.ones_like(u)], axis=-1)          # (H, W, 3)
    dirs_w = dirs_c @ R_wc.T

    best_t = np.full((H, W), np.inf, np.float32)
    img = np.zeros((H, W), np.float32)

    for pl in planes:
        n = np.cross(pl.eu, pl.ev)
        n = n / np.linalg.norm(n)
        denom = dirs_w @ n
        t = ((pl.origin - c_w) @ n) / np.where(np.abs(denom) < 1e-9, np.inf, denom)
        hit_w = c_w + t[..., None] * dirs_w
        rel = hit_w - pl.origin
        a = rel @ pl.eu / (pl.eu @ pl.eu)
        b = rel @ pl.ev / (pl.ev @ pl.ev)
        ok = (t > 0.05) & (a >= 0) & (a < 1) & (b >= 0) & (b < 1) & (t < best_t)

        Th, Tw = pl.tex.shape
        ua = np.clip(a * (Tw - 1), 0, Tw - 1.001)
        vb = np.clip(b * (Th - 1), 0, Th - 1.001)
        x0 = ua.astype(np.int32); y0 = vb.astype(np.int32)
        fx_ = ua - x0; fy_ = vb - y0
        tex = pl.tex
        val = (tex[y0, x0] * (1 - fx_) * (1 - fy_) + tex[y0, x0 + 1] * fx_ * (1 - fy_)
               + tex[y0 + 1, x0] * (1 - fx_) * fy_ + tex[y0 + 1, x0 + 1] * fx_ * fy_)

        img = np.where(ok, val, img)
        best_t = np.where(ok, t, best_t)

    # depth = z in camera frame = t * dirs_c_z = t (dirs_c z-component is 1)
    depth = np.where(np.isfinite(best_t), best_t, -1.0).astype(np.float32)
    return np.round(np.clip(img, 0, 255)), depth


def orbit_trajectory(n_frames: int, radius: float = 1.0,
                     angle_range: float = 0.6, bob: float = 0.15):
    """Smooth trajectory inside the room looking at the back wall: lateral
    arc + small yaw so parallax and rotation are both exercised.

    Returns list of (R_wc (3,3), c_w (3,)) camera-to-world poses.
    """
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        th = (s - 0.5) * angle_range
        c = np.array([radius * np.sin(th), bob * np.sin(2 * np.pi * s),
                      0.5 * np.cos(th) - 0.5], np.float32)
        yaw = -0.5 * th
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        poses.append((R, c))
    return poses


def loop_trajectory(n_frames: int, radius: float = 1.2,
                    turns: float = 1.25):
    """A circle inside the room, camera facing outward, swept for
    ``turns`` revolutions.

    Returns list of (R_wc (3,3), c_w (3,)) camera-to-world poses.
    """
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * turns * i / (n_frames - 1)
        c = np.array([radius * np.sin(th), 0.1 * np.sin(2 * th),
                      radius * np.cos(th) - 0.3], np.float32)
        # yaw th keeps the optical axis pointing outward along the motion
        cy, sy = np.cos(th), np.sin(th)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        poses.append((R, c))
    return poses


TRAJECTORIES = {"orbit": orbit_trajectory, "loop": loop_trajectory}
