"""Synthetic RGB-D sequences with exact ground truth.

A textured box room rendered by analytic ray casting (numpy, on the host):
every pixel gets a ray-plane intersection, a bilinear texture sample and an
exact depth, giving a TUM-like RGB-D stream plus perfect ground-truth poses
for ATE evaluation.

The port's own copy of the reference's ``orb_slam_2_ros_tpu/io/synthetic.py``
(without the stereo sequence, which the port does not track yet): the same
seed gives the same frames bit for bit, which
``tests/test_torch_config_io.py`` checks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from orb_slam_2_ros_tpu_torch.config import CameraConfig, SlamConfig


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
           cam: CameraConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one view. R_wc: camera-to-world rotation, c_w: camera center.

    Returns (gray (H, W) float32 in [0, 255], depth (H, W) float32 metres).
    """
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    dirs_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
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
    ``turns`` revolutions: everything past one turn genuinely REVISITS the
    first keyframes' viewpoints over several chunks, so a correct
    place-recognition + Sim3 pipeline must close the loop (the 3-detection
    consistency window of ``LoopClosing.cc:178-253`` needs the revisit to
    persist). The drift a real run accumulates over the sweep is what loop
    closure is benchmarked against (the synthetic analog of KITTI 00).

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


def fast_rotation_trajectory(n_frames: int, peak_rate: float = 0.045):
    """Near-stationary camera with an aggressive yaw sweep (peak
    ``peak_rate`` rad/frame ≈ 77 deg/s at 30 fps): the hard case for the
    constant-velocity motion model — rotation flow with almost no parallax,
    forcing the widened-window / reference-keyframe fallbacks
    (``Tracking.cc:1002-1016``, ``:328-339``) to carry tracking."""
    poses = []
    yaw = 0.0
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        yaw += peak_rate * np.sin(np.pi * s)     # ramp up, peak, ramp down
        c = np.array([0.15 * np.sin(2 * np.pi * s), 0.0, -0.3], np.float32)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        poses.append((R, c))
    return poses


class SyntheticRGBD:
    """Iterable RGB-D sequence with ground truth (duck-types dataset
    loaders).

    trajectory: "orbit" (smooth arc), "loop" (1.25 outward-facing turns,
    one revisit), "twoloop" (2.25 turns — every viewpoint revisits TWICE,
    so a correct pipeline closes two loops), "fastrot" (aggressive yaw
    sweep, almost no parallax).

    exposure_drift g != 0 applies a slow photometric gain sweep
    gain = 1 + g*sin(2*pi*s) plus a bias ramp — the auto-exposure drift of
    real cameras; ORB matching must survive it (BRIEF compares relative
    intensities, but FAST thresholds and histogram shape shift)."""

    def __init__(self, cfg: SlamConfig, n_frames: int = 60, seed: int = 0,
                 radius: float = 1.0, angle_range: float = 0.6,
                 trajectory: str = "orbit", exposure_drift: float = 0.0):
        self.cfg = cfg
        self.planes = make_room(seed)
        if trajectory == "loop":
            self.poses = loop_trajectory(n_frames, radius)
        elif trajectory == "twoloop":
            self.poses = loop_trajectory(n_frames, radius, turns=2.25)
        elif trajectory == "fastrot":
            self.poses = fast_rotation_trajectory(n_frames)
        else:
            self.poses = orbit_trajectory(n_frames, radius, angle_range)
        self.exposure_drift = exposure_drift
        self.timestamps = np.arange(n_frames, dtype=np.float64) / 30.0

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, i):
        R_wc, c_w = self.poses[i]
        gray, depth = render(self.planes, R_wc, c_w, self.cfg.camera)
        if self.exposure_drift:
            s = i / max(len(self.poses) - 1, 1)
            gain = 1.0 + self.exposure_drift * np.sin(2 * np.pi * s)
            bias = 12.0 * self.exposure_drift * np.sin(np.pi * s)
            gray = np.round(np.clip(gain * gray + bias, 0, 255))
        return gray, depth

    def gt_pose_wc(self, i):
        """Ground truth camera-to-world (R, c)."""
        return self.poses[i]

    def gt_pose_cw(self, i):
        """Ground truth world-to-camera (R, t) like the internal convention."""
        R_wc, c_w = self.poses[i]
        return R_wc.T, -R_wc.T @ c_w


def _render_block(job):
    """Worker of ``render_frames``: the frames ``indices`` of the sequence
    that ``kwargs`` describe."""
    cfg, kwargs, indices = job
    ds = SyntheticRGBD(cfg, **kwargs)
    return [ds[i] for i in indices]


def render_frames(cfg: SlamConfig, n_frames: int, workers: int = 1, **kwargs):
    """Render a whole sequence: (dataset, grays (N, H, W), depths (N, H, W)).
    ``kwargs`` go to ``SyntheticRGBD`` (seed, trajectory, ...). With
    ``workers`` > 1 the frames are rendered by that many processes, each of
    which builds the same scene from the seed; the result is the same,
    frame for frame, and the processes are gone when the call returns."""
    kwargs = dict(kwargs, n_frames=n_frames)
    ds = SyntheticRGBD(cfg, **kwargs)
    if workers <= 1:
        frames = [ds[i] for i in range(n_frames)]
    else:
        import concurrent.futures
        import multiprocessing
        blocks = [list(range(w, n_frames, workers)) for w in range(workers)]
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            done = list(pool.map(_render_block,
                                 [(cfg, kwargs, b) for b in blocks]))
        frames = [None] * n_frames
        for block, rendered in zip(blocks, done):
            for i, frame in zip(block, rendered):
                frames[i] = frame
    return (ds, np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))
