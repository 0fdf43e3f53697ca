"""The harness's frames, made on the device from the seed.

A PyTorch copy of the port's ray caster (``frozen_np.render``): the room's
six textures are the value noise of ``frozen_np.make_room(seed)``, whose
coarse grids are drawn on the host by the same numpy generator (a few
thousand numbers) and upsampled on the device; every pixel of every frame
is cast on the device, then each sequence is copied once to host arrays in
the wire format that ``System.track_chunk`` takes (u8 gray, and u16
millimetre depth or a u8 right image), so that each hand-in's copy to the
card stays in the timed path, as a camera driver pays it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


TEX_SIZE = 768
OCTAVES = (3, 9, 27, 81)


class DevicePlane(NamedTuple):
    origin: torch.Tensor   # (3,)
    eu: torch.Tensor       # (3,)
    ev: torch.Tensor       # (3,)
    normal: torch.Tensor   # (3,) unit
    tex: torch.Tensor      # (TEX_SIZE, TEX_SIZE) float32


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float


def seed_to_rng_seed(seed: int) -> int:
    """Any whole number, negative ones too, as a numpy generator seed."""
    return int(seed) % (1 << 64)


def _texture(rng: np.random.Generator, device) -> torch.Tensor:
    """``frozen_np._make_texture`` with the upsampling on the device."""
    tex = torch.zeros((TEX_SIZE, TEX_SIZE), dtype=torch.float32, device=device)
    for i, cells in enumerate(OCTAVES):
        coarse = torch.from_numpy(
            rng.uniform(0, 1, (cells, cells)).astype(np.float32)).to(device)
        reps = int(np.ceil(TEX_SIZE / cells))
        up = coarse.repeat_interleave(reps, 0).repeat_interleave(reps, 1)
        tex += up[:TEX_SIZE, :TEX_SIZE] * (0.6 ** i)
    tex -= tex.min()
    tex /= tex.max()
    return 20.0 + 215.0 * tex


def make_room(seed: int, device, half: float = 3.0) -> List[DevicePlane]:
    """``frozen_np.make_room(seed)`` on ``device``: the same planes, the
    same textures."""
    rng = np.random.default_rng(seed_to_rng_seed(seed))
    h = half
    corners = (
        ([-h, -h, -h], [2 * h, 0, 0], [0, 2 * h, 0]),
        ([-h, -h, h], [2 * h, 0, 0], [0, 2 * h, 0]),
        ([-h, -h, -h], [0, 0, 2 * h], [0, 2 * h, 0]),
        ([h, -h, -h], [0, 0, 2 * h], [0, 2 * h, 0]),
        ([-h, -h, -h], [2 * h, 0, 0], [0, 0, 2 * h]),
        ([-h, h, -h], [2 * h, 0, 0], [0, 0, 2 * h]),
    )
    planes = []
    for origin, eu, ev in corners:
        o, u, v = (np.array(x, np.float32) for x in (origin, eu, ev))
        n = np.cross(u, v)
        n = n / np.linalg.norm(n)

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)
        planes.append(DevicePlane(dev(o), dev(u), dev(v), dev(n),
                                  _texture(rng, device)))
    return planes


def _dot3(a: torch.Tensor, b) -> torch.Tensor:
    """Sum over the last axis of three terms, in a fixed order."""
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def render(planes: List[DevicePlane], R_wc: np.ndarray, c_w: np.ndarray,
           cam: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view: (gray (H, W) float32 integral values in [0, 255], depth
    (H, W) float32 metres, -1 where no plane is hit), on the planes'
    device."""
    device = planes[0].tex.device
    H, W = cam.height, cam.width
    R = torch.from_numpy(np.asarray(R_wc, np.float32)).to(device)
    c = torch.from_numpy(np.asarray(c_w, np.float32)).to(device)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs_c = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                          torch.ones_like(u)], dim=-1)
    dirs_w = torch.stack([_dot3(dirs_c, R[k]) for k in range(3)], dim=-1)
    best_t = torch.full((H, W), float("inf"), device=device)
    img = torch.zeros((H, W), device=device)
    inf = torch.tensor(float("inf"), device=device)
    for pl in planes:
        denom = _dot3(dirs_w, pl.normal)
        num = _dot3(pl.origin - c, pl.normal)
        t = num / torch.where(denom.abs() < 1e-9, inf, denom)
        rel = c + t[..., None] * dirs_w - pl.origin
        a = _dot3(rel, pl.eu) / _dot3(pl.eu, pl.eu)
        b = _dot3(rel, pl.ev) / _dot3(pl.ev, pl.ev)
        ok = ((t > 0.05) & (a >= 0) & (a < 1) & (b >= 0) & (b < 1)
              & (t < best_t))
        Th, Tw = pl.tex.shape
        ua = torch.clamp(a * (Tw - 1), 0, Tw - 1.001)
        vb = torch.clamp(b * (Th - 1), 0, Th - 1.001)
        x0 = ua.to(torch.int64)
        y0 = vb.to(torch.int64)
        fx_ = ua - x0
        fy_ = vb - y0
        flat = pl.tex.reshape(-1)

        def at(yy, xx):
            return flat[(yy * Tw + xx).clamp(0, Th * Tw - 1)]
        val = (at(y0, x0) * (1 - fx_) * (1 - fy_)
               + at(y0, x0 + 1) * fx_ * (1 - fy_)
               + at(y0 + 1, x0) * (1 - fx_) * fy_
               + at(y0 + 1, x0 + 1) * fx_ * fy_)
        img = torch.where(ok, val, img)
        best_t = torch.where(ok, t, best_t)
    depth = torch.where(torch.isfinite(best_t), best_t,
                        torch.full_like(best_t, -1.0))
    return torch.round(torch.clamp(img, 0, 255)), depth


def wire_sequence(planes: List[DevicePlane], poses, cam: Camera,
                  stereo: bool):
    """The frames of ``poses`` in wire format, as host arrays: (grays (N, H,
    W) uint8, auxs (N, H, W)): uint16 millimetre depth maps, or with
    ``stereo`` uint8 right images from a camera ``bf / fx`` metres along
    the left camera's x axis (rectified, as ``SyntheticStereo``)."""
    grays, auxs = [], []
    baseline = np.float32(cam.bf / cam.fx)
    for R_wc, c_w in poses:
        gray, depth = render(planes, R_wc, c_w, cam)
        grays.append(gray.to(torch.uint8))
        if stereo:
            c_r = c_w + R_wc @ np.array([baseline, 0.0, 0.0], np.float32)
            right, _ = render(planes, R_wc, c_r, cam)
            auxs.append(right.to(torch.uint8))
        else:
            mm = torch.clamp(torch.round(depth * 1e3), 0, 65535)
            auxs.append(mm.to(torch.int32))
    g = torch.stack(grays).cpu().numpy()
    a = torch.stack(auxs).cpu().numpy()
    return g, (a if stereo else a.astype(np.uint16))
