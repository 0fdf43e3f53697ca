"""Debug image: keypoint overlays and a status bar, drawn with numpy.

The port of ``orb_slam_2_ros_tpu/pipeline/frame_drawer.py`` (the
reference's ``FrameDrawer::DrawFrame``, ``FrameDrawer.cc:38-203``): green
squares and dots for keypoints matched to map points, blue for temporal
visual-odometry points, green match lines while a monocular map
initializes, and a 20-row status bar below the image. The reference draws
with OpenCV; this module needs none. Its primitives reproduce OpenCV's
rasterisation at thickness 1 and no sub-pixel shift: ``_line`` is
``cv::line``'s 8-connected ``LINE_8`` walk, ``_rectangle`` the one-pixel
outline of ``cv::rectangle``, ``_disc`` the filled midpoint circle of
``cv::circle(..., -1)``, each clipped to the image. So every pixel above the
status bar equals the reference's image. The bar's text comes from
``status_text``, the reference's string; its glyphs are this module's own
5x7 bitmap font, not OpenCV's Hershey font, so the bar's pixels differ.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

_STATE_TEXT = {
    0: "WAITING FOR IMAGES",
    1: "TRYING TO INITIALIZE",
    2: "SLAM MODE",
    3: "LOST. TRYING TO RELOCALIZE",
}

_GREEN = (0, 255, 0)
_BLUE = (255, 0, 0)       # BGR, like the reference's cv::Scalar(255,0,0)
BAR_ROWS = 20

# 5x7 glyphs: the character, then its 7 rows top to bottom, each row's 5
# bits (leftmost pixel = 16) as one base-32 digit; lower case draws as
# upper case
_FONT_DATA = (
    "Aehhvhhh Buhhuhhu Cehggghe Duhhhhhu Evgguggv Fvgguggg Gehgnhhf "
    "Hhhhvhhh Ie44444e J72222ic Khikokih Lggggggv Mhrllhhh Nhhpljhh "
    "Oehhhhhe Puhhuggg Qehhhlid Ruhhukih Sfgge11u Tv444444 Uhhhhhhe "
    "Vhhhhha4 Whhhllla Xhha4ahh Yhha4444 Zv1248gv 0ehjlphe 14c4444e "
    "2eh1248v 3v2421he 426aiv22 5vgu11he 668guhhe 7v124888 8ehhehhe "
    "9ehhf12c :0cc0cc0 ,0000c48 .00000cc |4444444 ?eh12404 -000v000")
_FONT = {g[0]: np.array([[(int(c, 32) >> (4 - b)) & 1 for b in range(5)]
                         for c in g[1:]], bool)
         for g in _FONT_DATA.split()}


def status_text(state: int, n_kfs: int, n_mps: int, n_matches: int,
                localization_only: bool = False) -> str:
    """The status line of the reference (``FrameDrawer.cc:170-203``)."""
    mode = " | LOCALIZATION" if localization_only else ""
    return (f"{_STATE_TEXT.get(state, '?')}{mode} | KFs: {n_kfs}, "
            f"MPs: {n_mps}, Matches: {n_matches}")


def _clip_line(W, H, p1, p2):
    """OpenCV's ``clipLine``: the segment cut to the image, its ends moved
    along the line with the coordinate truncated toward zero; None if
    nothing of it is inside."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = W - 1, H - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _line(img, p1, p2, color):
    """``cv::line`` at thickness 1, ``LINE_8``: OpenCV's ``LineIterator``,
    the segment clipped to the image (``_clip_line``), then walked from its
    left end point, one step along the major axis per pixel and one along
    the minor axis while the error term is negative."""
    H, W = img.shape[:2]
    if not (0 <= p1[0] < W and 0 <= p2[0] < W and 0 <= p1[1] < H
            and 0 <= p2[1] < H):
        clipped = _clip_line(W, H, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (1, 0), (0, sy)
    if dy > dx:
        dx, dy = dy, dx
        major, minor = minor, major
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        step_minor = err < 0
        err += -2 * dy + (2 * dx if step_minor else 0)
        x += major[0] + (minor[0] if step_minor else 0)
        y += major[1] + (minor[1] if step_minor else 0)


def _rectangle(img, p1, p2, color):
    """``cv::rectangle`` at thickness 1: its closed one-pixel outline."""
    (x1, y1), (x2, y2) = p1, p2
    for a, b in (((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
                 ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1))):
        _line(img, a, b, color)


def _disc(img, cx, cy, radius, color):
    """``cv::circle(..., thickness=-1)``, ``LINE_8``: the midpoint circle's
    horizontal spans, each clipped to the image."""
    H, W = img.shape[:2]

    def span(y, xl, xr):
        if 0 <= y < H:
            xl, xr = max(xl, 0), min(xr, W - 1)
            if xl <= xr:
                img[y, xl:xr + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            span(y, cx - dx, cx + dx)
        for y in (cy - dx, cy + dx):
            span(y, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _text(bar, text, x0, y0, color):
    """Draw ``text`` with the 5x7 font, top-left at (x0, y0), 6 px per
    character; characters without a glyph are left blank."""
    H, W = bar.shape[:2]
    for i, ch in enumerate(text.upper()):
        glyph = _FONT.get(ch)
        x = x0 + 6 * i
        if glyph is None or x + 5 > W:
            continue
        ys, xs = np.nonzero(glyph[:max(0, min(7, H - y0))])
        bar[y0 + ys, x + xs] = color


def draw_frame(gray: np.ndarray, kp_xy: np.ndarray, kp_valid: np.ndarray,
               kp_has_map: np.ndarray, state: int, n_matches: int,
               n_kfs: int = 0, n_mps: int = 0,
               localization_only: bool = False,
               kp_has_vo: Optional[np.ndarray] = None,
               init_ref_xy: Optional[np.ndarray] = None,
               init_matches: Optional[np.ndarray] = None) -> np.ndarray:
    """Render the annotated tracking image.

    gray (H, W) float or uint8; kp_xy (P, 2) pixel coordinates; kp_valid
    (P,) bool; kp_has_map (P,) bool, True for a keypoint matched to a map
    point (green square and dot, ``FrameDrawer.cc:123-131``); kp_has_vo
    (P,) bool for one matched to a temporal visual-odometry point (blue,
    ``FrameDrawer.cc:133-139``; localization mode only).

    While a monocular map initializes, pass init_ref_xy (P, 2), the
    reference frame's keypoints, and init_matches (P,) int32, current
    keypoint j -> reference keypoint (or -1): matched pairs are joined by
    green lines (``FrameDrawer.cc:92-105``).

    Returns (H + 20, W, 3) uint8 BGR with the status bar below."""
    img = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    bgr = np.repeat(img[:, :, None], 3, axis=2)
    r = 5
    kp_xy = np.asarray(kp_xy)
    kp_valid = np.asarray(kp_valid)

    if init_ref_xy is not None and init_matches is not None:
        ref_xy = np.asarray(init_ref_xy)
        mi = np.asarray(init_matches)
        for j, (x, y) in enumerate(kp_xy):
            if not kp_valid[j] or mi[j] < 0:
                continue
            _line(bgr, (int(ref_xy[mi[j]][0]), int(ref_xy[mi[j]][1])),
                  (int(x), int(y)), _GREEN)
    else:
        vo = (np.zeros(len(kp_xy), bool) if kp_has_vo is None
              else np.asarray(kp_has_vo))
        has_map = np.asarray(kp_has_map)
        for (x, y), ok, has, is_vo in zip(kp_xy, kp_valid, has_map, vo):
            if not ok or not (has or is_vo):
                continue
            color = _GREEN if has else _BLUE
            _rectangle(bgr, (int(x - r), int(y - r)), (int(x + r), int(y + r)),
                       color)
            _disc(bgr, int(x), int(y), 2, color)

    bar = np.zeros((BAR_ROWS, img.shape[1], 3), np.uint8)
    _text(bar, status_text(state, n_kfs, n_mps, n_matches,
                           localization_only), 5, 7, (255, 255, 255))
    return np.concatenate([bgr, bar], axis=0)


def write_png(path: str, bgr: np.ndarray) -> None:
    """Write a (H, W, 3) uint8 BGR image as an 8-bit RGB PNG, as
    ``cv2.imwrite`` would (one filter-0 scanline per row, zlib level 6)."""
    rgb = np.ascontiguousarray(bgr[:, :, ::-1], np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
