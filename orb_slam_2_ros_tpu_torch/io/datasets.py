"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

The port's own copy of ``orb_slam_2_ros_tpu/io/datasets.py``, the
topic-free stand-in for the reference's ROS subscribers
(``MonoNode.cc``, ``StereoNode.cc``, ``RGBDNode.cc``): directory-layout
loaders that give numpy frames and timestamps. Every image is decoded by
the port's native library (``native/``); nothing here falls back to
another decoder.

All loaders duck-type: ``__len__``, ``__getitem__`` -> frame tuple,
``.timestamps``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from orb_slam_2_ros_tpu_torch import native
from orb_slam_2_ros_tpu_torch.geometry import rectify as rect


def _imread_gray(path: str) -> np.ndarray:
    """Grayscale decode with the native decoder (PNG, PGM or PPM -> u8,
    OpenCV's fixed-point BT.601 conversion), as float32."""
    return native.decode_gray8(path).astype(np.float32)


def make_prefetcher(ds, n_threads: int = 4, ring_cap: int = 32):
    """A native threaded prefetcher over a file-based dataset
    (``native/dataset_loader.cc``): worker threads decode frames into
    wire-format buffers (u8 gray; u16 mm depth or u8 right image) while the
    device computes. None when the dataset has no files to stream
    (``wire_paths`` missing or None, as for a rectifying EuRoC loader,
    whose frames need the host remap): the caller indexes it instead."""
    if not hasattr(ds, "wire_paths"):
        return None
    wp = ds.wire_paths()
    if wp is None:      # dataset needs host-side post-processing (rectify)
        return None
    paths_a, paths_b, mode, depth_factor = wp
    probe = _imread_gray(paths_a[0])
    h, w = probe.shape
    return native.Prefetcher(paths_a, paths_b, mode, w, h,
                             depth_factor=depth_factor, n_threads=n_threads,
                             ring_cap=ring_cap)


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (the TUM associate.py algorithm
    the reference ecosystem uses to pair rgb/depth streams)."""
    pairs = []
    j = 0
    used = set()
    for i, ta in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, ta))
        best, best_dt = -1, max_dt
        for cand in (j - 1, j, j + 1):
            if 0 <= cand < len(ts_b) and cand not in used:
                dt = abs(ts_b[cand] - ta)
                if dt < best_dt:
                    best, best_dt = cand, dt
        if best >= 0:
            used.add(best)
            pairs.append((i, best))
    return pairs


class TumRGBD:
    """TUM RGB-D directory: rgb.txt / depth.txt / rgb/ depth/ folders.

    Depth PNGs are 16-bit with factor 5000 (``depth_map_factor``,
    ``Tracking.cc:151-157``); frames come back as (gray float32 [0,255],
    depth float32 metres with <=0 for missing).
    """

    def __init__(self, root: str, depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor

        def read_list(name):
            ts, files = [], []
            with open(os.path.join(root, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    t, p = line.split()[:2]
                    ts.append(float(t))
                    files.append(p)
            return np.array(ts), files

        rgb_ts, rgb_files = read_list("rgb.txt")
        d_ts, d_files = read_list("depth.txt")
        pairs = associate(rgb_ts, d_ts)
        self.timestamps = [rgb_ts[i] for i, _ in pairs]
        self.rgb_files = [rgb_files[i] for i, _ in pairs]
        self.depth_files = [d_files[j] for _, j in pairs]

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, i):
        gray = _imread_gray(os.path.join(self.root, self.rgb_files[i]))
        mm = native.decode_depth_mm(
            os.path.join(self.root, self.depth_files[i]), self.depth_factor)
        depth = mm.astype(np.float32) * 1e-3
        depth[mm == 0] = -1.0
        return gray, depth

    def wire_paths(self):
        return ([os.path.join(self.root, p) for p in self.rgb_files],
                [os.path.join(self.root, p) for p in self.depth_files],
                native.MODE_RGBD, self.depth_factor)

    def gt_trajectory(self):
        """(timestamps, poses_wc) from groundtruth.txt if present."""
        from orb_slam_2_ros_tpu_torch.io.trajectory import read_tum
        return read_tum(os.path.join(self.root, "groundtruth.txt"))


class KittiOdometry:
    """KITTI odometry sequence dir: image_0/ image_1/ times.txt (+ poses)."""

    def __init__(self, seq_dir: str, poses_file: str = None):
        self.seq_dir = seq_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.timestamps = [float(x) for x in f if x.strip()]
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        self.n = len(self.timestamps)
        self.poses_file = poses_file

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        name = f"{i:06d}.png"
        left = _imread_gray(os.path.join(self.left_dir, name))
        right = _imread_gray(os.path.join(self.right_dir, name))
        return left, right

    def wire_paths(self):
        names = [f"{i:06d}.png" for i in range(self.n)]
        return ([os.path.join(self.left_dir, p) for p in names],
                [os.path.join(self.right_dir, p) for p in names],
                native.MODE_STEREO, 1.0)

    def gt_trajectory(self):
        poses = []
        with open(self.poses_file) as f:
            for line in f:
                v = np.fromstring(line, sep=" ").reshape(3, 4)
                poses.append((v[:, :3], v[:, 3]))
        return np.array(self.timestamps), poses

    def calibration(self):
        """Intrinsics + stereo baseline from the sequence's calib.txt
        (P0/P1 rectified projection matrices): returns a dict with fx, fy,
        cx, cy, bf, width, height — the camera_info-equivalent source the
        reference reads from a live topic (``ros/src/Node.cc:336-358``).
        Returns None when calib.txt is absent."""
        path = os.path.join(self.seq_dir, "calib.txt")
        if not os.path.exists(path):
            return None
        P = {}
        with open(path) as f:
            for line in f:
                if ":" in line:
                    key, vals = line.split(":", 1)
                    P[key.strip()] = np.fromstring(vals, sep=" ")
        if "P0" not in P or "P1" not in P:
            return None
        P0 = P["P0"].reshape(3, 4)
        P1 = P["P1"].reshape(3, 4)
        img = _imread_gray(os.path.join(self.left_dir, "000000.png"))
        return {
            "fx": float(P0[0, 0]), "fy": float(P0[1, 1]),
            "cx": float(P0[0, 2]), "cy": float(P0[1, 2]),
            # P1[0,3] = -fx * baseline for the right camera
            "bf": float(-P1[0, 3]),
            "width": int(img.shape[1]), "height": int(img.shape[0]),
        }


def _parse_euroc_yaml(path: str) -> dict:
    """Minimal reader for EuRoC ``sensor.yaml`` (flat keys + bracketed float
    lists; no YAML dependency needed for this fixed schema)."""
    import re
    text = open(path).read()
    out = {}
    for key in ("intrinsics", "distortion_coefficients", "resolution"):
        m = re.search(key + r":\s*\[([^\]]*)\]", text)
        if m:
            out[key] = np.fromstring(m.group(1), sep=",")
    m = re.search(r"T_BS:.*?data:\s*\[([^\]]*)\]", text, re.S)
    if m:
        out["T_BS"] = np.fromstring(m.group(1), sep=",").reshape(4, 4)
    return out


class EurocMav:
    """EuRoC MAV dir: mav0/cam0/data + cam1/data with data.csv stamps.

    EuRoC cameras are UNRECTIFIED (radtan distortion + a relative
    rotation); the reference's EuRoC path pre-rectifies with
    ``cv::stereoRectify`` from ``sensor.yaml`` before tracking (the stock
    stereo_euroc example — the row-band stereo matcher needs rectified
    pairs, ``Frame.cc:502-676``). When both sensor.yaml files are present
    this loader rectifies every pair through geometry/rectify.py and
    reports the rectified intrinsics via ``calibration()``; without them
    it passes frames through untouched (pre-rectified custom exports)."""

    def __init__(self, root: str, rectify: bool = True):
        self.root = root

        def read_cam(cam):
            base = os.path.join(root, "mav0", cam)
            ts, files = [], []
            with open(os.path.join(base, "data.csv")) as f:
                for line in f:
                    if line.startswith("#") or not line.strip():
                        continue
                    t, name = line.strip().split(",")[:2]
                    ts.append(float(t) * 1e-9)
                    files.append(os.path.join(base, "data", name))
            return np.array(ts), files

        t0, f0 = read_cam("cam0")
        t1, f1 = read_cam("cam1")
        pairs = associate(t0, t1, max_dt=0.005)
        self.timestamps = [t0[i] for i, _ in pairs]
        self.left_files = [f0[i] for i, _ in pairs]
        self.right_files = [f1[j] for _, j in pairs]
        self._maps = None
        self._calib = None
        if rectify:
            try:
                y0 = _parse_euroc_yaml(
                    os.path.join(root, "mav0", "cam0", "sensor.yaml"))
                y1 = _parse_euroc_yaml(
                    os.path.join(root, "mav0", "cam1", "sensor.yaml"))
                self._setup_rectification(y0, y1)
            except (OSError, KeyError, ValueError, IndexError):
                pass

    def _setup_rectification(self, y0: dict, y1: dict):
        # T_BS: camera -> body; relative cam0 -> cam1: x1 = R x0 + t
        T = np.linalg.inv(y1["T_BS"]) @ y0["T_BS"]
        R, t = T[:3, :3], T[:3, 3]

        def K_of(y):
            fu, fv, cu, cv = y["intrinsics"]
            return np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1.0]])

        W, H = int(y0["resolution"][0]), int(y0["resolution"][1])
        K0, K1 = K_of(y0), K_of(y1)
        D0 = y0["distortion_coefficients"]
        D1 = y1["distortion_coefficients"]
        R0, R1, Kn, b = rect.stereo_rectify(K0, D0, K1, D1, R, t, (W, H))
        self._maps = (rect.build_rectify_map(Kn, R0, K0, D0, (W, H)),
                      rect.build_rectify_map(Kn, R1, K1, D1, (W, H)))
        self._calib = {
            "fx": float(Kn[0, 0]), "fy": float(Kn[1, 1]),
            "cx": float(Kn[0, 2]), "cy": float(Kn[1, 2]),
            "bf": float(Kn[0, 0] * b), "width": W, "height": H,
            "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
        }

    def calibration(self):
        """Rectified intrinsics dict (fx, fy, cx, cy, bf, width, height,
        zeroed distortion) or None when no sensor.yaml was found."""
        return self._calib

    def __len__(self):
        return len(self.left_files)

    def __getitem__(self, i):
        l = _imread_gray(self.left_files[i])
        r = _imread_gray(self.right_files[i])
        if self._maps is not None:
            l = rect.remap_bilinear(l, self._maps[0])
            r = rect.remap_bilinear(r, self._maps[1])
        return l, r

    def wire_paths(self):
        # the native decoder streams RAW files; with rectification active
        # frames must flow through __getitem__'s remap instead
        if self._maps is not None:
            return None
        return (list(self.left_files), list(self.right_files),
                native.MODE_STEREO, 1.0)
