"""Native (C++) host runtime: image decoding, the threaded frame
prefetcher and the ORB vocabulary file readers, bound with ``ctypes``.

The port's own copy of ``orb_slam_2_ros_tpu/native``
(``dataset_loader.cc``, ``vocab_loader.cc``). PNG is decoded in
``dataset_loader.cc`` itself, with zlib for the inflate (``DECODER``), so
the library needs the zlib headers and no libpng.

The library builds at first use with the C++ compiler (``$CXX``, else
``g++``) into the package's git-ignored ``_build/``, named by a hash of the
sources and flags: an edited source rebuilds, an unchanged one loads at
once. The compiler writes to a name of its own, which ``os.replace`` then
moves into place, so a process that builds at the same time as another
never opens half a file. There is no fallback: a missing compiler or a
failed build raises, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = ("dataset_loader.cc", "vocab_loader.cc")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
LIBS = ("-lz",)
DECODER = "PNG: own chunk parser and unfilter, zlib inflate (no libpng)"

MODE_MONO, MODE_RGBD, MODE_STEREO = 0, 1, 2


def _library_path(build_dir: str) -> str:
    key = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            key.update(f.read())
    return os.path.join(build_dir, f"slamnative_{key.hexdigest()[:16]}.so")


def is_built(build_dir: str = BUILD_DIR) -> bool:
    """Whether the library of the current sources is already built."""
    return os.path.exists(_library_path(build_dir))


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the library unless it is built; return its path. Raises
    RuntimeError if no compiler is found or the build fails."""
    out = _library_path(build_dir)
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("cannot build the native library: no C++ "
                           "compiler ($CXX unset and no g++ on PATH)")
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp,
           *(os.path.join(_DIR, s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"the native library failed to build (exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (if needed) and load the library, its functions typed."""
    lib = ctypes.CDLL(build(build_dir))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ip = ctypes.POINTER(ctypes.c_int)
    for name in ("parse_orbvoc_bin", "parse_orbvoc_txt"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, ip, ip, i32p, u8p, u8p, f64p,
                       ctypes.c_long]
    lib.write_orbvoc_bin.restype = ctypes.c_long
    lib.write_orbvoc_bin.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, i32p, u8p, u8p, f64p,
                                     ctypes.c_long]
    lib.decode_gray8.restype = ctypes.c_int
    lib.decode_gray8.argtypes = [ctypes.c_char_p, u8p, ip, ip]
    lib.decode_depth_mm.restype = ctypes.c_int
    lib.decode_depth_mm.argtypes = [ctypes.c_char_p, ctypes.c_double, u16p,
                                    ip, ip]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def parse_orbvoc(path: str, max_nodes: int = 1_200_000):
    """Parse a DBoW2 vocabulary file, text if ``path`` ends in ``.txt``,
    else binary. Returns (k, L, parents, is_leaf, descs, weights); raises
    IOError if the file cannot be parsed."""
    lib = load()
    parents = np.empty(max_nodes, np.int32)
    is_leaf = np.empty(max_nodes, np.uint8)
    descs = np.empty((max_nodes, 32), np.uint8)
    weights = np.empty(max_nodes, np.float64)
    k = ctypes.c_int()
    L = ctypes.c_int()
    fn = (lib.parse_orbvoc_txt if path.endswith(".txt")
          else lib.parse_orbvoc_bin)
    n = fn(path.encode(), ctypes.byref(k), ctypes.byref(L), parents,
           is_leaf, descs, weights, max_nodes)
    if n < 0:
        raise IOError(f"native vocabulary parse failed: {path}")
    return (int(k.value), int(L.value), parents[:n], is_leaf[:n].astype(bool),
            descs[:n], weights[:n])


def _decode(fn, path, dtype, *args, max_h=4096, max_w=8192):
    out = np.empty((max_h, max_w), dtype)
    w = ctypes.c_int(max_w)
    h = ctypes.c_int(max_h)
    if fn(path.encode(), *args, out, ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native decode failed: {path}")
    return np.ascontiguousarray(out.ravel()[:w.value * h.value]
                                .reshape(h.value, w.value))


def decode_gray8(path: str) -> np.ndarray:
    """A PNG, PGM or PPM file as u8 gray (OpenCV's fixed-point BT.601 for
    colour, the reference's cvtColor path, ``Tracking.cc:173-276``).
    Raises IOError on a decode failure."""
    return _decode(load().decode_gray8, path, np.uint8)


def decode_depth_mm(path: str, depth_factor: float) -> np.ndarray:
    """A 16-bit depth PNG as u16 millimetres, the wire format:
    mm = raw * 1000 / depth_factor, rounded (TUM's factor 5000,
    ``Tracking.cc:151-157``). Raises IOError on a decode failure."""
    return _decode(load().decode_depth_mm, path, np.uint16, depth_factor)


class Prefetcher:
    """Threaded native prefetch over a sequence of frame files.

    Worker threads decode upcoming frames into a ring of reusable slots and
    ``next()`` hands them out in order as wire-format arrays (u8 gray plus
    u16 mm depth or a u8 right image), so decoding overlaps the device: the
    stand-in for the reference's in-process ROS image delivery
    (``ros/src/RGBDNode.cc:30-35``)."""

    def __init__(self, paths_a, paths_b, mode: int, width: int, height: int,
                 depth_factor: float = 5000.0, n_threads: int = 4,
                 ring_cap: int = 32):
        self._handle = None
        self._lib = load()
        self._n = len(paths_a)
        self.mode = mode
        self.w, self.h = width, height
        self._handle = self._lib.loader_create(
            "\n".join(paths_a).encode(), "\n".join(paths_b or []).encode(),
            mode, width, height, depth_factor, n_threads, ring_cap)
        if not self._handle:
            raise RuntimeError("loader_create failed")

    def __len__(self):
        return self._n

    def next(self):
        """(gray u8 (H, W), aux): aux is u16 mm depth for RGB-D, u8 gray for
        stereo, None for mono. None at the end of the stream."""
        gray = np.empty((self.h, self.w), np.uint8)
        aux = {MODE_RGBD: lambda: np.empty((self.h, self.w), np.uint16),
               MODE_STEREO: lambda: np.empty((self.h, self.w), np.uint8)
               }.get(self.mode, lambda: None)()
        rc = self._lib.loader_next(
            self._handle, gray.ctypes.data_as(ctypes.c_void_p),
            aux.ctypes.data_as(ctypes.c_void_p) if aux is not None else None)
        if rc == -1:
            return None
        if rc == -2:
            raise IOError("native decode failed mid-stream")
        return gray, aux

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def write_orbvoc_bin(path: str, k: int, L: int, parents, is_leaf, descs,
                     weights):
    """Write a vocabulary in the binary layout of ``parse_orbvoc``.
    Raises IOError if the file cannot be written."""
    parents = np.ascontiguousarray(parents, np.int32)
    is_leaf = np.ascontiguousarray(is_leaf, np.uint8)
    descs = np.ascontiguousarray(descs, np.uint8)
    weights = np.ascontiguousarray(weights, np.float64)
    n = load().write_orbvoc_bin(path.encode(), k, L, parents, is_leaf, descs,
                                weights, len(parents))
    if n != len(parents):
        raise IOError(f"native vocabulary write failed: {path}")
