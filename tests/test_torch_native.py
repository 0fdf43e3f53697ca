"""The port's native host runtime (``native/``): PNG, PGM and depth decoding,
the threaded prefetcher, the atomic first build and the ORBvoc readers.

Oracles: OpenCV (``cv2.cvtColor``, ``cv2.imread``) and the reference's own
libpng decoder, its ``native/dataset_loader.cc`` compiled by this file with
``-lpng -lz`` into a temporary directory (the reference package's lazy
``make`` is not used: its xdist workers race on it). Tolerances: every
decoded pixel equal; the native ORBvoc parse equal to the Python parse
field by field. The cases of ``tests/test_native_loader.py`` run on the
port's copy; the ordered prefetch runs 20 times; six processes that make
the first build at the same moment must all load the library.
"""

import ctypes
import os
import struct
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from orb_slam_2_ros_tpu_torch import native
from orb_slam_2_ros_tpu_torch.place import vocabulary as tvoc

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_TUM = os.path.join(REPO, "tests", "data", "mini_tum")


@pytest.fixture(scope="module")
def libpng_decoder(tmp_path_factory):
    """The reference's libpng decoder, built from its source."""
    out = str(tmp_path_factory.mktemp("ref_native") / "libref.so")
    src = os.path.join(REPO, "orb_slam_2_ros_tpu", "native",
                       "dataset_loader.cc")
    subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o",
                    out, src, "-lpng", "-lz", "-pthread"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    ip = ctypes.POINTER(ctypes.c_int)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.decode_gray8.argtypes = [ctypes.c_char_p, u8p, ip, ip]
    lib.decode_depth_mm.argtypes = [ctypes.c_char_p, ctypes.c_double, u16p,
                                    ip, ip]

    def decode(path, depth_factor=None):
        buf = np.empty((4096, 4096),
                       np.uint8 if depth_factor is None else np.uint16)
        w, h = ctypes.c_int(4096), ctypes.c_int(4096)
        args = ((buf,) if depth_factor is None else (depth_factor, buf))
        fn = lib.decode_gray8 if depth_factor is None else lib.decode_depth_mm
        assert fn(path.encode(), *args, ctypes.byref(w), ctypes.byref(h)) == 0
        return buf.ravel()[:w.value * h.value].reshape(h.value, w.value)
    return decode


def _write_png(path, arr):
    Image.fromarray(arr).save(path)


def _write_adam7_png(path, arr):
    """An interlaced 8-bit gray or RGB PNG (no library writes one)."""
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = arr[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            raw += b"\x01" + np.diff(row.reshape(-1).astype(np.int16),
                                     prepend=0).astype(np.uint8).tobytes() \
                if color == 0 else b"\x00" + row.tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                           1)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def test_decode_gray8_rgb_matches_opencv(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (48, 64, 3), np.uint8)
    p = str(tmp_path / "rgb.png")
    _write_png(p, rgb)
    np.testing.assert_array_equal(native.decode_gray8(p),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def test_decode_gray8_grayscale_png(tmp_path):
    g = np.random.default_rng(1).integers(0, 256, (32, 40), np.uint8)
    p = str(tmp_path / "g.png")
    _write_png(p, g)
    np.testing.assert_array_equal(native.decode_gray8(p), g)
    np.testing.assert_array_equal(native.decode_gray8(p),
                                  cv2.imread(p, cv2.IMREAD_UNCHANGED))


def test_decode_depth_mm_tum_factor(tmp_path):
    raw = np.random.default_rng(2).integers(0, 30000, (24, 32)).astype(
        np.uint16)
    p = str(tmp_path / "d.png")
    _write_png(p, raw)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), raw)
    expect = np.minimum(np.floor(raw.astype(np.float64) / 5.0 + 0.5),
                        65535).astype(np.uint16)
    np.testing.assert_array_equal(native.decode_depth_mm(p, 5000.0), expect)


def test_decode_pgm(tmp_path):
    g = np.random.default_rng(3).integers(0, 256, (16, 20), np.uint8)
    p = str(tmp_path / "g.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n20 16\n255\n")
        f.write(g.tobytes())
    np.testing.assert_array_equal(native.decode_gray8(p), g)


FORMATS = ["gray8", "rgb8", "rgba8", "gray_alpha8", "gray16", "rgb16",
           "palette", "palette_tRNS", "gray1", "gray4", "adam7_gray",
           "adam7_rgb", "optimized"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_equals_libpng_path(tmp_path, libpng_decoder, fmt):
    """Every PNG layout through the port's decoder and the reference's
    libpng one: equal gray images (and cv2's where cv2 reads the same)."""
    rng = np.random.default_rng(FORMATS.index(fmt))
    h, w = int(rng.integers(5, 41)), int(rng.integers(5, 41))
    p = str(tmp_path / f"{fmt}.png")
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    if fmt == "gray8":
        Image.fromarray(rgb[..., 0]).save(p)
    elif fmt == "rgb8":
        Image.fromarray(rgb).save(p)
    elif fmt == "rgba8":
        Image.fromarray(np.dstack([rgb, rgb[..., :1]])).save(p)
    elif fmt == "gray_alpha8":
        Image.fromarray(np.dstack([rgb[..., 0], rgb[..., 1]]), "LA").save(p)
    elif fmt == "gray16":
        cv2.imwrite(p, rng.integers(0, 65536, (h, w)).astype(np.uint16))
    elif fmt == "rgb16":
        cv2.imwrite(p, rng.integers(0, 65536, (h, w, 3)).astype(np.uint16))
    elif fmt.startswith("palette"):
        im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                          colors=13)
        if fmt == "palette_tRNS":
            im.info["transparency"] = 3
        im.save(p, **({"transparency": 3} if fmt == "palette_tRNS" else {}))
    elif fmt == "gray1":
        Image.fromarray(rgb[..., 0] > 127).save(p)
    elif fmt == "gray4":
        Image.fromarray(rgb[..., 0] // 17 * 17).convert(
            "P", palette=Image.ADAPTIVE, colors=16).save(p, bits=4)
    elif fmt == "adam7_gray":
        _write_adam7_png(p, rgb[..., 0])
    elif fmt == "adam7_rgb":
        _write_adam7_png(p, rgb)
    else:
        Image.fromarray(rgb[..., 1]).save(p, optimize=True)
    got = native.decode_gray8(p)
    np.testing.assert_array_equal(got, libpng_decoder(p))
    if fmt in ("gray8", "gray1", "adam7_gray", "optimized"):
        np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    if fmt in ("rgb8", "adam7_rgb"):
        np.testing.assert_array_equal(got,
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def test_mini_tum_frames_equal_libpng_and_opencv(libpng_decoder):
    names = sorted(os.listdir(os.path.join(MINI_TUM, "rgb")))[:5]
    for n in names:
        p = os.path.join(MINI_TUM, "rgb", n)
        got = native.decode_gray8(p)
        np.testing.assert_array_equal(got, libpng_decoder(p))
        np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE))
        d = os.path.join(MINI_TUM, "depth", n)
        np.testing.assert_array_equal(native.decode_depth_mm(d, 5000.0),
                                      libpng_decoder(d, 5000.0))


def test_corrupt_png_raises(tmp_path):
    p = str(tmp_path / "bad.png")
    _write_png(p, np.zeros((8, 8), np.uint8))
    data = bytearray(open(p, "rb").read())
    data[40] ^= 0xFF     # inside IDAT: the chunk's CRC no longer matches
    open(p, "wb").write(bytes(data))
    with pytest.raises(IOError):
        native.decode_gray8(p)
    with pytest.raises(IOError):
        native.decode_gray8(str(tmp_path / "missing.png"))


@pytest.fixture(scope="module")
def rgbd_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefetch")
    rng = np.random.default_rng(4)
    n, h, w = 13, 16, 24
    grays, depths, pa, pb = [], [], [], []
    for i in range(n):
        g = rng.integers(0, 256, (h, w), np.uint8)
        d = rng.integers(0, 10000, (h, w)).astype(np.uint16)
        pa.append(str(root / f"g{i}.png"))
        pb.append(str(root / f"d{i}.png"))
        _write_png(pa[-1], g)
        _write_png(pb[-1], d)
        grays.append(g)
        depths.append(d)
    return grays, depths, pa, pb, h, w


@pytest.mark.parametrize("run", range(20))
def test_prefetcher_ordered_rgbd(rgbd_files, run):
    """Frames come back in order through a small ring and several workers
    (16 in the last run, more than the machine's cores), 20 times over: the
    claim protocol must not stall or reorder. The stream is read in a
    thread joined with a timeout, so a stall fails the test instead of
    hanging the run."""
    grays, depths, pa, pb, h, w = rgbd_files
    pf = native.Prefetcher(pa, pb, native.MODE_RGBD, w, h,
                           depth_factor=1000.0,
                           n_threads=16 if run == 19 else 1 + run % 4,
                           ring_cap=2 + run % 3)
    got = []

    def read():
        got.extend(pf)
        got.append(pf.next())
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout=60)
    assert not reader.is_alive(), f"stalled after {len(got)} frames"
    assert len(got) == len(pa) + 1 and got[-1] is None
    for i, (g, d) in enumerate(got[:-1]):
        np.testing.assert_array_equal(g, grays[i])
        np.testing.assert_array_equal(d, depths[i])
    pf.close()


def test_prefetcher_stereo_mode(tmp_path):
    rng = np.random.default_rng(5)
    h, w = 12, 18
    l = rng.integers(0, 256, (h, w), np.uint8)
    r = rng.integers(0, 256, (h, w), np.uint8)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    _write_png(lp, l)
    _write_png(rp, r)
    pf = native.Prefetcher([lp], [rp], native.MODE_STEREO, w, h)
    g, aux = pf.next()
    np.testing.assert_array_equal(g, l)
    np.testing.assert_array_equal(aux, r)
    assert aux.dtype == np.uint8
    pf.close()


def test_prefetcher_closed_early(rgbd_files):
    """Closing with frames still queued joins every worker."""
    grays, depths, pa, pb, h, w = rgbd_files
    pf = native.Prefetcher(pa, pb, native.MODE_RGBD, w, h, n_threads=4,
                           ring_cap=2)
    np.testing.assert_array_equal(pf.next()[0], grays[0])
    pf.close()


def test_delivery_cursor_moves_under_the_mutex():
    """The repair of the reference's ``dataset_loader.cc:360-361``: the
    consumer raises ``next_deliver`` inside the locked block, after it has
    freed the slot."""
    src = open(os.path.join(os.path.dirname(native.__file__),
                            "dataset_loader.cc")).read()
    body = src[src.index("int loader_next("):src.index("void loader_destroy(")]
    locked = body[body.index("std::unique_lock"):body.index("cv_free.notify")]
    assert "next_deliver = idx + 1" in locked
    assert locked.index("s.index = -1") < locked.index("next_deliver = idx + 1")
    assert "next_deliver++" not in src


def test_six_concurrent_first_builds_all_load(tmp_path):
    """Six processes build into one empty directory at the same moment;
    each must load a whole library and decode a frame."""
    build_dir = str(tmp_path / "build")
    frame = os.path.join(MINI_TUM, "rgb", "0.000000.png")
    code = ("import sys; from orb_slam_2_ros_tpu_torch import native; "
            f"native.load({build_dir!r}); "
            f"print(int(native.decode_gray8({frame!r}).sum()))")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [o[1] for o in outs]
    want = int(cv2.imread(frame, cv2.IMREAD_GRAYSCALE).astype(np.int64).sum())
    assert [int(o[0]) for o in outs] == [want] * 6
    assert [f for f in os.listdir(build_dir) if f.endswith(".so")] == [
        os.path.basename(native._library_path(build_dir))]


def _tree(k=5, L=3, seed=0):
    """A complete k-ary tree in the DBoW2 node layout (breadth first)."""
    rng = np.random.default_rng(seed)
    parents, leaf = [], []
    start, prev = 1, [0]
    for lvl in range(L):
        cur = []
        for p in prev:
            for _ in range(k):
                parents.append(p)
                leaf.append(lvl == L - 1)
                cur.append(start + len(cur))
        start += len(cur)
        prev = cur
    n = len(parents)
    return (k, L, np.array(parents, np.int32), np.array(leaf, bool),
            rng.integers(0, 256, (n, 32), np.uint8), rng.uniform(0, 3, n))


def test_native_orbvoc_parse_equals_python_parse(tmp_path):
    k, L, parents, is_leaf, descs, weights = _tree()
    b = str(tmp_path / "voc.bin")
    native.write_orbvoc_bin(b, k, L, parents, is_leaf, descs, weights)
    py = str(tmp_path / "voc_py.bin")
    tvoc.write_orbvoc_bin(py, k, L, parents, is_leaf, descs, weights)
    assert open(b, "rb").read() == open(py, "rb").read()
    t = str(tmp_path / "voc.txt")
    with open(t, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for p, lf, d, wt in zip(parents, is_leaf, descs, weights):
            f.write(f"{int(p)} {int(lf)} " + " ".join(map(str, d))
                    + f" {float(wt)!r}\n")
    for path, py_parse in ((b, tvoc._parse_bin_py), (t, tvoc._parse_txt_py)):
        got, want = native.parse_orbvoc(path), py_parse(path)
        assert got[:2] == want[:2] == (k, L)
        for a, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, w)


def test_load_orbvoc_chooses_its_reader_explicitly(tmp_path, monkeypatch):
    """``use_native`` picks the reader; without it the library's presence
    does. Both give the same vocabulary."""
    from orb_slam_2_ros_tpu_torch.config import SlamConfig
    k, L, parents, is_leaf, descs, weights = _tree()
    b = str(tmp_path / "voc.bin")
    tvoc.write_orbvoc_bin(b, k, L, parents, is_leaf, descs, weights)
    cfg = SlamConfig()
    calls = []
    monkeypatch.setattr(native, "parse_orbvoc",
                        lambda p, _f=native.parse_orbvoc:
                        calls.append(p) or _f(p))
    a = tvoc.load_orbvoc_binary(b, cfg, device="cpu", use_native=True)
    assert calls == [b]
    c = tvoc.load_orbvoc_binary(b, cfg, device="cpu", use_native=False)
    assert calls == [b]
    assert torch.equal(a.node_desc, c.node_desc)
    assert torch.equal(a.word_weight, c.word_weight)
    monkeypatch.setattr(native, "is_built", lambda *a: False)
    tvoc.load_orbvoc_binary(b, cfg, device="cpu")
    assert calls == [b]
    monkeypatch.setattr(native, "is_built", lambda *a: True)
    tvoc.load_orbvoc_binary(b, cfg, device="cpu")
    assert calls == [b, b]
