"""Guards of the PyTorch port: it never imports JAX nor the JAX package, it
runs on the card unless asked for the CPU, and it turns TF32 off."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import orb_slam_2_ros_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = orb_slam_2_ros_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py, imported in a fresh
    interpreter, pull in neither JAX nor any module of the JAX package."""
    mods = _port_modules() + ["chip_smoke"]
    assert len(mods) >= 30
    pkg = orb_slam_2_ros_tpu_torch.__name__
    for new in ("geometry.triangulate", "solvers.ba", "ops.segment",
                "pipeline.local_mapping", "pipeline.slam", "eval_mapping",
                "geometry.sim3", "place.vocabulary", "place.database",
                "solvers.sim3_solver", "solvers.pose_graph",
                "pipeline.loop_closing", "pipeline.metrics",
                "eval_loop_closing", "solvers.pnp", "pipeline.relocalization",
                "frontend.stereo", "solvers.initializer",
                "pipeline.mono_init", "pipeline.map_merge", "run",
                "presets", "io.datasets", "io.trajectory", "geometry.rectify",
                "native", "pipeline.frame_drawer", "parallel",
                "parallel.mesh", "parallel.multihost", "parallel.dist_ba",
                "parallel.dist_pose"):
        assert f"{pkg}.{new}" in mods, new
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'orb_slam_2_ros_tpu' "
            "or m.startswith('orb_slam_2_ros_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'orb_slam_2_ros_tpu_torch.io.synthetic' in sys.modules\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_reference_import():
    """No source of the port, nor chip_smoke.py, has an import statement of
    the JAX package or of JAX."""
    pkg_dir = os.path.dirname(orb_slam_2_ros_tpu_torch.__file__)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(pkg_dir):
        if "_build" in dirs:
            dirs.remove("_build")       # build outputs, not sources
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 20
    pat = re.compile(r"^\s*(from|import)\s+(orb_slam_2_ros_tpu|jax|jaxlib)"
                     r"(\.|\s|$)", re.M)
    bad = []
    for path in paths:
        with open(path) as f:
            bad += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                    for m in pat.finditer(f.read())]
    assert not bad, bad


def test_tracker_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from orb_slam_2_ros_tpu_torch.config import SlamConfig
    from orb_slam_2_ros_tpu_torch.map import state as map_state
    from orb_slam_2_ros_tpu_torch.pipeline import tracking

    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(map_state, "empty",
                        lambda *a, **k: built.append(a) or 1 / 0)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tracking.Tracker(SlamConfig())
    assert not built            # no tracker was built, on any device


def test_system_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from orb_slam_2_ros_tpu_torch.config import SlamConfig
    from orb_slam_2_ros_tpu_torch.map import state as map_state
    from orb_slam_2_ros_tpu_torch.pipeline import slam

    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(map_state, "empty",
                        lambda *a, **k: built.append(a) or 1 / 0)
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing
    monkeypatch.setattr(loop_closing, "empty_state",
                        lambda *a, **k: built.append(a) or 1 / 0)
    # loop closing on is the default; with or without it, and with or
    # without a vocabulary, no device named means the card
    from orb_slam_2_ros_tpu_torch.config import SENSOR_STEREO
    from orb_slam_2_ros_tpu_torch.pipeline import relocalization
    monkeypatch.setattr(relocalization.Relocalizer, "__init__",
                        lambda *a, **k: built.append(a) or 1 / 0)
    from orb_slam_2_ros_tpu_torch.config import SENSOR_MONOCULAR
    from orb_slam_2_ros_tpu_torch.pipeline import mono_init
    monkeypatch.setattr(mono_init.MonoInitializer, "__init__",
                        lambda *a, **k: built.append(a) or 1 / 0)
    # loop closing (and with it relocalization) on is the default; with or
    # without it, with or without a vocabulary, a loaded map or
    # localization-only mode, RGB-D, stereo or mono, no device named means
    # the card
    for cfg in (SlamConfig(), SlamConfig(sensor=SENSOR_STEREO),
                SlamConfig(sensor=SENSOR_MONOCULAR),
                SlamConfig(localization_only=True)):
        for kwargs in (dict(), dict(enable_loop_closing=True),
                       dict(enable_loop_closing=False), dict(vocab=object()),
                       dict(load_map="no_such_map.npz")):
            with pytest.raises(RuntimeError, match="device=\"cpu\""):
                slam.System(cfg, **kwargs)
    assert not built            # nothing was built, on any device


def test_mono_initializer_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    from orb_slam_2_ros_tpu_torch.config import SENSOR_MONOCULAR, SlamConfig
    from orb_slam_2_ros_tpu_torch.pipeline import mono_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        mono_init.MonoInitializer(SlamConfig(sensor=SENSOR_MONOCULAR))
    mi = mono_init.MonoInitializer(SlamConfig(sensor=SENSOR_MONOCULAR),
                                   device="cpu")
    # the initializer's RANSAC stream: its own generator, seeded as the
    # reference seeds its key (cfg.seed + 2)
    want = torch.Generator().manual_seed(SlamConfig().seed + 2)
    assert torch.equal(mi.generator.get_state(), want.get_state())


def test_state_builders_require_a_device():
    from orb_slam_2_ros_tpu_torch import convert
    from orb_slam_2_ros_tpu_torch.config import SlamConfig
    from orb_slam_2_ros_tpu_torch.map import state as map_state

    with pytest.raises(TypeError):
        map_state.empty(SlamConfig())
    with pytest.raises(TypeError):
        convert.map_state_from_numpy({})
    with pytest.raises(TypeError):
        convert.track_carry_from_numpy({})
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing
    from orb_slam_2_ros_tpu_torch.place import database, vocabulary
    with pytest.raises(TypeError):
        loop_closing.empty_state(SlamConfig())
    with pytest.raises(TypeError):
        database.empty(SlamConfig())
    with pytest.raises(TypeError):
        vocabulary.train_vocabulary(None, SlamConfig())
    with pytest.raises(TypeError):
        vocabulary.load_npz("vocabulary.npz")
    with pytest.raises(TypeError):
        vocabulary.load_orbvoc_binary("vocabulary.bin", SlamConfig())
    with pytest.raises(TypeError):
        vocabulary.load_orbvoc("vocabulary.txt", SlamConfig())
    for fn in (convert.vocabulary_from_numpy, convert.loop_state_from_numpy,
               convert.dense_gba_state_from_numpy, convert.frame_from_numpy,
               convert.bow_database_from_numpy):
        with pytest.raises(TypeError):
            fn({})


def test_wrappers_take_the_plain_version_only_on_the_cpu(monkeypatch):
    """Relocalization and the stereo frame reach the matcher kernel only
    through ``masked_best_two``: a CPU tensor takes the plain version, a
    CUDA tensor the kernel, and the kernel's failure is an exception, never
    a fallback."""
    from orb_slam_2_ros_tpu_torch.ops import match_kernel

    def failing(*args):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(match_kernel, "masked_best_two_cuda", failing)
    rows = torch.zeros((4, 8), dtype=torch.int32)
    meta = torch.zeros((8, 4))
    out = match_kernel.masked_best_two(rows, meta, rows, meta)
    assert [o.shape for o in out] == [(4,)] * 4
    fake = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        match_kernel.masked_best_two(fake, meta.to("meta"), fake,
                                     meta.to("meta"))


def test_tf32_disabled():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _permuted_twice(fn, n, seed=0):
    """fn(order) for the identity and for a random permutation of n
    contributions."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    return fn(torch.arange(n)), fn(perm)


def test_float_sums_with_duplicate_targets_do_not_depend_on_the_order():
    """Where loop closing adds floats onto repeated targets (the pose
    graph's blocks, the global BA's landmark sums, the BoW weights), each
    sum goes through ``ops/segment.segment_sum`` (PyTorch's deterministic
    ``index_add_``: the same result on every run of the same inputs) or an
    exact form. Here each runs twice on the CPU, the second time with its
    contributions in another order: the BoW weights are equal to the last
    bit, the others within 1e-5 (a float sum in another order)."""
    from orb_slam_2_ros_tpu_torch.config import SlamConfig
    from orb_slam_2_ros_tpu_torch.geometry import sim3
    from orb_slam_2_ros_tpu_torch.ops.segment import segment_sum
    from orb_slam_2_ros_tpu_torch.place import vocabulary
    from orb_slam_2_ros_tpu_torch.solvers import ba, pose_graph

    rng = np.random.default_rng(0)

    # the primitive: many contributions to few rows
    idx = torch.from_numpy(rng.integers(0, 7, 5000))
    vals = torch.from_numpy(rng.normal(0, 1, (5000, 12)).astype(np.float32))
    a, b = _permuted_twice(
        lambda o: segment_sum(idx[o], vals[o], 7), 5000)
    assert torch.equal(a, segment_sum(idx, vals, 7))    # the same run twice
    assert a.shape == b.shape == (7, 12)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)
    assert not torch.are_deterministic_algorithms_enabled()     # scoped

    # BoW weights: count x idf is exact, so any keypoint order gives the
    # same merged weights per word, bit for bit
    P, W = 300, 40
    word = torch.from_numpy(rng.integers(-1, W, P).astype(np.int32))
    idf = torch.from_numpy(rng.uniform(0.5, 3, W).astype(np.float32))
    tf = torch.where(word >= 0, idf[word.clamp(min=0).long()],
                     torch.zeros(()))

    def dense_weights(o):
        w = vocabulary.bow_weights(word[o], tf[o], W)
        return vocabulary.dense_bow(word[o], w, W)

    a, b = _permuted_twice(dense_weights, P)
    assert torch.equal(a, b) and abs(float(a.sum()) - 1.0) < 1e-5

    # the pose graph: the same edges in another order
    K, E = 8, 40
    xi = torch.from_numpy(rng.normal(0, 0.3, (K, 7)).astype(np.float32))
    q, t, s = sim3.exp(xi)
    ei = torch.from_numpy(rng.integers(0, K - 1, E))
    ej = torch.clamp(ei + torch.from_numpy(rng.integers(1, 3, E)), max=K - 1)
    rq, rt, rs = sim3.exp(torch.from_numpy(
        rng.normal(0, 0.3, (E, 7)).astype(np.float32)))
    w = torch.from_numpy(rng.uniform(0.5, 2, E).astype(np.float32))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True

    def graph(o):
        return pose_graph.optimize_essential_graph(
            q, t, s, ei[o], ej[o], rq[o], rt[o], rs[o], w[o], fixed,
            SlamConfig(), iters=3)

    a, b = _permuted_twice(graph, E)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)

    # the global BA's landmark sums: the same observations with the
    # keyframe rows in another order (structure-only body)
    Kk, Pp, M = 6, 50, 40
    cfg = SlamConfig()
    pos = torch.from_numpy(np.concatenate(
        [rng.uniform(-1, 1, (M, 2)), rng.uniform(3, 5, (M, 1))], -1).astype(
            np.float32))
    kq = torch.zeros(Kk, 4)
    kq[:, 0] = 1
    kt = torch.from_numpy(rng.normal(0, 0.05, (Kk, 3)).astype(np.float32))
    kf_mp = torch.from_numpy(rng.integers(0, M, (Kk, Pp)).astype(np.int32))
    xc = pos[kf_mp.long()] + kt[:, None]
    uv = torch.stack([cfg.camera.fx * xc[..., 0] / xc[..., 2] + cfg.camera.cx,
                      cfg.camera.fy * xc[..., 1] / xc[..., 2] + cfg.camera.cy],
                     -1) + torch.from_numpy(
        rng.normal(0, 0.5, (Kk, Pp, 2)).astype(np.float32))
    ur = uv[..., 0] - cfg.camera.bf / xc[..., 2]

    def gba(o):
        st = ba.dense_gba_init(
            uv[o], ur[o], torch.zeros((Kk, Pp), dtype=torch.int32), kf_mp[o],
            torch.ones((Kk, Pp), dtype=torch.bool), kq[o], kt[o],
            torch.zeros(Kk, dtype=torch.bool), pos,
            torch.ones(M, dtype=torch.bool), Kk, M, cfg)
        return ba.dense_gba_chunk(st, cfg, n_iters=3, structure_only=True).pos

    a, b = _permuted_twice(gba, Kk)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_run_main_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """``run.main`` without ``--device`` means the card: without one it
    raises before it reads or builds anything."""
    from orb_slam_2_ros_tpu_torch import run
    from orb_slam_2_ros_tpu_torch.io import datasets

    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(datasets.TumRGBD, "__init__",
                        lambda *a, **k: built.append(a) or 1 / 0)
    for argv in (["--dataset", "synthetic", "--frames", "4"],
                 ["--dataset", "tum", "--path", "tests/data/mini_tum"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            run.main(argv)
    assert run.build_parser().parse_args([]).device == "cuda"
    assert not built


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails, or none at all, raises with the
    compiler's output, and nothing is left in the build directory."""
    from orb_slam_2_ros_tpu_torch import native

    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build(str(tmp_path / "a"))
    assert os.listdir(tmp_path / "a") == []
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build(str(tmp_path / "b"))
    assert not native.is_built(str(tmp_path / "b"))


def test_drawing_and_decoding_import_no_opencv(tmp_path):
    """The debug image, the PNG writer, the native decoder and the dataset
    loaders run in a fresh interpreter without OpenCV or PIL."""
    png = str(tmp_path / "x.png")
    code = (
        "import sys, numpy as np\n"
        "from orb_slam_2_ros_tpu_torch import native, run\n"
        "from orb_slam_2_ros_tpu_torch.io import datasets\n"
        "from orb_slam_2_ros_tpu_torch.pipeline import frame_drawer\n"
        "img = frame_drawer.draw_frame(np.zeros((40, 50)), "
        "np.array([[10.0, 10.0]]), np.array([True]), np.array([True]), 2, 1)\n"
        f"frame_drawer.write_png({png!r}, img)\n"
        f"g = native.decode_gray8({png!r})\n"
        "assert g.shape == (60, 50)\n"
        "ds = datasets.TumRGBD('tests/data/mini_tum')\n"
        "assert ds[0][0].shape == (480, 640)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'PIL'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
