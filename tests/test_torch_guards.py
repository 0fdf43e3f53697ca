"""Guards of the PyTorch port: it never imports JAX nor the JAX package, it
runs on the card unless asked for the CPU, and it turns TF32 off."""

import os
import pkgutil
import re
import subprocess
import sys

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
    assert len(mods) >= 20
    pkg = orb_slam_2_ros_tpu_torch.__name__
    for new in ("geometry.triangulate", "solvers.ba", "ops.segment",
                "pipeline.local_mapping", "pipeline.slam", "eval_mapping"):
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
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        slam.System(SlamConfig(), enable_loop_closing=False)
    assert not built            # nothing was built, on any device
    # loop closing is the reference's default and is not ported: asking for
    # it, or not saying, raises before anything else happens
    with pytest.raises(NotImplementedError, match="enable_loop_closing=False"):
        slam.System(SlamConfig(), enable_loop_closing=True)
    with pytest.raises(NotImplementedError, match="enable_loop_closing=False"):
        slam.System(SlamConfig())


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


def test_tf32_disabled():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
