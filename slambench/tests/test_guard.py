"""Nothing the harness runs loads JAX or the JAX package. Top-level module
names are compared whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys
import types

from slambench import run

from conftest import REPO, SLAMBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "orb_slam_2_ros_tpu"}


def test_names_are_compared_whole():
    added = {"orb_slam_2_ros_tpu_torch_x": False, "jaxtyping_x": False,
             "jax.numpy": True, "orb_slam_2_ros_tpu.io": True}
    try:
        for name, bad in added.items():
            sys.modules[name] = types.ModuleType(name)
            assert (name in run.forbidden_modules()) is bad
            del sys.modules[name]
    finally:
        for name in added:
            sys.modules.pop(name, None)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module of the harness and the port's entry point, imported in
    a fresh interpreter."""
    mods = ["slambench." + os.path.splitext(f)[0]
            for f in ("run.py", "cell.py", "check.py", "control.py",
                      "profile.py", "stream.py")]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import slambench.scene.render, slambench.reference.orb\n"
            "import slambench.reference.b1, slambench.reference.poses\n"
            "from slambench import profile\n"
            "profile.layer_ranges()\n"
            "import orb_slam_2_ros_tpu_torch.pipeline.slam\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            f" & set({sorted(FORBIDDEN)!r}))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=300)


def test_no_source_imports_them():
    for dirpath, _, files in os.walk(SLAMBENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_no_source_reads_the_reference_or_fixed_temporary_paths():
    for dirpath, _, files in os.walk(SLAMBENCH):
        for f in files:
            if f.endswith(".py") and f != os.path.basename(__file__):
                text = open(os.path.join(dirpath, f)).read()
                for bad in ("/tmp", "/dev/shm", "gettempdir", "bench.py",
                            "orb_slam_2_ros_tpu/"):
                    assert bad not in text, (f, bad)
