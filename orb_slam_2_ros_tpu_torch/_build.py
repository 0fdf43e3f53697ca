"""Build the package's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface under ``_build/`` (ignored by git), named by a hash of its
source and flags, so an edited source rebuilds and an unchanged one loads
at once. The library is bound with ``ctypes``; no PyTorch headers are
compiled, which keeps a build to seconds.

There is no fallback: a missing ``nvcc`` or a failed build raises, with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def build(name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile csrc/<name>.cu unless its library, keyed on a hash of the
    source and the flags, is already built; return the library's path.
    Raises RuntimeError if nvcc is missing or fails."""
    src = os.path.join(SRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(build_dir, f"{name}_{key.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build kernel {name!r}: nvcc not found (looked in "
            "$CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name!r} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: concurrent builders never see half a file
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    return ctypes.CDLL(build(name))
