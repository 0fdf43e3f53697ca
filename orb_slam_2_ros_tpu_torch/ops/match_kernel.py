"""Fused masked best-two descriptor matching: the CUDA kernel and its plain
PyTorch version.

Port of ``orb_slam_2_ros_tpu/ops/pallas_match.py::masked_best_two``. For
each of N query descriptors: the best and second-best of M candidates by
Hamming distance, among the candidates that pass the window, octave-band,
stereo and validity gates given by the metadata rows

    row_meta (8, N) f32 = [u, v, r, oct_lo, oct_hi, ur, ok, 0]
    col_meta (8, M) f32 = [u, v, oct, ur, ok, 0, 0, 0]

Ties go to the lowest column. Rows with no candidate get distance
``INF_DIST`` (1024) and index 0, the convention of the reference's plain
matcher path (its Pallas kernel reports 32768 there instead).

``masked_best_two`` chooses by device only: CPU tensors take the plain
version, CUDA tensors the kernel (``csrc/masked_best_two.cu``) or an
exception. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from orb_slam_2_ros_tpu_torch import _build
from orb_slam_2_ros_tpu_torch.ops.hamming import best_two, hamming_matrix
from orb_slam_2_ros_tpu_torch.pipeline.metrics import span

MAX_COLS = 1 << 15      # keys pack the column into 15 bits
LAUNCHES = 0            # kernel launches since import (or the last reset)


def gate_mask(row_meta: torch.Tensor, col_meta: torch.Tensor) -> torch.Tensor:
    """(N, M) bool: the kernel's candidate gates, in the same f32 ops."""
    ru, rv, rr = row_meta[0][:, None], row_meta[1][:, None], row_meta[2][:, None]
    rlo, rhi, rur = row_meta[3][:, None], row_meta[4][:, None], row_meta[5][:, None]
    rok = row_meta[6][:, None] > 0
    cu, cv, co = col_meta[0][None, :], col_meta[1][None, :], col_meta[2][None, :]
    cur, cok = col_meta[3][None, :], col_meta[4][None, :] > 0
    ok = (rok & cok
          & (torch.abs(ru - cu) <= rr) & (torch.abs(rv - cv) <= rr)
          & (co >= rlo) & (co <= rhi))
    return ok & ((cur <= 0) | (torch.abs(rur - cur) <= rr))


def masked_best_two_reference(desc_rows, row_meta, desc_cols, col_meta):
    """Plain PyTorch version on any device: ``hamming_matrix`` + the gates
    + ``best_two``. Materialises (N, M)."""
    return best_two(hamming_matrix(desc_rows, desc_cols),
                    gate_mask(row_meta, col_meta))


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 5)


def bind(lib, variant=None):
    """The launch function of a built library: ``masked_best_two_launch``,
    or with ``variant`` one of the tile shapes the source was tuned among
    (``masked_best_two_launch_variant``). Both take the four inputs, N, M,
    four output rows and the stream, and return the CUDA error code."""
    if variant is None:
        fn = lib.masked_best_two_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        return fn
    fn = lib.masked_best_two_launch_variant
    fn.argtypes = _ARGTYPES + [ctypes.c_int]
    fn.restype = ctypes.c_int
    return lambda *args: fn(*args, variant)


@functools.lru_cache(maxsize=None)
def _launch():
    return bind(_build.load("masked_best_two"))


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch_checked(launch, stream, desc_rows, row_meta, desc_cols, col_meta):
    """Check the inputs, allocate the outputs as one (4, N) int32 tensor
    beside them, call ``launch`` with the raw pointers (inputs, N, M, the
    four output rows, ``stream``) and raise unless it returns 0. Counts the
    launch. Nothing here depends on the device, so the CPU tests drive it
    with a stand-in for ``launch``."""
    global LAUNCHES
    dev = desc_rows.device
    N, M = desc_rows.shape[0], desc_cols.shape[0]
    if M >= MAX_COLS:
        raise ValueError(f"M={M} candidates; the kernel takes M < {MAX_COLS}")
    _check("desc_rows", desc_rows, torch.int32, (N, 8), dev)
    _check("row_meta", row_meta, torch.float32, (8, N), dev)
    _check("desc_cols", desc_cols, torch.int32, (M, 8), dev)
    _check("col_meta", col_meta, torch.float32, (8, M), dev)
    out = torch.empty((4, N), dtype=torch.int32, device=dev)
    p, step = out.data_ptr(), 4 * N
    err = launch(desc_rows.data_ptr(), row_meta.data_ptr(),
                 desc_cols.data_ptr(), col_meta.data_ptr(), N, M,
                 p, p + step, p + 2 * step, p + 3 * step, stream)
    if err != 0:
        raise RuntimeError(f"masked_best_two kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out.unbind(0)


def masked_best_two_cuda(desc_rows, row_meta, desc_cols, col_meta,
                         launch=None):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    Returns (best_idx, best_d, second_idx, second_d), each (N,) int32: the
    four rows of one (4, N) allocation. ``launch`` replaces the package's
    own build of the kernel with another ``bind`` result (for timing one
    build against another); the port never passes it."""
    dev = desc_rows.device
    if dev.type != "cuda":
        raise ValueError(f"masked_best_two_cuda needs CUDA tensors, got {dev}")
    if launch is None:
        launch = _launch()
    with torch.cuda.device_of(desc_rows):   # launch on the tensors' card
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _launch_checked(launch, stream, desc_rows, row_meta, desc_cols,
                               col_meta)


@span("b1")
def masked_best_two(desc_rows, row_meta, desc_cols, col_meta):
    """Dispatch by device: the plain version for CPU tensors, the kernel
    for CUDA tensors (which raises rather than fall back). Its span ``b1``
    holds the host side of the call."""
    if desc_rows.device.type == "cpu":
        return masked_best_two_reference(desc_rows, row_meta, desc_cols,
                                         col_meta)
    return masked_best_two_cuda(desc_rows, row_meta, desc_cols, col_meta)
