"""A two-axis mesh of process groups, and the collectives the sharded
solvers use.

Port of ``orb_slam_2_ros_tpu/parallel/mesh.py``. JAX runs one program over
several devices from one process (``shard_map``); ``torch.distributed``
runs one process per device. The mesh is therefore a small object over the
initialized world: rank ``r = i_kf * n_mp + i_mp``, one process group per
row (the ``mp`` axis: the ``n_mp`` ranks that share ``i_kf``) and per column
(the ``kf`` axis). ``kf`` partitions the keyframe rows of the local BA's
observation table; ``mp`` partitions map points and observation edges.

The reference's primitives map as follows: ``psum`` is ``all_sum``
(``all_reduce`` on a copy), ``all_gather(tiled=True)`` is ``gather_rows``
(rank order = axis index), ``psum_scatter(tiled=True)`` is ``sum_scatter_rows``
(the full sum, of which each rank keeps its own block of rows: what
``psum_scatter`` computes, on every backend and every PyTorch version) and
``axis_index`` is ``Mesh.index``. ``P(axis)`` inputs are cut with
``shard_rows``; ``P()`` ones are passed whole.

The backend is NCCL for a mesh on the card and gloo for one on the CPU; no
other pairing is built, so a mesh never moves tensors off the device it was
asked for.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

class Mesh:
    """The ranks of the initialized world laid out as an (n_kf, n_mp)
    grid. ``shape`` maps each axis to its size; ``group(axis)`` is the
    process group of this rank's ranks along ``axis``; ``index(axis)`` is
    this rank's position along it; ``device`` is where its tensors live."""

    def __init__(self, n_kf: int, n_mp: int, device: torch.device):
        world = dist.get_world_size()
        rank = dist.get_rank()
        if n_kf * n_mp != world:
            raise ValueError(f"a {n_kf} x {n_mp} mesh needs {n_kf * n_mp} "
                             f"ranks, the world has {world}")
        self.shape = {"kf": n_kf, "mp": n_mp}
        self.device = device
        self.rank = rank
        self.world = world
        self._index = {"kf": rank // n_mp, "mp": rank % n_mp}
        self._groups = {}
        # every rank creates every group, in the same order
        for i in range(n_kf):
            ranks = [i * n_mp + j for j in range(n_mp)]
            g = dist.new_group(ranks)
            if rank in ranks:
                self._groups["mp"] = g
        for j in range(n_mp):
            ranks = [i * n_mp + j for i in range(n_kf)]
            g = dist.new_group(ranks)
            if rank in ranks:
                self._groups["kf"] = g

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]


def make_mesh(n_kf: int = 1, n_mp: int = None, device=None) -> Mesh:
    """A mesh over every rank of the initialized world, ``n_mp`` =
    world / ``n_kf`` by default. ``device`` None follows the backend (the
    card for NCCL, the CPU for gloo); a ``cuda`` mesh needs NCCL and a
    ``cpu`` one gloo, and anything else raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    if n_mp is None:
        n_mp = world // n_kf
    backend = dist.get_backend()
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"a cuda mesh runs on NCCL; the process group "
                               f"uses {backend}")
        device = torch.device("cuda", torch.cuda.current_device())
    elif device.type == "cpu":
        if backend != "gloo":
            raise RuntimeError(f"a cpu mesh runs on gloo; the process group "
                               f"uses {backend}")
    else:
        raise ValueError(f"no backend for a mesh on {device}")
    return Mesh(n_kf, n_mp, device)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's block of rows of ``x`` along ``axis`` (``P(axis)``);
    the row count must divide by the axis size."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} "
                         f"{axis} shards")
    b = x.shape[0] // n
    i = mesh.index(axis)
    return x[i * b:(i + 1) * b]


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``n`` rows."""
    pad = (-x.shape[0]) % n
    if pad == 0:
        return x
    return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                     dtype=x.dtype, device=x.device)])


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``psum``), the same
    bits on every rank."""
    y = x.clone().contiguous()
    dist.all_reduce(y.reshape(-1) if y.dim() == 0 else y, group=group)
    return y


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` stacked along dim 0 in rank order
    (``all_gather(..., tiled=True)``)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def sum_scatter_rows(full: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows of the sum of ``full`` over ``group``
    (``psum_scatter(..., tiled=True)``)."""
    n = dist.get_world_size(group)
    b = full.shape[0] // n
    i = dist.get_rank(group)
    return all_sum(full, group)[i * b:(i + 1) * b]
