"""Process-group initialization and the global mesh.

Port of ``orb_slam_2_ros_tpu/parallel/multihost.py``. Every process runs
the same program on the same frames; ``initialize`` joins the job's
rendezvous and the global mesh spans all of its ranks, one per device. The
sharded solvers' reductions are the only collectives.

One command per host (one rank per card):

    python -m orb_slam_2_ros_tpu_torch.run ... \\
        --coordinator 10.0.0.1:1234 --num-hosts 4 --host-id $ID

or, on the cards of one host, ``torchrun --nproc-per-node N -m
orb_slam_2_ros_tpu_torch.run ... --mesh``, whose environment variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``) are read through
``env://``. NCCL takes one rank per card, so one card runs a world of 1.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from orb_slam_2_ros_tpu_torch.parallel.mesh import make_mesh

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long a rank waits for the others, at the rendezvous and in each
# collective, before it raises
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=600)


def _launched_by_torchrun() -> bool:
    return all(v in os.environ for v in _TORCHRUN_VARS)


def _backend(device, rank: int) -> str:
    """NCCL on the card, after pinning this rank's card (``LOCAL_RANK``, or
    the rank modulo the host's card count); gloo on the CPU. A card without
    NCCL, or no card, raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process-group backend for {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda process group needs a card and "
                           "torch.cuda.is_available() is False")
    if not dist.is_nccl_available():
        raise RuntimeError("a cuda process group runs on NCCL, which this "
                           "PyTorch build lacks")
    local = int(os.environ.get("LOCAL_RANK",
                               rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return "nccl"


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None, device="cuda") -> int:
    """Join the job's process group and return this process's rank.

    ``coordinator`` ("host:port" of rank 0's store) with ``num_processes``
    and ``process_id`` rendezvous over TCP; without it, ``torchrun``'s
    environment variables are used where they are set. With neither, on one
    host, this is a no-op that returns 0 and makes no group. A second call
    returns the rank of the first. A failed rendezvous raises."""
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator is None and not _launched_by_torchrun():
        return 0
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes "
                             "and this process's id")
        rank = process_id
        init = dict(init_method=f"tcp://{coordinator}",
                    world_size=num_processes, rank=process_id)
    else:
        rank = int(os.environ["RANK"])
        init = dict(init_method="env://")
    dist.init_process_group(_backend(device, rank), timeout=RENDEZVOUS_TIMEOUT,
                            **init)
    return dist.get_rank()


def global_mesh(n_kf: int = 1, n_mp: int = None, device="cuda"):
    """A mesh over every rank of the job, ``mp`` innermost (the sharded
    GBA's per-iteration gathers stay among a host's cards; the ``kf`` axis
    carries the local BA's much smaller camera system across hosts). With
    no process group yet, a world of 1 is made in this process."""
    if not dist.is_initialized():
        if initialize(device=device) == 0 and not dist.is_initialized():
            dist.init_process_group(_backend(device, 0),
                                    store=dist.HashStore(),
                                    world_size=1, rank=0)
    return make_mesh(n_kf=n_kf, n_mp=n_mp, device=device)


def local_session_shard(items):
    """This process's share of per-session work (one SLAM session per
    process, maps merged with ``System.merge_map``): ``items[rank::world]``,
    all of them without a process group."""
    if not dist.is_initialized():
        return items
    return items[dist.get_rank()::dist.get_world_size()]


def shutdown():
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
