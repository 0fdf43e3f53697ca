"""The distributed back end: the global BA's point pool and edge set, the
local BA's observation rows and the pose LM's edges sharded over a mesh of
``torch.distributed`` process groups, one process per device.

Port of ``orb_slam_2_ros_tpu/parallel``. Every rank runs the same program
on the same frames; only the reductions of the sharded solvers are
collective (``all_reduce`` over NCCL on the card, gloo on the CPU).
"""
