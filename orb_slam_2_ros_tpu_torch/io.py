"""Synthetic RGB-D sequences and trajectory metrics, shared with the
reference: both modules are host numpy and import no JAX."""

from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD  # noqa: F401
from orb_slam_2_ros_tpu.io.trajectory import ate_rmse  # noqa: F401
