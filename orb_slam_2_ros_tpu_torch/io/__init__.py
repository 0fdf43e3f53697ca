"""Host-side data for the port: synthetic RGB-D and stereo sequences with
ground truth (``synthetic.py``), the trajectory files and metrics
(``trajectory.py``) and the TUM, KITTI and EuRoC loaders (``datasets.py``,
decoding through ``native/``). Each is the port's own copy of the
reference's module."""

from orb_slam_2_ros_tpu_torch.io.synthetic import (  # noqa: F401
    SyntheticRGBD, SyntheticStereo, render_frames)
from orb_slam_2_ros_tpu_torch.io.trajectory import (  # noqa: F401
    ate_rmse, read_tum, umeyama_align, write_kitti, write_tum)
