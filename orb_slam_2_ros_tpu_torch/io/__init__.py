"""Host-side data for the port: synthetic RGB-D sequences with ground truth
(``synthetic.py``) and the trajectory error metric (``trajectory.py``). Both
are numpy only and are the port's own copies of the reference's modules."""

from orb_slam_2_ros_tpu_torch.io.synthetic import (  # noqa: F401
    SyntheticRGBD, render_frames)
from orb_slam_2_ros_tpu_torch.io.trajectory import ate_rmse, umeyama_align  # noqa: F401
