"""Configuration: the reference's frozen dataclasses, used as they are.

``orb_slam_2_ros_tpu.config`` imports no JAX, so the port shares it rather
than keeping a second copy that could drift.
"""

from orb_slam_2_ros_tpu.config import (  # noqa: F401
    CameraConfig, MapConfig, MatcherConfig, OrbConfig, SENSOR_MONOCULAR,
    SENSOR_RGBD, SENSOR_STEREO, SlamConfig, SolverConfig, TrackingConfig)
