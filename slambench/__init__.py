"""The benchmark of the PyTorch and CUDA port, ``orb_slam_2_ros_tpu_torch``.

One command runs one cell of ``BENCHMARK.json``::

    python -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Configurations, traffic mixes, per-layer metrics and correctness limits are
files found by name (``configs/``, ``traffic/``, ``metrics/``, ``limits/``);
see ``README.md``. Nothing here imports JAX or the JAX package.
"""
