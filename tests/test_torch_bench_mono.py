"""Port parity of the bench's monocular pass (``bench.py:292-311``): the
port's ``bench_mono`` against the reference's steps, on the 24-frame arc of
``tests/test_torch_mono_system.py`` (320x240, 500 features, chunks of 8).
The bench's 32 warm-up images of 96 become 8 of 24, so that 16 are timed.

The two sides draw their initializer's RANSAC samples from different
generators (trap 8), so they are compared by outcome: the OK frames of the
timed call equal and nonzero, and the whole run's states equal. Kept apart
from ``tests/test_torch_bench.py`` because the reference's two-view
initialization alone takes about a minute on a CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu_torch import bench as tbench
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_mono_tracking import mono_cfg

torch.set_num_threads(2)

N_FRAMES = 24
N_WARM = 8


def test_mono_pass_matches_reference():
    cfg = mono_cfg()
    ds = SyntheticRGBD(cfg, n_frames=N_FRAMES, seed=0, radius=1.5,
                       angle_range=0.9)
    grays = np.stack([ds[i][0] for i in range(N_FRAMES)])
    ts = ds.timestamps

    # the reference's steps (bench.py:292-311): float images to initialize
    # and warm up, then the rest as one wire-format call
    js = jslam.System(cfg, enable_loop_closing=False)
    js.track_chunk(grays[:N_WARM], None, ts[:N_WARM])
    g_w = js.tracker.to_wire(grays[N_WARM:], np.zeros_like(grays[N_WARM:]))[0]
    g_dev = jax.device_put(jnp.asarray(g_w))
    js.track_chunk(g_dev, jnp.zeros_like(g_dev, dtype=jnp.uint16),
                   ts[N_WARM:], defer_fetch=True)
    j_ok = sum(r.state == ttrack.OK for r in js.tracker.flush())

    seq = tbench._CachedSeq(grays, None, ts, None, None)
    fps, t_ok, system = tbench.bench_mono(
        convert.config_from_dict(dataclasses.asdict(cfg)), seq,
        device="cpu", n_warm=N_WARM)
    assert system.tracker.chunk == 8
    assert fps > 0
    assert t_ok == j_ok == N_FRAMES - N_WARM
    # the port returned the timed call's records: none is left to fetch
    assert system.tracker.flush() == []
    assert ([r.state for r in system.records]
            == [r.state for r in js.records])
    assert [r.frame_id for r in system.records] == list(range(N_FRAMES))
