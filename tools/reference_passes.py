#!/usr/bin/env python3
"""Run the JAX reference's hard pass or monocular pass once, on whatever
backend JAX finds, and print its counts and ATE.

    JAX_PLATFORMS=cpu python tools/reference_passes.py hard
    JAX_PLATFORMS=cpu python tools/reference_passes.py mono

``hard``: the reference bench's hard pass (``bench.py:224-251``): 288
frames of the ``twoloop`` trajectory with ``exposure_drift=0.25``,
``System(cfg, vocab=voc)`` in chunks of 16 and ``flush()``, the vocabulary
trained (k = 10, 4 levels, seed 0) on the descriptors of every 24th frame
of the 224-frame loop, as the bench's full-system pass trains it. No
warm-up and no ``reset()``. Per chunk: the frames OK so far, the loops
closed, and the detection verdict still queued.

``mono``: the reference bench's monocular pass (``bench.py:292-311``):
``System(SlamConfig(sensor=SENSOR_MONOCULAR), enable_loop_closing=False)``
over the 96-frame orbit, the first 32 frames, then the other 64. OK
counts over both parts, the initialization frame, and the ATE of the
tracked centres after a Sim3 alignment.

Both at the full operating point (640x480, 1200 features, 8 levels). The
last line is one JSON object with the numbers.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hard():
    import jax
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu.frontend import frame as frame_mod
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
    from orb_slam_2_ros_tpu.io.trajectory import ate_rmse
    from orb_slam_2_ros_tpu.pipeline.slam import System
    from orb_slam_2_ros_tpu.pipeline.tracking import OK
    from orb_slam_2_ros_tpu.place import vocabulary

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    loop = SyntheticRGBD(cfg, n_frames=224, seed=0, trajectory="loop")
    descs = []
    for i in range(0, 224, 24):
        g, d = loop[i]
        f = frame_mod.build_rgbd(jnp.asarray(g, jnp.float32),
                                 jnp.asarray(d, jnp.float32), cfg)
        descs.append(np.asarray(jax.device_get(f.kps.desc))[
            np.asarray(jax.device_get(f.valid))])
    voc = vocabulary.train_vocabulary(np.concatenate(descs), cfg, seed=0)
    n = 288
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0, trajectory="twoloop",
                       exposure_drift=0.25)
    system = System(cfg, vocab=voc)
    C = system.tracker.chunk
    t0 = time.perf_counter()
    for w0 in range(0, n, C):
        grays = np.stack([ds[i][0] for i in range(w0, w0 + C)])
        depths = np.stack([ds[i][1] for i in range(w0, w0 + C)])
        system.track_chunk(grays, depths, list(ds.timestamps[w0:w0 + C]))
        lc = system.loop_closer
        n_ok = sum(r.state == OK for r in system.records)
        print(f"chunk {w0 // C}: {n_ok}/{w0 + C} OK, loops closed "
              f"{lc.n_loops_closed}, verdicts queued "
              f"{len(lc._pending_verdict)}, {time.perf_counter() - t0:.0f} s",
              flush=True)
    system.flush()
    lc = system.loop_closer
    poses, ts = system.tracker.composed_trajectory()
    est = np.stack([c for _, c in poses])
    R0, c0 = ds.gt_pose_wc(0)
    idx = {t: i for i, t in enumerate(ds.timestamps)}
    gt = np.stack([R0.T @ (ds.gt_pose_wc(idx[t])[1] - c0) for t in ts])
    live = np.stack([r.c_w for r in system.records])
    gt_live = np.stack([R0.T @ (ds.gt_pose_wc(i)[1] - c0) for i in range(n)])
    return {"pass": "hard", "frames": n,
            "ok": sum(r.state == OK for r in system.records),
            "loops_closed": int(lc.n_loops_closed),
            "gba_finished": int(lc.n_gba_finished),
            "ate_composed_m": float(ate_rmse(est, gt)),
            "ate_tracked_m": float(ate_rmse(live, gt_live)),
            "seconds": time.perf_counter() - t0}


def mono():
    from orb_slam_2_ros_tpu.config import (SENSOR_MONOCULAR, SENSOR_RGBD,
                                           SlamConfig)
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
    from orb_slam_2_ros_tpu.io.trajectory import ate_rmse
    from orb_slam_2_ros_tpu.pipeline.slam import System
    from orb_slam_2_ros_tpu.pipeline.tracking import OK

    n = 96
    ds = SyntheticRGBD(SlamConfig(sensor=SENSOR_RGBD), n_frames=n, seed=0,
                       trajectory="orbit")
    grays = np.stack([ds[i][0] for i in range(n)])
    system = System(SlamConfig(sensor=SENSOR_MONOCULAR),
                    enable_loop_closing=False)
    t0 = time.perf_counter()
    first = system.track_chunk(grays[:32], None, list(ds.timestamps[:32]))
    rest = system.track_chunk(grays[32:], None, list(ds.timestamps[32:]))
    recs = system.records
    states = [r.state for r in recs]
    ok = [r for r in recs if r.state == OK]
    est = np.stack([r.c_w for r in ok])
    gt = np.stack([ds.gt_pose_wc(r.frame_id)[1] for r in ok])
    return {"pass": "mono", "frames": n,
            "first_ok": states.index(OK) if OK in states else None,
            "ok_first_32": sum(r.state == OK for r in first),
            "ok_last_64": sum(r.state == OK for r in rest),
            "keyframes": int(system.tracker.n_kfs),
            "map_points": int(np.asarray(system.tracker.map.mp_valid).sum()),
            "ate_sim3_m": float(ate_rmse(est, gt, with_scale=True)),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "mono"
    print(json.dumps({"hard": hard, "mono": mono}[which]()), flush=True)
