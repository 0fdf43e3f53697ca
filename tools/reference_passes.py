#!/usr/bin/env python3
"""Run the JAX reference's hard pass, loop pass or monocular pass once, on
whatever backend JAX finds, and print its counts and ATE.

    JAX_PLATFORMS=cpu python tools/reference_passes.py hard [--dump DIR]
    JAX_PLATFORMS=cpu python tools/reference_passes.py loop [--mesh]
    JAX_PLATFORMS=cpu python tools/reference_passes.py mono

``hard``: the reference bench's hard pass (``bench.py:224-251``): 288
frames of the ``twoloop`` trajectory with ``exposure_drift=0.25``,
``System(cfg, vocab=voc)`` in chunks of 16 and ``flush()``, the vocabulary
trained (k = 10, 4 levels, seed 0) on the descriptors of every 24th frame
of the 224-frame loop, as the bench's full-system pass trains it. No
warm-up and no ``reset()``. Per chunk and for the flush, one JSON line
``{"chunk": ...}`` with the fields of the port's ``eval_loop_closing.py``
log: frames OK so far, keyframe rows, valid keyframes and map points, the
detection verdict dispatched (``[cand, k]``: the candidate and the query
keyframe row, ``-1`` for none) and every verdict consumed, each ladder's
keyframe pair and outcome, and the running counts of ladders, loops closed
and global BAs started, finished, rejected and aborted. ``--dump DIR``
also writes the system's state at the START of every chunk (the tracking
carry with the map, the loop closer's state, its queued verdicts, an
in-flight global BA, its random key, the mapper's host counters) to
``DIR/chunk_NN.pkl.gz`` as nested dicts of numpy arrays, and the frames to
``DIR/frames.npz``: what ``tools/hard_divergence.py`` starts both packages
from.

``loop``: the bench's full-system pass, the same run over the 224-frame
``loop`` trajectory; with ``--mesh`` the system gets a mesh of one device
(``parallel/mesh.make_mesh(1, 1)``), so its local BA runs through
``distributed_windowed_ba`` and its loop GBA through the matrix-free
``distributed_gba_chunk`` in place of the dense one.

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


def _chunk_logger(system):
    """Wrap the reference closer's calls so that every chunk's verdicts and
    ladders are recorded; returns ``line(label)``, which gives one chunk's
    log entry and starts the next."""
    import jax
    from orb_slam_2_ros_tpu.pipeline.tracking import OK

    lc = system.loop_closer
    cur = {"consumed": [], "ladders": []}
    counts = {"ladders": 0, "gba_started": 0}

    def wrap(name, after):
        fn = getattr(lc, name)

        def wrapped(*args):
            out = fn(*args)
            after(args, out)
            return out
        setattr(lc, name, wrapped)

    def dispatched(args, out):
        cand, k = jax.device_get(lc._pending_verdict[-1])
        cur["dispatched"] = [int(cand), int(k)]

    def consumed(args, out):
        cand, k = args[1], args[2]
        if not isinstance(cand, int):
            cand, k = (int(x) for x in jax.device_get((cand, k)))
        cur["consumed"].append([cand, k])

    def ladder(args, out):
        counts["ladders"] += 1
        cur["ladders"].append([int(args[2]), int(args[3]),
                               bool(jax.device_get(out[0])),
                               int(jax.device_get(out[1]))])

    def gba_start(args, out):
        counts["gba_started"] += 1

    wrap("dispatch", dispatched)
    wrap("consume_host", consumed)
    wrap("_consume_verdict", consumed)
    wrap("_sim3_check", ladder)
    wrap("_gba_start", gba_start)

    def line(label):
        m = system.tracker.carry.m
        n_kfs, kf_valid, n_mps = jax.device_get((m.n_kfs, m.kf_valid,
                                                 m.n_mps))
        out = {"chunk": label,
               "ok": sum(r.state == OK for r in system.records),
               "keyframe_rows": int(n_kfs),
               "keyframes_valid": int(kf_valid.sum()),
               "map_points": int(n_mps),
               "dispatched": cur.get("dispatched"),
               "consumed": cur["consumed"], "ladder_runs": cur["ladders"],
               "ladders": counts["ladders"],
               "loops_closed": lc.n_loops_closed,
               "gba_started": counts["gba_started"],
               "gba_finished": lc.n_gba_finished,
               "gba_rejected": lc.n_gba_rejected,
               "gba_aborts": lc.n_gba_aborts,
               "gba_running": lc.gba_running}
        cur.clear()
        cur.update(consumed=[], ladders=[])
        return out
    return line


def _dump_state(system, path):
    """The state a chunk starts from, as nested dicts of numpy arrays."""
    import gzip
    import pickle

    import jax

    def tree(x):
        if x is None:
            return None
        if hasattr(x, "_asdict"):
            return {k: tree(v) for k, v in x._asdict().items()}
        return np.asarray(jax.device_get(x))

    lc = system.loop_closer
    state = {
        "carry": tree(system.tracker.carry),
        "loop": tree(lc.state),
        "n_ingested": int(jax.device_get(lc.state.n_ingested)),
        "pending": [[int(v) for v in jax.device_get(p)]
                    for p in lc._pending_verdict],
        "gba": tree(lc.gba), "gba_iters_done": lc._gba_iters_done,
        "key": np.asarray(jax.device_get(lc._key)),
        "mapper_prev_n_kfs": int(jax.device_get(system.mapper._prev_n_kfs)),
        "mapper_last_n_ba_free": int(jax.device_get(
            system.mapper._last_n_ba_free)),
        "n_records": len(system.records),
        "counts": {k: getattr(lc, k) for k in (
            "n_loops_closed", "n_gba_finished", "n_gba_rejected",
            "n_gba_aborts")}}
    with gzip.open(path, "wb", compresslevel=1) as f:
        pickle.dump(state, f)


def _loop_vocabulary(cfg):
    """The bench's vocabulary: k = 10, 4 levels, seed 0, trained on the
    descriptors of every 24th frame of the 224-frame loop."""
    import jax
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.frontend import frame as frame_mod
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
    from orb_slam_2_ros_tpu.place import vocabulary

    loop = SyntheticRGBD(cfg, n_frames=224, seed=0, trajectory="loop")
    descs = []
    for i in range(0, 224, 24):
        g, d = loop[i]
        f = frame_mod.build_rgbd(jnp.asarray(g, jnp.float32),
                                 jnp.asarray(d, jnp.float32), cfg)
        descs.append(np.asarray(jax.device_get(f.kps.desc))[
            np.asarray(jax.device_get(f.valid))])
    return vocabulary.train_vocabulary(np.concatenate(descs), cfg, seed=0)


def _full_system_pass(name, cfg, ds, n, dump=None, mesh=None):
    """``System(cfg, vocab=voc, mesh=mesh)`` over ``n`` frames of ``ds`` in
    chunks of 16, then ``flush()``; the per-chunk log and the counts."""
    from orb_slam_2_ros_tpu.io.trajectory import ate_rmse
    from orb_slam_2_ros_tpu.pipeline.slam import System
    from orb_slam_2_ros_tpu.pipeline.tracking import OK

    voc = _loop_vocabulary(cfg)
    system = System(cfg, vocab=voc, mesh=mesh)
    C = system.tracker.chunk
    line = _chunk_logger(system)
    all_grays = np.stack([ds[i][0] for i in range(n)])
    all_depths = np.stack([ds[i][1] for i in range(n)])
    if dump:
        os.makedirs(dump, exist_ok=True)
        np.savez(os.path.join(dump, "frames.npz"), grays=all_grays,
                 depths=all_depths, timestamps=np.asarray(ds.timestamps))
    log = []
    t0 = time.perf_counter()
    for w0 in range(0, n, C):
        if dump:
            _dump_state(system, os.path.join(dump,
                                             f"chunk_{w0 // C:02d}.pkl.gz"))
        system.track_chunk(all_grays[w0:w0 + C], all_depths[w0:w0 + C],
                           list(ds.timestamps[w0:w0 + C]))
        log.append(line(w0 // C))
        print(json.dumps(log[-1]), f"{time.perf_counter() - t0:.0f} s",
              flush=True)
    if dump:
        _dump_state(system, os.path.join(dump, "flush.pkl.gz"))
    system.flush()
    log.append(line("flush"))
    print(json.dumps(log[-1]), flush=True)
    lc = system.loop_closer
    poses, ts = system.tracker.composed_trajectory()
    est = np.stack([c for _, c in poses])
    R0, c0 = ds.gt_pose_wc(0)
    idx = {t: i for i, t in enumerate(ds.timestamps)}
    gt = np.stack([R0.T @ (ds.gt_pose_wc(idx[t])[1] - c0) for t in ts])
    live = np.stack([r.c_w for r in system.records])
    gt_live = np.stack([R0.T @ (ds.gt_pose_wc(i)[1] - c0) for i in range(n)])
    return {"pass": name, "frames": n,
            "ok": sum(r.state == OK for r in system.records),
            "loops_closed": int(lc.n_loops_closed),
            "gba_started": log[-1]["gba_started"],
            "gba_finished": int(lc.n_gba_finished),
            "gba_rejected": int(lc.n_gba_rejected),
            "ate_composed_m": float(ate_rmse(est, gt)),
            "ate_tracked_m": float(ate_rmse(live, gt_live)),
            "seconds": time.perf_counter() - t0, "chunks": log}


def hard(dump=None):
    from orb_slam_2_ros_tpu.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = 288
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0, trajectory="twoloop",
                       exposure_drift=0.25)
    return _full_system_pass("hard", cfg, ds, n, dump=dump)


def loop(use_mesh=False):
    import jax
    from orb_slam_2_ros_tpu.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
    from orb_slam_2_ros_tpu.parallel.mesh import make_mesh

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    n = 224
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0, trajectory="loop")
    mesh = (make_mesh(n_kf=1, n_mp=1, devices=jax.devices()[:1])
            if use_mesh else None)
    return _full_system_pass("loop --mesh" if use_mesh else "loop", cfg, ds,
                             n, mesh=mesh)


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
    if which == "hard":
        dump = (sys.argv[sys.argv.index("--dump") + 1]
                if "--dump" in sys.argv else None)
        out = hard(dump)
    elif which == "loop":
        out = loop(use_mesh="--mesh" in sys.argv)
    else:
        out = mono()
    print(json.dumps(out), flush=True)
