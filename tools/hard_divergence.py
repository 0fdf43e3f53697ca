#!/usr/bin/env python3
"""Find where a pass's runs in the JAX reference and in the port part.

    python tools/hard_divergence.py compare REF.json PORT.json
    JAX_PLATFORMS=cpu python tools/hard_divergence.py frame0
    python tools/hard_divergence.py chunk N[-M] DUMP_DIR VOCAB.npz \
        [--state-out FILE]
    python tools/hard_divergence.py gba DUMP_DIR [I]

``compare``: REF.json is the last line of ``tools/reference_passes.py
hard``, ``loop`` or ``loop --mesh``, PORT.json the summary that ``python -m
orb_slam_2_ros_tpu_torch.eval_loop_closing`` writes (its ``--out``) with
the same pass (``--hard-only``, ``--skip-hard`` or ``--mesh``) at the same
seed. Prints the two per-chunk logs side by side and, for every field, the
first chunk where the two differ, and both runs' frames OK, loops closed,
global BAs finished and ATE.

``frame0``: frame 0 of the hard pass at the full operating point (640x480,
1200 features, 8 levels) through both packages' ORB extractors on the CPU:
keypoints common to both (position within 0.01 px, same octave), those of
one side only with their octaves, and how many common keypoints have a
different descriptor. The reference's extractor compiles for minutes.

``chunk``: the port's ``System`` (loop closing on, the vocabulary file
both packages ran with, the dump's configuration) on the CPU, started from
the reference's state at the start of chunk ``N`` as
``tools/reference_passes.py loop|hard --dump DUMP_DIR`` wrote it (the
tracking carry with the map, the tracker's state, the mapper's counters,
the loop closer's state, its queued verdicts and counts, a dense global BA
in flight; not the RANSAC streams, which torch cannot draw as
``jax.random`` does), runs chunk ``N``'s frames (through chunk ``M``'s
with ``N-M``), printing each chunk's log; then it sets the reference's
state at the start of the next chunk (before the flush, after the last
chunk) beside the port's: keyframes and the frames they came from, map
points, the verdict dispatched, keyframe poses, the camera's pose, and
every frame's record. ``--state-out FILE`` writes the port's state at
that point in the dump's layout, for ``tools/reference_passes.py replay
--state FILE``: the reverse replay, the reference from the port's state.
``chunk 0`` starts both from nothing, so it sets the port's first chunk
beside the reference's (where the hard pass's two runs first part).

``gba``: the port's global BA on the CPU from the reference's own
snapshot of global BA ``I`` (default 0; ``gba_I_start.pkl.gz``), run for
``global_ba_iters`` iterations in chunks as ``LoopCloser`` runs it: the
mesh's edge-list CG on a gloo world of 1 for an edge-list snapshot, the
dense-Schur one otherwise. Its free cameras (none under
``gba_structure_only``) and points beside the reference's state at the
reconciliation (``gba_I_end.pkl.gz``), per chunk of iterations the port's
cost.

The last line is one JSON object with the numbers.
"""

import gzip
import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIELDS = ("ok", "keyframe_rows", "keyframes_valid", "map_points",
          "dispatched", "consumed", "ladder_runs", "ladders", "loops_closed",
          "gba_started", "gba_finished", "gba_rejected", "gba_aborts",
          "gba_running")


# the reference's pass names and the port's for the same pass
PORT_PASS = {"hard": "hard pass", "loop": "loop, first run",
             "loop --mesh": "loop, mesh"}


def _chunks(path, name=None):
    """The last JSON line of ``path``; from the port's summary, the pass
    that matches the reference's ``name``."""
    with open(path) as f:
        data = json.loads(f.read().strip().splitlines()[-1])
    if "passes" in data:
        data = [p for p in data["passes"] if p["pass"] == PORT_PASS[name]][0]
    return data


def compare(ref_path, port_path):
    ref = _chunks(ref_path)
    port = _chunks(port_path, ref["pass"])
    first = {}
    for a, b in zip(ref["chunks"], port["chunks"]):
        print(f"chunk {a['chunk']}:")
        for f in FIELDS:
            same = a[f] == b[f]
            if not same and f not in first:
                first[f] = a["chunk"]
            print(f"  {f:16s} {'same' if same else 'DIFFER'}  "
                  f"reference {a[f]}  port {b[f]}")
    ladders_only_inliers = all(
        [r[:3] for r in a["ladder_runs"]] == [r[:3] for r in b["ladder_runs"]]
        for a, b in zip(ref["chunks"], port["chunks"]))
    final = ("ok", "loops_closed", "gba_finished", "gba_rejected")
    return {"pass": ref["pass"], "seed": ref.get("seed", 0),
            "first_chunk_differing_per_field": first,
            "ladders_differ_only_in_inliers": ladders_only_inliers,
            "reference": {k: ref["chunks"][-1][k] for k in final},
            "port": {k: port["chunks"][-1][k] for k in final},
            "reference_ate_composed_m": ref["ate_composed_m"],
            "port_ate_composed_m": port["ate_composed_m"]}


def frame0():
    import jax
    import jax.numpy as jnp
    import torch
    from orb_slam_2_ros_tpu.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu.frontend import extractor as jext
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
    from orb_slam_2_ros_tpu_torch.config import SlamConfig as TSlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import extractor as text

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    ds = SyntheticRGBD(cfg, n_frames=288, seed=0, trajectory="twoloop",
                       exposure_drift=0.25)
    g = np.clip(np.round(ds[0][0]), 0, 255).astype(np.float32)
    jk = jext.extract(jnp.asarray(g), cfg.orb)
    tk = text.extract(torch.from_numpy(g), TSlamConfig(sensor=SENSOR_RGBD).orb)

    def table(xy, octave, desc, valid):
        xy, octave = np.asarray(xy), np.asarray(octave)
        desc, valid = np.asarray(desc).view(np.uint32), np.asarray(valid)
        return {(round(float(x), 2), round(float(y), 2), int(o)): tuple(d)
                for (x, y), o, d, v in zip(xy, octave, desc, valid) if v}
    a = table(jk.xy, jk.octave, jax.device_get(jk.desc), jk.valid)
    b = table(tk.xy.numpy(), tk.octave.numpy(), tk.desc.numpy(),
              tk.valid.numpy())
    common = set(a) & set(b)
    return {"reference_keypoints": len(a), "port_keypoints": len(b),
            "common": len(common),
            "reference_only": sorted(set(a) - common),
            "port_only": sorted(set(b) - common),
            "common_with_other_descriptor": sum(a[k] != b[k]
                                                for k in common)}


def _load_file(dump_dir, name):
    with gzip.open(os.path.join(dump_dir, f"{name}.pkl.gz")) as f:
        return pickle.load(f)


def _load(dump_dir, n):
    return _load_file(dump_dir,
                      "flush" if n == "flush" else f"chunk_{int(n):02d}")


def _port_state(system):
    """The port's ``System`` state in the layout of the reference's dump
    (``tools/reference_passes._dump_state``); no random key."""
    from orb_slam_2_ros_tpu_torch import convert

    lc, mapper = system.loop_closer, system.mapper
    loop = convert.to_numpy(lc.state)
    loop["n_ingested"] = np.int32(lc._n_ingested)
    return {"carry": convert.to_numpy(system.tracker.carry),
            "tracker_state": int(system.tracker.state),
            "loop": loop, "n_ingested": lc._n_ingested,
            "pending": [[int(v) for v in p.tolist()]
                        for p in lc._pending_verdict],
            "gba": None if lc.gba is None else convert.to_numpy(lc.gba),
            "gba_iters_done": lc._gba_iters_done, "key": None,
            "mapper_prev_n_kfs": int(mapper._prev_n_kfs),
            "mapper_last_n_ba_free": int(mapper._last_n_ba_free or 0),
            "n_records": system._frame_counter,
            "counts": {k: getattr(lc, k) for k in (
                "n_loops_closed", "n_gba_finished", "n_gba_rejected",
                "n_gba_aborts")}}


def chunk(span, dump_dir, vocab_path, state_out=None):
    import torch
    from orb_slam_2_ros_tpu_torch import convert
    from orb_slam_2_ros_tpu_torch.eval_loop_closing import chunk_logger
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    n, _, last = span.partition("-")
    n, last = int(n), int(last or n)
    start = _load(dump_dir, n)
    frames = np.load(os.path.join(dump_dir, "frames.npz"))
    system = System(convert.config_from_dict(_load_file(dump_dir, "config")),
                    vocab=vocabulary.load_npz(vocab_path, device="cpu"),
                    device="cpu")
    system.tracker.carry = convert.track_carry_from_numpy(start["carry"],
                                                          "cpu")
    system.tracker.state = start["tracker_state"]
    system._frame_counter = start["n_records"]
    system.mapper._prev_n_kfs = start["mapper_prev_n_kfs"]
    system.mapper._last_n_ba_free = torch.tensor(
        start["mapper_last_n_ba_free"], dtype=torch.int32)
    lc = system.loop_closer
    lc.state = convert.loop_state_from_numpy(start["loop"], "cpu")
    lc._n_ingested = start["n_ingested"]
    lc._pending_verdict = [torch.tensor(p, dtype=torch.int32)
                           for p in start["pending"]]
    for k, v in start["counts"].items():
        setattr(lc, k, v)
    if start["gba"] is not None:
        if "prob" in start["gba"]:
            raise NotImplementedError("a mesh's global BA in flight")
        lc.gba = convert.dense_gba_state_from_numpy(start["gba"], "cpu")
        lc._gba_iters_done = start["gba_iters_done"]
    line = chunk_logger(system)
    C = system.tracker.CHUNK
    logs = []
    for i in range(n, last + 1):
        sl = slice(i * C, (i + 1) * C)
        system.track_chunk(frames["grays"][sl], frames["depths"][sl],
                           list(frames["timestamps"][sl]))
        logs.append(line(i))
        print(json.dumps(logs[-1]), flush=True)
    if state_out:
        with gzip.open(state_out, "wb", compresslevel=1) as f:
            pickle.dump(_port_state(system), f)
    final = not os.path.exists(os.path.join(dump_dir,
                                            f"chunk_{last + 1:02d}.pkl.gz"))
    end = _load(dump_dir, "flush" if final else last + 1)
    ref, m = end["carry"]["m"], system.tracker.map
    k0, k1 = int(start["carry"]["m"]["n_kfs"]), int(m.n_kfs)
    kr = int(ref["n_kfs"])
    kk = min(k1, kr)
    return {"chunks": [n, last], "port_logs": logs,
            "reference_after": {
                "keyframe_rows": kr,
                "keyframes_valid": int(ref["kf_valid"].sum()),
                "map_points": int(ref["n_mps"]),
                "dispatched": end["pending"][-1:],
                "new_keyframe_frames": ref["kf_frame_id"][k0:kr].tolist(),
                "counts": end["counts"]},
            "port_new_keyframe_frames": m.kf_frame_id[k0:k1].tolist(),
            "records": [[r.frame_id, r.state, r.n_inliers,
                         r.is_keyframe] for r in system.records],
            "kf_t_max_diff_m": float(np.abs(
                ref["kf_t"][:kk] - m.kf_t.numpy()[:kk]).max()),
            "camera_t_diff_m": float(np.abs(
                end["carry"]["t"] - system.tracker.carry.t.numpy()).max())}


def gba(dump_dir, i=0):
    import torch
    from orb_slam_2_ros_tpu_torch import convert
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.pipeline import loop_closing as tlc

    start, end = (_load_file(dump_dir, f"gba_{i}_{w}")
                  for w in ("start", "end"))
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    mesh = None
    if "prob" in start:
        from orb_slam_2_ros_tpu_torch.parallel import dist_ba, multihost
        mesh = multihost.global_mesh(device="cpu")
        g = dist_ba.shard_gba_state(
            mesh, convert.gba_state_from_numpy(start, "cpu"), cfg)
    else:
        g = convert.dense_gba_state_from_numpy(start, "cpu")
    errs = [float(g.err)]
    for _ in range(cfg.solver.global_ba_iters // tlc.GBA_CHUNK_ITERS):
        g = tlc._gba_step(g, cfg, mesh)
        errs.append(float(g.err))
    if mesh is not None:
        g = dist_ba.gather_gba_points(mesh, g, cfg)
        multihost.shutdown()
    free = start["cam_free"]
    pts = start["mp_free"]
    return {"edge_list": mesh is not None, "cameras_free": int(free.sum()),
            "points": int(pts.sum()),
            "port_cost_per_chunk": errs,
            "reference_cost_start_end": [float(start["err"]),
                                         float(end["err"])],
            "kf_t_max_diff_m": float(np.abs(
                g.t.numpy() - end["t"])[free].max()) if free.any() else None,
            "kf_q_max_diff": float(np.abs(
                g.q.numpy() - end["q"])[free].max()) if free.any() else None,
            "mp_pos_max_diff_m": float(np.abs(
                g.pos.numpy() - end["pos"])[pts].max()),
            "mp_pos_median_diff_m": float(np.median(np.abs(
                g.pos.numpy() - end["pos"])[pts].max(-1))),
            "torch_threads": torch.get_num_threads()}


if __name__ == "__main__":
    mode = sys.argv[1]
    out = {"compare": lambda: compare(sys.argv[2], sys.argv[3]),
           "frame0": frame0,
           "chunk": lambda: chunk(*sys.argv[2:5], state_out=(
               sys.argv[sys.argv.index("--state-out") + 1]
               if "--state-out" in sys.argv else None)),
           "gba": lambda: gba(sys.argv[2], *map(int, sys.argv[3:4]))}[mode]()
    print(json.dumps(out), flush=True)
