#!/usr/bin/env python3
"""Find where the hard pass's runs in the JAX reference and in the port part.

    python tools/hard_divergence.py compare REF.json PORT.json
    JAX_PLATFORMS=cpu python tools/hard_divergence.py frame0
    JAX_PLATFORMS=cpu python tools/hard_divergence.py chunk0 DUMP_DIR

``compare``: REF.json is the last line of ``tools/reference_passes.py
hard``, PORT.json the summary that ``python -m
orb_slam_2_ros_tpu_torch.eval_loop_closing --hard-only`` writes (its
``OUT``).
Prints the two per-chunk logs side by side and, for every field, the first
chunk where the two differ.

``frame0``: frame 0 of the hard pass at the full operating point (640x480,
1200 features, 8 levels) through both packages' ORB extractors on the CPU:
keypoints common to both (position within 0.01 px, same octave), those of
one side only with their octaves, and how many common keypoints have a
different descriptor. The reference's extractor compiles for minutes.

``chunk0``: the port's ``System`` over the hard pass's first 16 frames on
the CPU against the reference's state after that chunk, as
``tools/reference_passes.py hard --dump DUMP_DIR`` wrote it
(``chunk_01.pkl.gz``): keyframe poses, map points, and observations per
keyframe.

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


def _chunks(path):
    with open(path) as f:
        data = json.loads(f.read().strip().splitlines()[-1])
    if "passes" in data:
        data = [p for p in data["passes"] if p["pass"] == "hard pass"][0]
    return data


def compare(ref_path, port_path):
    ref, port = _chunks(ref_path), _chunks(port_path)
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
    return {"first_chunk_differing_per_field": first,
            "ladders_differ_only_in_inliers": ladders_only_inliers,
            "reference_ate_composed_m": ref["ate_composed_m"],
            "port_ate_composed_m": port["ate_composed_m"]}


def _hard_frame0(cfg):
    from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
    ds = SyntheticRGBD(cfg, n_frames=288, seed=0, trajectory="twoloop",
                       exposure_drift=0.25)
    return ds, np.clip(np.round(ds[0][0]), 0, 255).astype(np.float32)


def frame0():
    import jax
    import jax.numpy as jnp
    import torch
    from orb_slam_2_ros_tpu.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu.frontend import extractor as jext
    from orb_slam_2_ros_tpu_torch.config import SlamConfig as TSlamConfig
    from orb_slam_2_ros_tpu_torch.frontend import extractor as text

    cfg = SlamConfig(sensor=SENSOR_RGBD)
    _, g = _hard_frame0(cfg)
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


def chunk0(dump_dir):
    import torch
    from orb_slam_2_ros_tpu.config import SENSOR_RGBD, SlamConfig
    from orb_slam_2_ros_tpu_torch.config import SlamConfig as TSlamConfig
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System

    with gzip.open(os.path.join(dump_dir, "chunk_01.pkl.gz")) as f:
        ref = pickle.load(f)["carry"]["m"]
    ds, _ = _hard_frame0(SlamConfig(sensor=SENSOR_RGBD))
    g = np.stack([ds[i][0] for i in range(16)])
    d = np.stack([ds[i][1] for i in range(16)])
    system = System(TSlamConfig(sensor=SENSOR_RGBD), enable_loop_closing=False,
                    device="cpu")
    system.track_chunk(g, d, ds.timestamps[:16])
    m = system.tracker.map
    n = int(m.n_kfs)
    rv, pv = ref["mp_valid"], m.mp_valid.numpy()
    return {"keyframes": [int(ref["n_kfs"]), n],
            "map_points": [int(rv.sum()), int(pv.sum())],
            "kf_t_max_diff_m": float(np.abs(ref["kf_t"][:n]
                                            - m.kf_t.numpy()[:n]).max()),
            "kf_q_max_diff": float(np.abs(ref["kf_q"][:n]
                                          - m.kf_q.numpy()[:n]).max()),
            "observations_per_keyframe": [
                [int((ref["kf_mp"][k] >= 0).sum()),
                 int((m.kf_mp[k] >= 0).sum().item())] for k in range(n)],
            "torch_threads": torch.get_num_threads()}


if __name__ == "__main__":
    mode = sys.argv[1]
    out = {"compare": lambda: compare(sys.argv[2], sys.argv[3]),
           "frame0": frame0,
           "chunk0": lambda: chunk0(sys.argv[2])}[mode]()
    print(json.dumps(out), flush=True)
