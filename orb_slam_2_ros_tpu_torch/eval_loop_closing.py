"""The full system on the card, loop closing on, beside the JAX reference's
own full-size numbers.

    python -m orb_slam_2_ros_tpu_torch.eval_loop_closing [--skip-hard]
    python -m orb_slam_2_ros_tpu_torch.eval_loop_closing --hard-only
    python -m orb_slam_2_ros_tpu_torch.eval_loop_closing --mesh
    ... [--seed N] [--vocab V.npz] [--device cpu] [--out PATH]

Two sequences at the reference operating point, each through
``System(cfg, vocab=voc)`` with all defaults, in chunks of 16, then
``flush()``:

- the 224-frame loop of ``chip_smoke.py`` (1.25 turns, one revisit), twice:
  the RANSAC draw comes from a ``torch.Generator`` seeded from ``cfg.seed``
  and every float sum with repeated targets is made in a fixed order, so the
  two runs must agree in every count and in the ATE;
- the hard pass (288 frames, 2.25 turns so that every viewpoint revisits
  twice, under a +-25% exposure sweep), once.

``--seed N`` (default 0) renders both scenes at that seed. The vocabulary
(k = 10, 4 levels) is trained once on the host from the descriptors of
every 24th frame of that seed's loop, with k-medians draws at the seed, and
serves both sequences; ``--vocab V.npz`` loads one instead, in the npz
layout both packages read (``tools/reference_passes.py vocab`` writes the
reference's), so that the two packages run with the same tree. ``--mesh``
runs the loop once through ``System(cfg, vocab=voc, mesh=)`` on a world of
1 (``parallel/multihost.global_mesh``: NCCL on the card, gloo with
``--device cpu``) and no hard pass: the counterpart of
``tools/reference_passes.py loop --mesh``. ``--hard-only`` runs the hard
pass alone. The run is on the card; ``--device cpu`` asks for the CPU.

For each pass: frames tracked, loops closed, Sim3 ladders run, global BAs
finished, rejected and aborted, the ATE (rigid alignment) composed through
the keyframes' final poses and as tracked, the counts of the map, the host
seconds per stage, each ladder's and each global BA's outcome, and a log of
every chunk and the flush (``chunks``): frames OK so far, keyframe rows,
valid keyframes and map points, the verdict dispatched (``[cand, k]``, the
candidate and the query keyframe row, ``-1`` for none), every verdict
consumed, each ladder's pair, outcome and inlier count, and the running
counts of ladders, loops closed and global BAs started, finished, rejected
and aborted; ``tools/reference_passes.py`` logs the same fields for the
JAX package and ``tools/hard_divergence.py compare`` sets the two side by
side. The JAX package's own seed-0 runs are printed beside them (counts
and ATE, taken with other backends, so no time is compared): both
sequences from its TPU bench (``BENCH_r05.json``), and the loop from a run
on a CPU (the same pass, no warm-up: 224/224 OK, 1 loop closed in the
flush, 1 GBA finished). The last line is a JSON summary, also written to
``--out`` (default ``chiprun_out/eval_loop_closing.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SlamConfig
from orb_slam_2_ros_tpu_torch.io import ate_rmse, render_frames
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK
from orb_slam_2_ros_tpu_torch.place import vocabulary

N_LOOP, N_HARD = 224, 288
VOCAB_EVERY = 24
OUT = os.path.join("chiprun_out", "eval_loop_closing.json")
# the reference's seed-0 runs, each with its own vocabulary
REFERENCE = {
    "loop, TPU": {"ok_frames": 224, "loops_closed": 1, "gba_finished": 1,
                  "ate_composed_m": 0.0296},
    "loop, CPU": {"ok_frames": 224, "loops_closed": 1, "gba_finished": 1,
                  "ate_composed_m": 0.060413, "ate_tracked_m": 0.095999},
    "hard, TPU": {"ok_frames": 288, "loops_closed": 2,
                  "ate_composed_m": 0.1786}}
COUNTS = ("ok_frames", "loops_closed", "ladders", "gba_finished",
          "gba_rejected", "gba_aborts", "keyframe_rows", "keyframes_valid",
          "n_mps", "points_culled", "mapping_steps")


def chunk_logger(system):
    """Record every verdict the closer dispatches and consumes; returns
    ``line(label)``, which gives one chunk's log entry and starts the
    next. Reads nothing the run would not read, apart from the dispatched
    verdict and the map's counts after the chunk."""
    lc = system.loop_closer
    cur = {"consumed": []}
    seen = {"events": 0}
    dispatch, consume_host = lc.dispatch, lc.consume_host

    def dispatched(*args):
        dispatch(*args)
        cur["dispatched"] = lc._pending_verdict[-1].tolist()

    def consumed(m, cand, k):
        cur["consumed"].append([cand, k])
        return consume_host(m, cand, k)

    lc.dispatch, lc.consume_host = dispatched, consumed

    def line(label):
        m = system.tracker.carry.m
        ladders = [[e["cand"], e["k"], e["accepted"], e["n_inl"]]
                   for e in lc.events[seen["events"]:]
                   if e["kind"] == "ladder"]
        seen["events"] = len(lc.events)
        out = {"chunk": label,
               "ok": sum(r.state == OK for r in system.records),
               "keyframe_rows": int(m.n_kfs),
               "keyframes_valid": int(m.kf_valid.sum()),
               "map_points": int(m.n_mps),
               "dispatched": cur.get("dispatched"),
               "consumed": cur["consumed"], "ladder_runs": ladders,
               "ladders": lc.n_ladders, "loops_closed": lc.n_loops_closed,
               "gba_started": lc.n_corrections,
               "gba_finished": lc.n_gba_finished,
               "gba_rejected": lc.n_gba_rejected,
               "gba_aborts": lc.n_gba_aborts,
               "gba_running": lc.gba_running}
        cur.clear()
        cur["consumed"] = []
        return out
    return line


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_pass(name, cfg, voc, ds, grays, depths, device="cuda", mesh=None):
    n = len(grays)
    system = System(cfg, vocab=voc, device=device, mesh=mesh)
    C = system.tracker.CHUNK
    line = chunk_logger(system)
    chunks = []
    _sync(device)
    t0 = time.perf_counter()
    for w0 in range(0, n, C):
        system.track_chunk(grays[w0:w0 + C], depths[w0:w0 + C],
                           ds.timestamps[w0:w0 + C])
        chunks.append(line(w0 // C))
        print(json.dumps(chunks[-1]), flush=True)
    system.flush()
    chunks.append(line("flush"))
    print(json.dumps(chunks[-1]), flush=True)
    _sync(device)
    seconds = time.perf_counter() - t0
    recs = system.records
    gt = [ds.gt_pose_wc(i)[1] for i in range(n)]
    poses, ts = system.tracker.composed_trajectory()
    index = {t: i for i, t in enumerate(ds.timestamps)}
    m = system.tracker.map
    lc = system.loop_closer
    out = {
        "pass": name, "frames": n,
        "ok_frames": sum(r.state == OK for r in recs),
        "loops_closed": lc.n_loops_closed, "ladders": lc.n_ladders,
        "gba_finished": lc.n_gba_finished, "gba_rejected": lc.n_gba_rejected,
        "gba_aborts": lc.n_gba_aborts,
        "ate_composed_m": float(ate_rmse(
            np.stack([c for _, c in poses]),
            np.stack([gt[index[t]] for t in ts]))),
        "ate_tracked_m": float(ate_rmse(np.stack([r.c_w for r in recs]),
                                        np.stack(gt))),
        "keyframe_rows": system.tracker.n_kfs,
        "keyframes_valid": int(m.kf_valid.sum()),
        "n_mps": int(m.n_mps), "points_culled": system.n_culled_total,
        "mapping_steps": system.mapper.n_executed,
        "fps": n / seconds,
        "stage_ms": {s: v["total_ms"]
                     for s, v in system.metrics()["stages"].items()},
        "events": lc.events, "chunks": chunks}
    print(json.dumps(out), flush=True)
    return out


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m orb_slam_2_ros_tpu_torch.eval_loop_closing")
    ap.add_argument("--skip-hard", action="store_true")
    ap.add_argument("--hard-only", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="the loop once on a world of 1, no hard pass")
    ap.add_argument("--seed", type=int, default=0,
                    help="scene and vocabulary seed")
    ap.add_argument("--vocab", default=None,
                    help="a vocabulary npz to load instead of training one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("eval_loop_closing: no CUDA device (pass --device "
                         "cpu to run on the CPU)")
    smi = "cpu"
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    seed = args.seed
    loop_needed = not args.hard_only or args.vocab is None
    if loop_needed:
        ds, grays, depths = render_frames(cfg, N_LOOP, workers=6, seed=seed,
                                          trajectory="loop")
    t0 = time.perf_counter()
    if args.vocab:
        voc = vocabulary.load_npz(args.vocab, device=device)
        origin = args.vocab
    else:
        voc = vocabulary.train_vocabulary_from_frames(
            grays, VOCAB_EVERY, cfg, seed=seed, device=device)
        origin = f"the port, from every {VOCAB_EVERY}th loop frame"
    print(f"vocabulary of {voc.num_words} words ({origin}) in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    passes = []
    mesh = None
    if args.mesh:
        from orb_slam_2_ros_tpu_torch.parallel import multihost
        made_group = not torch.distributed.is_initialized()
        mesh = multihost.global_mesh(device=device)
        print(f"mesh {mesh.shape} over {mesh.world} ranks "
              f"({torch.distributed.get_backend()})", flush=True)
        try:
            passes = [run_pass("loop, mesh", cfg, voc, ds, grays, depths,
                               device=mesh.device, mesh=mesh)]
        finally:
            if made_group:
                multihost.shutdown()
    elif not args.hard_only:
        passes = [run_pass("loop, first run", cfg, voc, ds, grays, depths,
                           device=device),
                  run_pass("loop, second run", cfg, voc, ds, grays, depths,
                           device=device)]
        differ = [k for k in COUNTS + ("ate_composed_m",)
                  if passes[0][k] != passes[1][k]]
        if differ:
            raise AssertionError(f"two runs of the system differ in {differ}")
    if not (args.skip_hard or args.mesh):
        ds_h, grays_h, depths_h = render_frames(
            cfg, N_HARD, workers=6, seed=seed, trajectory="twoloop",
            exposure_drift=0.25)
        passes.append(run_pass("hard pass", cfg, voc, ds_h, grays_h,
                               depths_h, device=device))
    result = {"card": smi, "seed": seed, "vocab": origin, "passes": passes,
              "loop_runs_agree_in": list(COUNTS) + ["ate_composed_m"],
              "reference": REFERENCE if seed == 0 else None}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
