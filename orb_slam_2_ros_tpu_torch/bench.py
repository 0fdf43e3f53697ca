"""The reference's bench on the card: its six passes at the reference
operating point (640x480, 1200 features, 8 pyramid levels,
``ros/src/Node.cc:320-326``) on one NVIDIA card.

    python -m orb_slam_2_ros_tpu_torch.bench [--device cuda:0]

The port of the JAX package's top-level ``bench.py``, function by function
and pass by pass:

- the full system (tracking, local mapping, loop closing, the background
  global BA, all defaults) on the 224-frame revisit loop: two warm chunks,
  then ``reset()``, then the timed pass over every frame, ``flush()``
  included;
- the hard pass: a fresh ``System`` on 288 frames of ``twoloop`` under a
  +-25% exposure sweep, no warm-up;
- the bare ``Tracker`` on the 96-frame RGB-D orbit and on 64 stereo pairs:
  two warm chunks left out of the frame rate and the OK count;
- the stereo ``System`` (loop closing off): one warm chunk, the frame rate
  over the other 48 frames;
- the monocular ``System`` (loop closing off) on the orbit's gray images:
  32 float images to initialize and warm up, the other 64 timed in one call.

Every pass feeds the frames in the wire format of the native prefetcher (u8
gray, u16 millimetre depth or a u8 right image), as numpy arrays made
before the timed region, so the host-to-device copy of each chunk is timed
as a streaming deployment pays it. A frame rate is frames over host
seconds, ending in ``torch.cuda.synchronize()``. The vocabulary (k = 10, 4
levels) is trained from every 24th frame of the loop outside every timed
region. Rendered sequences and the vocabulary are cached as ``.npz`` files
under the temporary directory (``tempfile.gettempdir()``), named
``slam_bench_torch_*`` with the image size in the name; a cached run skips
the rendering.

The counts (OK frames, loops closed, global BAs finished), the card's name
and power limit and the loop-closing chunks go to stderr; the last line on
stdout is one JSON object with the reference's keys in its order, the frame
rates unrounded, and ``vs_baseline`` the full system's frame rate over the
30 fps sensor rate. There is no CPU path: without a card the bench exits
with a message.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from orb_slam_2_ros_tpu_torch.config import (SENSOR_MONOCULAR, SENSOR_RGBD,
                                             SENSOR_STEREO, SlamConfig)
from orb_slam_2_ros_tpu_torch.io import ate_rmse, render_frames
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker
from orb_slam_2_ros_tpu_torch.place import vocabulary

N_LOOP = 224            # 1.25 turns, one revisit
N_HARD = 288            # 2.25 turns, every viewpoint revisited twice
N_TRACK = 96            # the orbit of the tracking-only and mono passes
N_STEREO = 64
N_MONO_WARM = 32        # the mono pass's initialization and warm-up frames
N_WARM_CHUNKS = 2       # left out of the tracking-only rates and OK counts
VOCAB_EVERY = 24
SENSOR_RATE_FPS = 30.0
RENDER_WORKERS = 6


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class _CachedSeq:
    """Array-backed stand-in for the synthetic dataset objects: the gray
    images, the depth maps (the right images of a stereo sequence), the
    timestamps and the ground-truth camera-to-world poses."""

    def __init__(self, grays, depths, ts, gt_R, gt_c):
        self.grays, self.depths, self.timestamps = grays, depths, ts
        self._gt_R, self._gt_c = gt_R, gt_c

    def __len__(self):
        return len(self.grays)

    def __getitem__(self, i):
        return self.grays[i], self.depths[i]

    def gt_pose_wc(self, i):
        return self._gt_R[i], self._gt_c[i]


def cache_path(cfg: SlamConfig, n, trajectory="orbit", exposure_drift=0.0,
               seed=0, stereo=False, cache_dir=None):
    """The file a sequence is cached in. The image size is part of the
    name, so sequences of two camera sizes never share a file."""
    cam = cfg.camera
    key = (f"slam_bench_torch_{'st' if stereo else 'rgbd'}_{trajectory}_"
           f"{n}_{seed}_{int(exposure_drift * 100)}_{cam.width}x"
           f"{cam.height}")
    return os.path.join(cache_dir or tempfile.gettempdir(), f"{key}.npz")


def cached_seq(cfg: SlamConfig, n, trajectory="orbit", exposure_drift=0.0,
               seed=0, stereo=False, workers=RENDER_WORKERS, cache_dir=None):
    """The synthetic sequence as a ``_CachedSeq``: loaded from its cache
    file, or rendered by ``workers`` processes (the same frames as one
    process) and then cached. Rendering is host time that no pass
    measures."""
    path = cache_path(cfg, n, trajectory, exposure_drift, seed, stereo,
                      cache_dir)
    if os.path.exists(path):
        d = np.load(path)
        return _CachedSeq(d["grays"], d["depths"], d["ts"], d["R"], d["c"])
    ds, grays, depths = render_frames(
        cfg, n, workers=workers, stereo=stereo, seed=seed,
        trajectory=trajectory, exposure_drift=exposure_drift)
    gt = [ds.gt_pose_wc(i) for i in range(n)]
    R = np.stack([g[0] for g in gt])
    c = np.stack([g[1] for g in gt])
    ts = np.asarray(ds.timestamps)
    # written under a name of its own and moved into place, so a run that
    # stops half-way leaves no truncated cache behind
    part = f"{path}.{os.getpid()}.part"
    with open(part, "wb") as f:
        np.savez_compressed(f, grays=grays, depths=depths, ts=ts, R=R, c=c)
    os.replace(part, path)
    return _CachedSeq(grays, depths, ts, R, c)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _wire_chunks(tracker, grays, auxs, timestamps):
    """A sequence in the wire format, sliced into the tracker's chunks:
    [(u8 grays, u16 depths / u8 rights / None, timestamps)]."""
    g_w, a_w = tracker.to_wire(grays, auxs)
    C = tracker.chunk
    return [(g_w[w0:w0 + C], None if a_w is None else a_w[w0:w0 + C],
             list(timestamps[w0:w0 + C])) for w0 in range(0, len(g_w), C)]


def h2d_ms(tracker, chunk, reps=5):
    """Host ms of copying one RGB-D wire chunk to the device the way
    ``Tracker.process_chunk`` copies it (the depth widened to int32 on the
    host), synchronized; the median of ``reps``. Returns (ms, bytes)."""
    g, d, _ = chunk
    times = []
    for _ in range(reps):
        _sync(tracker.device)
        t0 = time.perf_counter()
        torch.from_numpy(g).to(tracker.device)
        torch.from_numpy(d.astype(np.int32)).to(tracker.device)
        _sync(tracker.device)
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times)), g.nbytes + 4 * d.size


def bench_tracker_only(cfg: SlamConfig, ds, n_frames, label, device="cuda"):
    """Tracking-only frame rate (the bare Tracker, no mapping or loops):
    two warm chunks, then the rest timed. The tracker fetches each chunk's
    records as it goes, so the OK count is read from the records after
    the warm chunks. Returns (fps, tracker, records of all frames)."""
    tracker = Tracker(cfg, device=device)
    chunks = _wire_chunks(tracker, ds.grays[:n_frames], ds.depths[:n_frames],
                          ds.timestamps[:n_frames])
    C = tracker.chunk
    for chunk in chunks[:N_WARM_CHUNKS]:
        tracker.process_chunk(*chunk, wire=True)
    _sync(tracker.device)
    t0 = time.perf_counter()
    for chunk in chunks[N_WARM_CHUNKS:]:
        tracker.process_chunk(*chunk, wire=True)
    _sync(tracker.device)
    dt = time.perf_counter() - t0
    fps = (n_frames - N_WARM_CHUNKS * C) / dt
    recs = list(tracker.records)
    n_ok = sum(r.state == OK for r in recs[N_WARM_CHUNKS * C:])
    log(f"{label}: {fps:.1f} fps, {n_ok} OK frames")
    return fps, tracker, recs


def bench_vocabulary(cfg: SlamConfig, ds, device="cuda", cache_dir=None):
    """The in-domain vocabulary, trained on the host from the descriptors of
    every ``VOCAB_EVERY``-th gray image of ``ds`` (seed 0), outside every
    timed region; cached, since training is deterministic in the sequence,
    the configuration and the seed."""
    cam = cfg.camera
    path = os.path.join(cache_dir or tempfile.gettempdir(),
                        f"slam_bench_torch_vocab_{len(ds)}_{cam.width}x"
                        f"{cam.height}.npz")
    if os.path.exists(path):
        return vocabulary.load_npz(path, device=device)
    voc = vocabulary.train_vocabulary_from_frames(
        ds.grays, VOCAB_EVERY, cfg, seed=0, device=device)
    part = f"{path}.{os.getpid()}.part"
    with open(part, "wb") as f:
        vocabulary.save_npz(voc, f)
    os.replace(part, path)
    return voc


def composed_ate(system, ds):
    """ATE (rigid alignment) of the trajectory composed through the
    keyframes' final poses, so that it reflects the BA, loop and GBA
    corrections; ground truth in the first camera's frame."""
    poses, tstamps = system.tracker.composed_trajectory()
    est = np.stack([c for _, c in poses])
    R0, c0 = ds.gt_pose_wc(0)
    idx = {t: i for i, t in enumerate(ds.timestamps)}
    gt = np.stack([R0.T @ (ds.gt_pose_wc(idx[t])[1] - c0) for t in tstamps])
    return float(ate_rmse(est, gt))


def _timed_pass(system, ds, chunks, label):
    """Track the chunks and ``flush()``, timed on the host clock up to
    ``torch.cuda.synchronize()``; the numbers of the pass, logged. For each
    chunk in which the loop closer ran a Sim3 ladder (and for the flush),
    its host ms in loop closing and its ladders' outcomes are logged too,
    from the host timers: no extra wait for the device."""
    lc = system.loop_closer
    ladder_chunks = []
    _sync(system.device)
    t0 = time.perf_counter()
    for i, chunk in enumerate(list(chunks) + [None]):
        before = system.timers.total_s["loop_closing"]
        n_events = len(lc.events)
        if chunk is None:
            system.flush()
        else:
            system.track_chunk(*chunk)
        ladders = [(e["cand"], e["k"], e["accepted"], e["n_inl"])
                   for e in lc.events[n_events:] if e["kind"] == "ladder"]
        if ladders:
            ladder_chunks.append((
                "flush" if chunk is None else i,
                1e3 * (system.timers.total_s["loop_closing"] - before),
                ladders))
    _sync(system.device)
    dt = time.perf_counter() - t0
    n = len(ds)
    out = {"fps": n / dt, "seconds": dt,
           "ok": sum(r.state == OK for r in system.records),
           "loops": lc.n_loops_closed, "gba_finished": lc.n_gba_finished,
           "ate_m": composed_ate(system, ds), "ladder_chunks": ladder_chunks}
    log(f"{label}: {out['fps']:.2f} fps, {out['ok']}/{n} OK, "
        f"{out['loops']} loops closed, gba_finished={out['gba_finished']}, "
        f"ATE (composed, after corrections) {out['ate_m']:.6f} m")
    for chunk, ms, ladders in ladder_chunks:
        log(f"{label}: chunk {chunk}: loop closing {ms:.1f} ms host, "
            f"ladders (candidate, keyframe, accepted, inliers) {ladders}")
    return out


def bench_full_system(cfg: SlamConfig, ds, voc, device="cuda"):
    """The shipped pipeline (``System(cfg, vocab=voc)``, all defaults)
    over the whole sequence: two warm chunks, ``reset()``, the warm-up's
    records dropped, then the timed pass with ``flush()`` inside it.
    Returns (numbers, system)."""
    system = System(cfg, vocab=voc, device=device)
    chunks = _wire_chunks(system.tracker, ds.grays, ds.depths, ds.timestamps)
    log("warmup: two chunks, then reset()")
    for chunk in chunks[:N_WARM_CHUNKS]:
        system.track_chunk(*chunk)
    system.reset()
    system.tracker.flush()
    system.tracker.records.clear()
    system._frame_counter = 0
    return _timed_pass(system, ds, chunks, "full system"), system


def bench_hard(cfg: SlamConfig, ds, voc, device="cuda"):
    """A fresh ``System(cfg, vocab=voc)`` over the whole sequence, no
    warm-up, ``flush()`` timed. Returns (numbers, system)."""
    system = System(cfg, vocab=voc, device=device)
    chunks = _wire_chunks(system.tracker, ds.grays, ds.depths, ds.timestamps)
    return _timed_pass(system, ds, chunks, "hard pass"), system


def bench_stereo_system(cfg: SlamConfig, ds, device="cuda"):
    """Stereo ``System`` (tracking and mapping, loop closing off): one warm
    chunk, the frame rate over the other frames; OK frames over all of
    them. Returns (fps, OK frames, system)."""
    system = System(cfg, enable_loop_closing=False, device=device)
    chunks = _wire_chunks(system.tracker, ds.grays, ds.depths, ds.timestamps)
    system.track_chunk(*chunks[0])
    _sync(system.device)
    t0 = time.perf_counter()
    for chunk in chunks[1:]:
        system.track_chunk(*chunk)
    _sync(system.device)
    dt = time.perf_counter() - t0
    fps = (len(ds) - len(chunks[0][0])) / dt
    system.flush()
    n_ok = sum(r.state == OK for r in system.records)
    log(f"stereo system: {fps:.1f} fps, {n_ok} OK frames")
    return fps, n_ok, system


def bench_mono(cfg: SlamConfig, ds, device="cuda", n_warm=N_MONO_WARM):
    """Monocular ``System`` (two-view initialization, tracking and mapping
    every 8 frames; loop closing off) on the gray images of ``ds``: the
    first ``n_warm`` fed as float images, the rest in one wire-format call,
    timed. Returns (fps, OK frames of the timed call, system)."""
    system = System(cfg, enable_loop_closing=False, device=device)
    grays = ds.grays
    ts = ds.timestamps
    system.track_chunk(grays[:n_warm], None, ts[:n_warm])
    g_w, _ = system.tracker.to_wire(grays[n_warm:], None)
    _sync(system.device)
    t0 = time.perf_counter()
    recs = system.track_chunk(g_w, None, ts[n_warm:])
    _sync(system.device)
    dt = time.perf_counter() - t0
    fps = (len(grays) - n_warm) / dt
    n_ok = sum(r.state == OK for r in recs)
    log(f"mono system: {fps:.1f} fps, {n_ok} OK frames")
    return fps, n_ok, system


def output_line(results) -> dict:
    """The result line: the reference's keys in its order
    (``bench.py:313-320``), from the numbers of ``run_passes``."""
    fps = results["slam_system_fps_1chip"]
    return {"metric": "slam_system_fps_1chip", "value": fps,
            "unit": "frames/s", "vs_baseline": fps / SENSOR_RATE_FPS,
            **{k: results[k] for k in (
                "slam_system_ate_m", "loops_closed", "slam_hard_ate_m",
                "hard_loops_closed", "rgbd_tracking_fps_1chip",
                "rgbd_tracking_ate_m", "stereo_tracking_fps_1chip",
                "stereo_system_fps_1chip", "mono_system_fps_1chip")}}


def card_line():
    """``nvidia-smi``'s name and power limit of the cards."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def run_passes(device) -> dict:
    """The six passes in the reference's order; returns their numbers
    under the reference's names."""
    results = {}

    # ---------------- full system: tracking + mapping + loop closing -------
    cfg = SlamConfig(sensor=SENSOR_RGBD)
    log(f"rendering {N_LOOP} revisit frames...")
    ds = cached_seq(cfg, N_LOOP, "loop")
    t0 = time.perf_counter()
    voc = bench_vocabulary(cfg, ds, device)
    log(f"vocabulary: {voc.num_words} words in "
        f"{time.perf_counter() - t0:.1f} s")
    full, _ = bench_full_system(cfg, ds, voc, device)
    results["slam_system_fps_1chip"] = full["fps"]
    results["slam_system_ate_m"] = full["ate_m"]
    results["loops_closed"] = int(full["loops"])

    # ---------------- hard pass: two revisits + exposure drift -------------
    log(f"rendering {N_HARD} two-loop frames with exposure drift...")
    ds_h = cached_seq(cfg, N_HARD, "twoloop", exposure_drift=0.25)
    hard, _ = bench_hard(cfg, ds_h, voc, device)
    results["slam_hard_ate_m"] = hard["ate_m"]
    results["hard_loops_closed"] = int(hard["loops"])

    # ---------------- tracking-only: RGB-D / stereo / mono -----------------
    log(f"rendering {N_TRACK} orbit frames (RGB-D tracking-only)...")
    ds_r = cached_seq(cfg, N_TRACK, "orbit")
    fps_rgbd, tr, recs = bench_tracker_only(cfg, ds_r, N_TRACK,
                                            "rgbd tracking", device)
    est = np.stack([r.c_w for r in recs])
    gt = np.stack([ds_r.gt_pose_wc(i)[1] for i in range(N_TRACK)])
    results["rgbd_tracking_fps_1chip"] = fps_rgbd
    results["rgbd_tracking_ate_m"] = float(ate_rmse(est, gt))
    log(f"rgbd tracking ATE: {results['rgbd_tracking_ate_m']:.6f} m")
    ms, n_bytes = h2d_ms(tr, _wire_chunks(tr, ds_r.grays[:tr.chunk],
                                          ds_r.depths[:tr.chunk],
                                          ds_r.timestamps)[0])
    log(f"host-to-device copy of one RGB-D chunk ({n_bytes} B, as "
        f"process_chunk copies it): {ms:.3f} ms")

    log(f"rendering {N_STEREO} stereo pairs...")
    cfg_s = SlamConfig(sensor=SENSOR_STEREO)
    ds_s = cached_seq(cfg_s, N_STEREO, "orbit", stereo=True)
    fps_stereo, _, _ = bench_tracker_only(cfg_s, ds_s, N_STEREO,
                                          "stereo tracking", device)
    results["stereo_tracking_fps_1chip"] = fps_stereo
    fps_stereo_sys, _, _ = bench_stereo_system(cfg_s, ds_s, device)
    results["stereo_system_fps_1chip"] = fps_stereo_sys

    log("monocular run (System: init + tracking + mapping)...")
    fps_mono, _, _ = bench_mono(SlamConfig(sensor=SENSOR_MONOCULAR), ds_r,
                                device)
    results["mono_system_fps_1chip"] = fps_mono
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="the reference's bench passes on one NVIDIA card")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA device to measure (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        raise SystemExit(f"bench: --device {args.device} is no CUDA device; "
                         f"the bench measures the card")
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is False; the "
                         "bench runs only on an NVIDIA card")
    t0 = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    line = output_line(run_passes(device))
    log(f"bench: {time.perf_counter() - t0:.1f} s in all, rendering, "
        f"caching and training included")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
