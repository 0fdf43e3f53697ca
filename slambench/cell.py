"""One run of one cell: set-up, the measured window, the traced segment,
and the outputs that ``check.py`` judges.

The cell's configuration, traffic and limits are files found by name
(``find_cell``); the port is driven only through its public entry point,
``System`` (``track_rgbd``, ``track_chunk``, ``reset``, ``timers``), and
read through its map and records once the window has closed. Hooks sit in
the port's module namespace for the whole run, so that set-up and the
window run the same code: the captures around B1's one call site
(``frontend.matcher.masked_best_two``), which keeps a copy of the inputs of
the calls drawn from the seed while the window is open, and around the
tracker's pose solver (``pipeline.tracking.pose_optimization``), which keeps
the inputs of every frame's last solve in the window, the one whose pose
the frame's record returns; and, in the traced segment only, the layer
ranges of ``profile.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from slambench import check, profile, stream
from slambench.scene import frozen_np
from slambench.scene import render as scene

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BENCHMARK = os.path.join(REPO, "BENCHMARK.json")
# B1 calls whose inputs the window keeps for the check: every
# CAPTURE_EVERY-th from a phase drawn from the seed, at most CAPTURE_MAX
CAPTURE_EVERY = 37
CAPTURE_MAX = 24
# the tracker's pose solves a frame makes (``_track_core``: after the
# motion-model search, after the local-map search); the last one's pose is
# the frame's
SOLVES_PER_FRAME = 2


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict         # the configuration file
    traffic: dict        # the traffic file
    limits: dict         # the correctness limits file
    end_to_end: list     # entries of BENCHMARK.json that this cell reports
    per_layer: list
    root: str            # the directory the cell's files were found under


def _load(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, benchmark: str = BENCHMARK, root: str = HERE) -> Cell:
    """The cell ``name`` of ``benchmark``: its configuration from the file
    the configuration's entry names (relative to the benchmark's
    directory), its traffic from ``<root>/traffic/<traffic>.json``, its
    limits from ``<root>/limits/<cell>.json``."""
    bench = _load(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = os.path.join(os.path.dirname(os.path.abspath(benchmark)),
                            configs[w["config"]]["file"])
    traffic = stream.validate(
        _load(os.path.join(root, "traffic", w["traffic"] + ".json")))
    return Cell(
        name=name, chips=int(w["chips"]), config=_load(cfg_file),
        traffic=traffic,
        limits=_load(os.path.join(root, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


def metric_reader(root: str, name: str) -> Callable:
    """``read(ctx)`` of ``<root>/metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Capture:
    """Wraps one call site of the port; while ``on``, keeps a copy of the
    tensor inputs and the outputs of the calls the seed draws
    (``window``: every ``every``-th call from a phase drawn from the seed,
    at most ``most``), or of every call (``every``)."""

    def __init__(self, fn, seed: int = 0, salt: int = 0, every: int = 1,
                 most: int = 0):
        self.fn = fn
        self.mode = None
        self.calls = 0
        self.every, self.most = every, most
        self.phase = int(np.random.default_rng(
            scene.seed_to_rng_seed(seed) ^ salt).integers(every))
        self.kept: List = []

    def __call__(self, *args):
        outs = self.fn(*args)
        if self.mode == "every" or (
                self.mode == "window" and len(self.kept) < self.most
                and (self.calls + self.phase) % self.every == 0):
            self.kept.append((tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), outs))
        self.calls += self.mode is not None
        return outs


@contextlib.contextmanager
def captures(seed: int):
    """(B1's capture, the pose solver's capture), each around its one call
    site: ``frontend.matcher.masked_best_two`` and
    ``pipeline.tracking.pose_optimization``."""
    from orb_slam_2_ros_tpu_torch.frontend import matcher
    from orb_slam_2_ros_tpu_torch.pipeline import tracking
    b1 = _Capture(matcher.masked_best_two, seed, 0xB1, CAPTURE_EVERY,
                  CAPTURE_MAX)
    lm = _Capture(tracking.pose_optimization)
    matcher.masked_best_two = b1
    tracking.pose_optimization = lm
    try:
        yield b1, lm
    finally:
        matcher.masked_best_two = b1.fn
        tracking.pose_optimization = lm.fn


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Session:
    """One session of the system: from its first frame to the reset that
    ends it (or the end of the run)."""

    def __init__(self):
        # (position, image, record, in_window, inputs of the frame's last
        # pose solve: kept in the window only)
        self.records = []
        self.map = None         # the port's map when the session ended


def last_solves(calls: List, n_frames: int) -> List:
    """The inputs of each frame's last pose solve among one hand-in's
    solves, in order. A hand-in whose chunk was tracked again (the replay
    around a relocalization) made more; its records are the last pass's,
    so its last ``SOLVES_PER_FRAME`` x frames solves. ``None`` for each
    frame where the hand-in made fewer."""
    k = SOLVES_PER_FRAME
    if len(calls) < k * n_frames:
        return [None] * n_frames
    mine = calls[len(calls) - k * n_frames:]
    return [args for args, _ in mine[k - 1::k]]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", control: bool = False, on_open=None,
             log=print) -> Dict:
    """Set-up, window, traced segment and check of one run. Returns the
    window's counts and times, the per-layer context, the compared numbers
    and, with ``control``, the control's numbers."""
    from orb_slam_2_ros_tpu_torch import convert
    from orb_slam_2_ros_tpu_torch.config import SENSOR_RGBD, SENSOR_STEREO
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    t_start = time.perf_counter()
    tr = cell.traffic
    slam = cell.config["slam_config"]
    cfg = convert.config_from_dict(slam)
    if cfg.sensor not in (SENSOR_RGBD, SENSOR_STEREO):
        raise ValueError("the harness drives RGB-D and stereo systems")
    stereo = cfg.sensor == SENSOR_STEREO
    c = cfg.camera
    cam = scene.Camera(c.width, c.height, c.fx, c.fy, c.cx, c.cy, c.bf)
    gt = frozen_np.TRAJECTORIES[tr["trajectory"]](
        tr["trajectory_frames"])[:tr["frames"]]
    planes = scene.make_room(seed, device)
    grays, auxs = scene.wire_sequence(planes, gt, cam, stereo)
    del planes
    log(f"set-up: scene {time.perf_counter() - t_start:.3f} s")
    voc = vocabulary.load_npz(os.path.join(cell.root, cell.config["vocabulary"]),
                              device=device)
    system = System(cfg, vocab=voc, device=device)
    single = tr["hand_in"] == 1 and not stereo
    n_sent = [0]

    def hand_in(h: stream.HandIn):
        ts = [(n_sent[0] + i) / 30.0 for i in range(len(h.images))]
        n_sent[0] += len(h.images)
        if single:
            i = h.images[0]
            return [system.track_rgbd(grays[i], auxs[i], ts[0])]
        return system.track_chunk(grays[h.images], auxs[h.images], ts)

    sessions = [_Session()]

    def reset(ranged=None):
        if sessions[-1].map is None:
            sessions[-1].map = system.tracker.map
        sessions.append(_Session())
        with ranged("reset") if ranged else contextlib.nullcontext():
            system.reset()

    def play(h, in_window, ranged=None):
        if h.reset_before:
            reset(ranged)
        mark = len(lm_cap.kept)
        recs = hand_in(h)
        solves = last_solves(lm_cap.kept[mark:], len(recs))
        del lm_cap.kept[mark:]
        sessions[-1].records += [
            (p, i, r, in_window, s if in_window else None)
            for p, i, r, s in zip(h.positions, h.images, recs, solves)]
        return len(recs)

    with captures(seed) as (cap, lm_cap):
        calls = stream.hand_ins(tr)
        warmed = 0
        while warmed < tr["warm_frames"]:
            warmed += play(next(calls), False)
        if tr["reset_after_warm"]:
            reset()
            calls = stream.hand_ins(tr)
        _sync(device)
        log(f"set-up: warm-up of {warmed} frames done at "
            f"{time.perf_counter() - t_start:.3f} s")
        # what set-up made stays alive: the collector need not walk it again
        # inside the window
        gc.collect()
        gc.freeze()
        timers0 = {k: (system.timers.total_s[k], system.timers.count[k])
                   for k in list(system.timers.total_s)}
        steps0 = system.mapper.n_executed
        counts0 = _counters(system)
        cap.mode, lm_cap.mode = "window", "every"
        call_s, frames = [], 0
        if on_open is not None:
            on_open()
        t_open = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            frames += play(next(calls), True)
            t1 = time.perf_counter()
            call_s.append(t1 - t0)
            if t1 - t_open >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t_open
        cap.mode = lm_cap.mode = None
        timers = {k: (system.timers.total_s[k] - timers0.get(k, (0, 0))[0],
                      system.timers.count[k] - timers0.get(k, (0, 0))[1])
                  for k in system.timers.total_s}
        mapping_steps = system.mapper.n_executed - steps0
        counts = {k: v - counts0[k] for k, v in _counters(system).items()}
        sessions[-1].map = map_copy(system.tracker.map)
        traced = None
        if trace:
            traced = _traced_segment(system, calls, play, cap, device,
                                     tr["trace_frames"])
    log(f"window: {frames} frames in {window_s:.3f} s; mapping steps "
        f"{mapping_steps}; kept {len(cap.kept)} B1 calls; counts {counts}; "
        "stage seconds "
        + str({k: round(v[0], 3) for k, v in timers.items()})
        + "; call ms by quarter of the window "
        + str([round(1e3 * float(np.median(q)), 1) for q in
               np.array_split(np.array(call_s), 4) if len(q)]))
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    attempted = frames
    failed = sum(1 for s in sessions for j, (_, _, r, w, _) in
                 enumerate(s.records) if w and j > 0 and r.state != OK)
    out = _outputs(sessions, cap.kept, grays, gt, slam, seed, OK, tr)
    del system, sessions
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if traced is not None:
        traced = _read_trace(traced)
    ctx = {"hand_in": tr["hand_in"], "single": single, "frames": frames,
           "window_s": window_s, "call_s": call_s, "timers": timers,
           "mapping_steps": mapping_steps, "trace": traced}
    t_check = time.perf_counter()
    numbers = check.numbers(out, device)
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    result = {"attempted": attempted, "failed": failed, "frames": frames,
              "window_s": window_s, "memory_peak_bytes": int(memory_peak),
              "ctx": ctx, "numbers": numbers}
    if control:
        result["control"] = check.numbers(out, device, control=True)
    return result


def _counters(system) -> Dict[str, int]:
    """The port's own event counters, read in the window's log lines."""
    lc = system.loop_closer
    return {"ladders": lc.n_ladders if lc else 0,
            "corrections": lc.n_corrections if lc else 0,
            "reloc_attempts": system.n_reloc_attempts,
            "resets": system.n_resets}


# the map fields the check reads
MAP_FIELDS = ("kf_q", "kf_t", "kf_valid", "kf_frame_id", "kf_uv", "kf_octave",
              "kf_desc", "kf_kp_valid", "kf_ur", "mp_pos", "mp_valid",
              "mp_first_kf")


def map_copy(m):
    """The fields the check reads, copied on the device, so that the
    traced segment that follows the window cannot move them."""
    return {k: getattr(m, k).clone() for k in MAP_FIELDS}


def _map_fields(m) -> Dict[str, np.ndarray]:
    if not isinstance(m, dict):
        m = {k: getattr(m, k) for k in MAP_FIELDS}
    return {k: v.cpu().numpy() for k, v in m.items()}


def _outputs(sessions, b1_calls, grays, gt, slam, seed, OK, tr) -> Dict:
    """What the check reads, on the host but for the captured inputs: the
    sessions that the window saw, their tracked runs of consecutive OK
    frames, each OK frame's pose with its last solve's inputs (but a
    session's first frame, which initializes at its own pose), their maps,
    the keyframes made in the window, and those drawn from them for the
    frontend's check."""
    runs, maps, window_kfs, solved = [], [], [], []
    for s in sessions:
        in_window = {p for p, _, _, w, _ in s.records if w}
        if not in_window:
            continue
        run = None
        prev = None
        for p, i, r, w, solve in s.records:
            good = w and r.state == OK
            if good and p > 0:
                solved.append((solve, r.R_wc, r.c_w))
            if good and run is not None and prev == p - 1:
                run["images"].append(i)
                run["poses"].append((r.R_wc, r.c_w))
            elif good:
                run = {"images": [i], "poses": [(r.R_wc, r.c_w)]}
                runs.append(run)
            else:
                run = None
            prev = p
        f = _map_fields(s.map)
        rows = np.flatnonzero(f["kf_valid"])
        kf_image = {int(k): stream.image_of(tr, int(f["kf_frame_id"][k]))
                    for k in rows}
        live = f["mp_valid"]
        maps.append({"kf_image": kf_image, "kf_q": f["kf_q"],
                     "kf_t": f["kf_t"], "mp_pos": f["mp_pos"][live],
                     "mp_first_kf": f["mp_first_kf"][live]})
        for k in rows:
            if int(f["kf_frame_id"][k]) not in in_window:
                continue
            v = f["kf_kp_valid"][k]
            window_kfs.append({"image": kf_image[int(k)],
                               "xy": f["kf_uv"][k][v],
                               "octave": f["kf_octave"][k][v],
                               "desc": f["kf_desc"][k][v],
                               "ur": f["kf_ur"][k][v]})
    rng = np.random.default_rng(scene.seed_to_rng_seed(seed) ^ 0x5EED)
    pick = rng.permutation(len(window_kfs))[:check.N_KEYFRAMES]
    return {"config": slam, "grays": grays, "gt_poses": gt,
            "tracked_runs": [r for r in runs if len(r["images"]) > 1],
            "solved": solved, "maps": maps, "window_keyframes": window_kfs,
            "keyframes": [window_kfs[i] for i in sorted(pick)],
            "b1_calls": b1_calls}


def _traced_segment(system, calls, play, cap, device, n_frames):
    """``n_frames`` more frames of the stream under ``torch.profiler``,
    with the harness's ranges around the port's layers and every B1 call
    kept for its work count."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kept, cap.kept = cap.kept, []
    done = 0
    names = {n for _, _, n in profile.layer_ranges()} | {"entry", "reset"}

    def ranged(name):
        return torch.profiler.record_function(name)
    with profile.ranges_around_layers():
        _sync(device)
        with torch.profiler.profile(activities=acts) as prof:
            cap.mode = "every"
            t0 = time.perf_counter()
            while done < n_frames:
                h = next(calls)
                with torch.profiler.record_function("entry"):
                    done += play(h, False, ranged)
            _sync(device)
            wall = time.perf_counter() - t0
            cap.mode = None
    b1_calls, cap.kept = cap.kept, kept
    return {"prof": prof, "wall_s": wall, "frames": done, "names": names,
            "b1_calls": b1_calls}


def _read_trace(t) -> Dict:
    read = profile.read(t["prof"], t["names"])
    from slambench.reference import b1 as b1_ref
    bound_s = sum(b1_ref.work(args)["bound_us"] for args, _ in t["b1_calls"]) / 1e6
    return {"window_s": t["wall_s"], "frames": t["frames"],
            "launches": read["launches"], "busy_s": read["busy_s"],
            "device_ops": read["device_ops"], "idle_gaps": read["idle_gaps"],
            "b1_calls": len(t["b1_calls"]), "b1_bound_s": bound_s,
            "b1_device_s": profile.kernel_seconds(read["device_ops"],
                                                  "masked_best_two")}
