"""The program's spans and counters (``pipeline/metrics.py``) on the CPU:
one chunk through a stereo and an RGB-D ``System`` gives every span of the
tracking path as often as the frame calls it, a child never longer than its
parent, the pose LM's launched and idle iterations, the profiler's ranges
under ``slam.`` only, and the benchmark's captures of B1 and the pose solver
as many calls as the frame makes."""

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu_torch.config import (CameraConfig, MapConfig,
                                             OrbConfig, SENSOR_RGBD,
                                             SENSOR_STEREO, SlamConfig,
                                             TrackingConfig, VocabConfig)
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD, SyntheticStereo
from orb_slam_2_ros_tpu_torch.pipeline import metrics, tracking
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.place import vocabulary
from orb_slam_2_ros_tpu_torch.solvers import pose_opt

torch.set_num_threads(2)

N = 8               # frames of the one chunk
LEVELS = 3
# the range names of the benchmark's own profile (slambench/profile.py),
# which the program's ranges must never take
BENCH_RANGES = {"frontend", "tracking", "local_mapping", "loop_closing",
                "relocalization", "b1", "entry", "reset", "harness"}
FRONTEND_PARTS = ("frontend.fast_score_map", "frontend.detect",
                  "frontend.budget_cut", "frontend.gaussian_blur",
                  "frontend.ic_angles", "frontend.descriptors")
# (child, parent): the child's seconds never exceed the parent's
NESTED = (
    ("frontend", "tracking"), ("tracking.frame_step", "tracking"),
    ("tracking.fetch", "tracking"), ("frontend.extract", "frontend"),
    ("frontend.resize_linear", "frontend.extract"),
    *((p, "frontend.extract") for p in FRONTEND_PARTS),
    ("tracking.search", "tracking.frame_step"),
    ("tracking.pose_solve", "tracking.frame_step"),
    ("tracking.map_update", "tracking.frame_step"),
    ("tracking.search_by_projection_pose", "tracking.search"),
    ("tracking.search_reference_kf", "tracking.search"),
    ("tracking.frustum_check", "tracking.search"),
    ("tracking.search_local_map", "tracking.search"),
    ("tracking.bump_visibility", "tracking.map_update"),
    ("tracking.commit_keyframe", "tracking.map_update"),
    ("mapping.mapping_step", "local_mapping"),
    ("loop.ingest_and_detect", "loop_closing"))


def small_cfg(sensor):
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=159.5,
                       cy=119.5, bf=26.0, th_depth=50.0)
    return SlamConfig(
        sensor=sensor, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=LEVELS, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640),
        tracking=TrackingConfig(min_init_stereo_kps=150),
        vocab=VocabConfig(k=6, levels=3))


def _frames(cfg):
    ds = (SyntheticStereo if cfg.sensor == SENSOR_STEREO else SyntheticRGBD)(
        cfg, n_frames=N, seed=0)
    return (np.stack([ds[i][0] for i in range(N)]),
            np.stack([ds[i][1] for i in range(N)]), list(ds.timestamps[:N]))


def _vocab(cfg):
    train = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8),
                                              dtype=np.uint32)
    return vocabulary.train_vocabulary(train, cfg, seed=0, device="cpu")


@pytest.fixture(scope="module", params=[SENSOR_STEREO, SENSOR_RGBD],
                ids=["stereo", "rgbd"])
def run(request):
    """One chunk of N frames through ``System`` (loop closing on), inside
    the benchmark's captures of B1 and the pose solver, every call kept."""
    from slambench import cell
    cfg = small_cfg(request.param)
    grays, auxs, ts = _frames(cfg)
    system = System(cfg, ba_window=8, device="cpu", vocab=_vocab(cfg))
    with cell.captures(0) as (b1, lm):
        b1.mode = lm.mode = "every"
        recs = system.track_chunk(grays, auxs, ts)
    assert [r.state for r in recs] == [tracking.OK] * N
    return {"cfg": cfg, "system": system, "b1": b1, "lm": lm,
            "count": dict(system.timers.count),
            "seconds": dict(system.timers.total_s)}


def test_every_span_and_counter_per_frame(run):
    c = run["count"]
    stereo = run["cfg"].sensor == SENSOR_STEREO
    extracts = (2 if stereo else 1) * N
    expect = {
        "tracking": 1, "local_mapping": 1, "loop_closing": 1,
        "frontend": N, "frontend.extract": extracts,
        "frontend.resize_linear": (LEVELS - 1) * extracts,
        **{p: LEVELS * extracts for p in FRONTEND_PARTS},
        "tracking.frame_step": N, "tracking.search": 4 * N,
        "tracking.search_by_projection_pose": N,
        "tracking.search_reference_kf": N, "tracking.frustum_check": N,
        "tracking.search_local_map": N, "tracking.pose_solve": 2 * N,
        "tracking.map_update": 2 * N, "tracking.bump_visibility": N,
        "tracking.commit_keyframe": N, "tracking.fetch": 1,
        "tracking.pose_lm_iters": 80 * N,
        "mapping.mapping_step": 1, "loop.ingest_and_detect": 1}
    if stereo:
        expect["frontend.stereo"] = N
    assert {k: c.get(k) for k in expect} == expect
    assert "frontend.stereo" in c or not stereo
    assert 0 <= c["tracking.pose_lm_idle_iters"] <= 80 * N
    # B1: four calls a tracked frame (the motion-model search and its
    # widened retry, the reference keyframe, the local map) and one per
    # projection search of the mapping step
    assert c["b1"] == 4 * N + c["mapping.search_by_projection_pose"]
    # counters carry no seconds
    assert run["seconds"]["tracking.pose_lm_iters"] == 0.0
    assert run["seconds"]["tracking.pose_lm_idle_iters"] == 0.0


def test_a_child_never_exceeds_its_parent(run):
    s = run["seconds"]
    for child, parent in NESTED:
        assert 0.0 < s[child] <= s[parent], (child, parent)
    parts = {
        "tracking": ("frontend", "tracking.frame_step", "tracking.fetch"),
        "frontend": ("frontend.extract", "frontend.stereo"),
        "frontend.extract": ("frontend.resize_linear",) + FRONTEND_PARTS,
        "tracking.frame_step": ("tracking.search", "tracking.pose_solve",
                                "tracking.map_update")}
    for parent, children in parts.items():
        assert sum(s.get(ch, 0.0) for ch in children) <= s[parent], parent


def test_captures_see_the_calls_the_frame_makes(run):
    """The benchmark's hooks keep working: its capture of the pose solver
    sees two solves a frame, its capture of B1 every B1 call."""
    from slambench import cell
    assert run["lm"].calls == cell.SOLVES_PER_FRAME * N == len(run["lm"].kept)
    assert run["b1"].calls == run["count"]["b1"] == len(run["b1"].kept)
    # the solver's outputs are the four the capture's replay expects
    assert all(len(out) == 4 for _, out in run["lm"].kept)


def test_idle_iterations_recounted_from_the_done_flags(run):
    """The counter against the ``done`` flags of each captured solve run
    alone: the flag at the start of each iteration, false at the start of
    each round and never cleared inside one."""
    cfg = run["cfg"]
    rounds, iters = cfg.solver.pose_rounds, cfg.solver.pose_iters
    idle = 0
    for args, _ in run["lm"].kept:
        with pose_opt.done_flags() as flags:
            pose_opt.pose_optimization(*args)
        assert len(flags) == 1 and flags[0].shape == (rounds * iters,)
        per_round = flags[0].reshape(rounds, iters).tolist()
        for done in per_round:
            assert not done[0]
            assert done == sorted(done)     # once set, set to the round's end
            idle += sum(done)
    assert run["count"]["tracking.pose_lm_idle_iters"] == idle


def test_a_solve_at_its_optimum_idles_after_one_iteration():
    """Exact observations and the true pose as the start: every round's
    first step is zero, so each round converges in its first iteration and
    the other nine of its ten are idle."""
    cfg = small_cfg(SENSOR_STEREO)
    cam = cfg.camera
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(2, 6, 200)], -1).astype(np.float32)
    u = cam.fx * pts[:, 0] / pts[:, 2] + cam.cx
    v = cam.fy * pts[:, 1] / pts[:, 2] + cam.cy
    args = [torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3),
            torch.from_numpy(pts), torch.from_numpy(np.stack([u, v], -1)),
            torch.from_numpy(u - cam.bf / pts[:, 2]),
            torch.zeros(200, dtype=torch.int32),
            torch.ones(200, dtype=torch.bool)]
    with pose_opt.done_flags() as flags:
        *_, n = pose_opt.pose_optimization(*args, cfg)
    rounds, iters = cfg.solver.pose_rounds, cfg.solver.pose_iters
    assert int(n) == 200
    assert int(flags[0].sum()) == rounds * (iters - 1)
    # outside done_flags() a solve leaves nothing behind
    assert len(pose_opt.pose_optimization(*args, cfg)) == 4


def test_profiler_ranges_are_slam_prefixed():
    """Under ``torch.profiler`` the program's spans are ranges named
    ``slam.<span>``, whether or not a ``System`` is active, and none takes a
    range name of the benchmark."""
    cfg = small_cfg(SENSOR_RGBD)
    grays, auxs, ts = _frames(cfg)
    tracker = tracking.Tracker(cfg, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracker.process_chunk(grays[:2], auxs[:2], ts[:2])
    names = {e.name for e in prof.events()}
    assert not names & BENCH_RANGES
    ours = {n for n in names if n.startswith(metrics.PREFIX)}
    assert {"slam.frontend", "slam.frontend.extract", "slam.b1",
            "slam.tracking.pose_solve", "slam.tracking.search",
            "slam.tracking.fetch"} <= ours
    annotations = [e.name() for e in prof.profiler.kineto_results.events()
                   if getattr(e, "is_user_annotation", lambda: False)()]
    assert annotations and all(n.startswith(metrics.PREFIX)
                               for n in annotations)


def test_no_profiler_enters_no_range(monkeypatch):
    """Without a profiler recording no ``record_function`` is entered, and
    the system's timers still get every span."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    cfg = small_cfg(SENSOR_RGBD)
    grays, auxs, ts = _frames(cfg)
    system = System(cfg, enable_loop_closing=False, device="cpu")
    system.track_chunk(grays[:2], auxs[:2], ts[:2])
    assert system.timers.count["frontend"] == 2
    assert system.timers.count["tracking.pose_solve"] == 4


def test_layers_called_directly_add_to_no_timers():
    """With no ``System`` entry point running, a layer adds nothing: not to
    a system built beside it, nor anywhere else."""
    cfg = small_cfg(SENSOR_RGBD)
    grays, auxs, ts = _frames(cfg)
    system = System(cfg, enable_loop_closing=False, device="cpu")
    system.tracker.process_chunk(grays[:2], auxs[:2], ts[:2])
    with metrics.span("frontend"):
        metrics.count("tracking.pose_lm_iters", 80)
    assert dict(system.timers.total_s) == {}
    assert dict(system.timers.count) == {}
    assert metrics._ACTIVE.get() is None


def test_span_and_entry_point_bookkeeping():
    """A decorated function keeps its name and doc; nested spans each add
    their count; ``entry_point`` restores the previous timers even when the
    method raises; a counter adds its ``n`` and no seconds."""
    @metrics.span("outer")
    def outer(x):
        """outer's doc"""
        with metrics.span("inner"):
            return x + 1

    class Holder:
        def __init__(self):
            self.timers = metrics.StageTimers()

        @metrics.entry_point
        def work(self, fail=False):
            outer(1)
            outer(2)
            metrics.count("things", 3)
            if fail:
                raise ValueError("fail")
            return metrics._ACTIVE.get()

    h = Holder()
    assert outer.__name__ == "outer" and outer.__doc__ == "outer's doc"
    assert h.work() is h.timers
    assert metrics._ACTIVE.get() is None
    with pytest.raises(ValueError):
        h.work(fail=True)
    assert metrics._ACTIVE.get() is None
    assert h.timers.count == {"outer": 4, "inner": 4, "things": 6}
    assert h.timers.total_s["things"] == 0.0
    assert h.timers.total_s["inner"] <= h.timers.total_s["outer"]
    summary = h.timers.summary()
    assert summary["things"]["count"] == 6 and summary["outer"]["count"] == 4
