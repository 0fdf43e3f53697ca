"""The pose solver's CUDA graph path (``solvers/pose_opt.py``).

On the card, ``pose_optimization`` replays one captured graph of the eager
solve: the tests marked ``cuda`` hold the replay to ``_pose_optimization_eager``
bit for bit on stereo, RGB-D and mono edge sets, check that no output is a
view of a static buffer, that a new key captures a new graph and a repeat
reuses the old one, that relocalization's vmapped solves stay eager, and that
a stereo chunk through ``Tracker.process_chunk`` gives the eager run's
records. They skip without a CUDA device. The CPU tests hold the bypass: on
the CPU and under ``torch.func.vmap`` the solve is the eager one and counts
no capture and no replay.

This file imports neither JAX nor the JAX package, so the card's tests run
on the card's machine (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_pose_lm_graph.py
"""

import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig, TrackingConfig
from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.io import SyntheticStereo
from orb_slam_2_ros_tpu_torch.pipeline import metrics, tracking
from orb_slam_2_ros_tpu_torch.solvers import pose_opt
from test_torch_cuda import stereo_cfg

EDGES = ("stereo", "rgbd", "mono")
COUNTERS = ("pose_lm.graph_captures", "pose_lm.graph_replays")


def pose_case(seed, n, edges, cfg=None, device="cpu"):
    """A solve's inputs: n points seen from a true pose with pixel noise
    growing with the octave, 10 % gross outliers, 5 % invalid edges, and a
    start 2-3 cm and about 0.03 rad off. ``edges``: every edge with a right
    coordinate (RGB-D), 60 % of them (stereo), or none (mono)."""
    cfg = cfg or SlamConfig()
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = se3.quat_exp(torch.from_numpy(rng.normal(0, 0.1, 3).astype(f32)))
    t = torch.from_numpy(rng.normal(0, 0.2, 3).astype(f32))
    xc = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                         rng.uniform(1.0, 6.0, (n, 1))], -1)
    qi, ti = se3.inverse(q, t)
    pts = se3.apply(qi, ti, torch.from_numpy(xc.astype(f32)))
    u = cam.fx * xc[:, 0] / xc[:, 2] + cam.cx
    v = cam.fy * xc[:, 1] / xc[:, 2] + cam.cy
    octave = rng.integers(0, 4, n).astype(np.int32)
    noise = rng.normal(0, 0.7, (n, 3)) * 1.2 ** octave[:, None]
    obs_uv = np.stack([u, v], -1) + noise[:, :2]
    share = {"stereo": 0.6, "rgbd": 1.0, "mono": 0.0}[edges]
    obs_ur = np.where(rng.uniform(size=n) < share,
                      u - cam.bf / xc[:, 2] + noise[:, 2], -1.0)
    out = rng.uniform(size=n) < 0.1
    obs_uv[out] += rng.uniform(15, 40, (out.sum(), 2))
    valid = rng.uniform(size=n) < 0.95
    q0 = se3.quat_mul(se3.quat_exp(torch.tensor([0.02, -0.015, 0.01])), q)
    t0 = t + torch.tensor([0.04, -0.03, 0.05])
    args = [q0, t0, pts, torch.from_numpy(obs_uv.astype(f32)),
            torch.from_numpy(obs_ur.astype(f32)), torch.from_numpy(octave),
            torch.from_numpy(valid)]
    return cfg, [a.to(device) for a in args]


class _Host:
    """An entry point with its own timers, as ``System``'s are, so that
    the solver's counters land somewhere to be read."""

    def __init__(self):
        self.timers = metrics.StageTimers()

    @metrics.entry_point
    def solve(self, *args):
        with pose_opt.done_flags() as flags:
            out = pose_opt.pose_optimization(*args)
        return out, flags

    @metrics.entry_point
    def vmapped(self, args, cfg, fn=None):
        """Four candidates' solves under ``torch.func.vmap``, as
        relocalization's: pose, points and edge mask batched, the frame's
        observations shared."""
        fn = fn or pose_opt.pose_optimization
        q0, t0, pts, obs_uv, obs_ur, octave, valid = args
        C = 4
        shift = torch.linspace(-0.02, 0.02, C, device=pts.device)
        qs = q0.expand(C, 4)
        ts = t0 + shift[:, None]
        ps = pts.expand(C, *pts.shape)
        vs = torch.stack([valid.roll(c) for c in range(C)])

        def lm(q, t, p, v):
            return fn(q, t, p, obs_uv, obs_ur, octave, v, cfg)
        return torch.func.vmap(lm)(qs, ts, ps, vs)

    def counts(self):
        return tuple(self.timers.count.get(c, 0) for c in COUNTERS)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("edges", EDGES)
def test_cpu_solve_is_the_eager_one(edges):
    """On the CPU the solve is the eager body, its flags included, and
    counts no capture and no replay."""
    cfg, args = pose_case(0, 300, edges)
    host = _Host()
    (q, t, inl, n), flags = host.solve(*args, cfg)
    with pose_opt.done_flags() as want_flags:
        want = pose_opt._pose_optimization_eager(*args, cfg)
    assert _equal((q, t, inl, n), want)
    assert len(flags) == 1 and torch.equal(flags[0], want_flags[0])
    rounds, iters = cfg.solver.pose_rounds, cfg.solver.pose_iters
    assert flags[0].shape == (rounds * iters,)
    assert host.counts() == (0, 0)
    assert int(n) > 200
    assert not pose_opt._GRAPHS


def test_vmapped_solve_is_eager_on_the_cpu():
    """Relocalization's vmapped solves: the eager body's results, and no
    capture or replay counted."""
    cfg, args = pose_case(1, 300, "stereo")
    host = _Host()
    got = host.vmapped(args, cfg)
    want = host.vmapped(args, cfg, fn=pose_opt._pose_optimization_eager)
    assert _equal(got, want)
    assert got[0].shape == (4, 4) and got[3].shape == (4,)
    assert host.counts() == (0, 0)


def test_only_plain_cuda_tensors_take_the_graph():
    """The path's test on what the code can see: CPU tensors and tensors
    wrapped by a ``torch.func`` transform never take the graph."""
    _, args = pose_case(2, 16, "mono")
    assert not pose_opt._graphable(args)
    seen = []

    def probe(q):
        seen.append(pose_opt._graphable([q] + args[1:]))
        return q
    torch.func.vmap(probe)(args[0].expand(3, 4))
    assert seen == [False]


def _cam_replace(cfg, **kw):
    return cfg.replace(camera=dataclasses.replace(cfg.camera, **kw))


@pytest.mark.parametrize("change", [
    {"fx": 500.0}, {"fy": 500.0}, {"cx": 300.0}, {"cy": 200.0}, {"bf": 63.0},
    {"scale_factor": 1.3}, {"huber_mono2": 6.0}, {"huber_stereo2": 8.0},
    {"pose_rounds": 3}, {"pose_iters": 8}, {"M": 299}, {"dtype": True}])
def test_graph_key_holds_what_the_kernels_bake_in(change):
    """Each value the captured kernels take as a constant changes the key;
    what the solve never reads (image size, feature count, tracking
    thresholds) does not."""
    cfg, args = pose_case(3, 300, "stereo")
    key = pose_opt._graph_key(args, cfg)
    other = cfg.replace(
        camera=dataclasses.replace(cfg.camera, width=320, height=240,
                                   th_depth=10.0),
        orb=dataclasses.replace(cfg.orb, n_features=500),
        tracking=TrackingConfig(min_init_stereo_kps=150))
    assert pose_opt._graph_key(args, other) == key
    (name, value), = change.items()
    args2 = list(args)
    if name in ("fx", "fy", "cx", "cy", "bf"):
        cfg2 = _cam_replace(cfg, **{name: value})
    elif name == "scale_factor":
        cfg2 = cfg.replace(orb=dataclasses.replace(cfg.orb, **change))
    elif name == "M":
        cfg2 = cfg
        args2 = [a if a.dim() == 1 and a.shape[0] in (3, 4) else a[:value]
                 for a in args]
    elif name == "dtype":
        cfg2 = cfg
        args2[5] = args[5].to(torch.int64)
    else:
        cfg2 = cfg.replace(solver=dataclasses.replace(cfg.solver, **change))
    assert pose_opt._graph_key(args2, cfg2) != key


# ----------------------------------------------------------------- card


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # a cache of its own, so that each test counts its own captures
    monkeypatch.setattr(pose_opt, "_GRAPHS", OrderedDict())
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1536, 200])
@pytest.mark.parametrize("edges", EDGES)
def test_cuda_replay_is_the_eager_solve(cuda, edges, n):
    """The replay equals the eager body bit for bit, three problems on one
    graph, and the done flags sum alike; one capture, three replays."""
    host = _Host()
    for seed in range(3):
        cfg, args = pose_case(seed, n, edges, device=cuda)
        got, flags = host.solve(*args, cfg)
        with pose_opt.done_flags() as want_flags:
            want = pose_opt._pose_optimization_eager(*args, cfg)
        assert _equal(got, want), (edges, n, seed)
        assert torch.equal(flags[0], want_flags[0])
        assert int(flags[0].sum()) == int(want_flags[0].sum())
        assert int(got[3]) > 0.6 * n
    assert host.counts() == (1, 3)
    assert len(pose_opt._GRAPHS) == 1


@pytest.mark.cuda
def test_cuda_outputs_outlive_the_next_replay(cuda):
    """Outputs are clones: a second replay with other inputs leaves the
    first call's tensors, and its flags, as they were."""
    host = _Host()
    cfg, args1 = pose_case(4, 1536, "stereo", device=cuda)
    _, args2 = pose_case(5, 1536, "stereo", device=cuda)
    out1, flags1 = host.solve(*args1, cfg)
    kept = [o.clone() for o in out1] + [flags1[0].clone()]
    out2, flags2 = host.solve(*args2, cfg)
    assert _equal(list(out1) + [flags1[0]], kept)
    assert not torch.equal(out1[2], out2[2])
    assert host.counts() == (1, 2)


@pytest.mark.cuda
def test_cuda_new_key_new_graph(cuda):
    """A new camera or a new M captures a new graph; a repeat of an old
    key replays the old one."""
    host = _Host()
    cfg, args = pose_case(6, 1536, "stereo", device=cuda)
    cfg_b = _cam_replace(cfg, fx=cfg.camera.fx + 1.0)
    _, small = pose_case(7, 300, "stereo", device=cuda)
    host.solve(*args, cfg)
    assert host.counts() == (1, 1)
    host.solve(*args, cfg_b)
    assert host.counts() == (2, 2)
    host.solve(*small, cfg)
    assert host.counts() == (3, 3)
    got, _ = host.solve(*args, cfg)
    host.solve(*small, cfg)
    assert host.counts() == (3, 5)
    assert _equal(got, pose_opt._pose_optimization_eager(*args, cfg))
    assert len(pose_opt._GRAPHS) == 3


@pytest.mark.cuda
def test_cuda_vmapped_solve_stays_eager(cuda):
    """Relocalization's vmapped solves on the card: eager, no capture and
    no replay, the eager body's results."""
    host = _Host()
    cfg, args = pose_case(8, 1536, "stereo", device=cuda)
    got = host.vmapped(args, cfg)
    want = host.vmapped(args, cfg, fn=pose_opt._pose_optimization_eager)
    assert _equal(got, want)
    assert host.counts() == (0, 0)
    assert not pose_opt._GRAPHS


@pytest.mark.cuda
def test_cuda_stereo_chunk_matches_the_eager_tracker(cuda, monkeypatch):
    """16 stereo frames through ``Tracker.process_chunk``: the records and
    the map with the graph path are those with the eager body forced in,
    two replays a frame after one capture."""
    cfg = stereo_cfg()
    n = 16
    ds = SyntheticStereo(cfg, n_frames=n, seed=0)
    lefts = np.stack([ds[i][0] for i in range(n)])
    rights = np.stack([ds[i][1] for i in range(n)])
    host = _Host()

    @metrics.entry_point
    def run(host):
        tracker = tracking.Tracker(cfg, device=cuda)
        return tracker, tracker.process_chunk(lefts, rights, ds.timestamps)

    graph_tracker, graph_recs = run(host)
    assert host.counts() == (1, 2 * n)
    eager_host = _Host()
    with monkeypatch.context() as mp:
        mp.setattr(tracking, "pose_optimization",
                   pose_opt._pose_optimization_eager)
        eager_tracker, eager_recs = run(eager_host)
    assert eager_host.counts() == (0, 0)
    assert [r.state for r in graph_recs] == [tracking.OK] * n
    for g, e in zip(graph_recs, eager_recs):
        for field in dataclasses.fields(g):
            assert np.array_equal(getattr(g, field.name),
                                  getattr(e, field.name)), field.name
    for name, g in graph_tracker.map._asdict().items():
        assert torch.equal(g, getattr(eager_tracker.map, name)), name
    for c in ("tracking.pose_lm_iters", "tracking.pose_lm_idle_iters"):
        assert host.timers.count[c] == eager_host.timers.count[c], c
    assert host.timers.count["tracking.pose_lm_iters"] == 80 * n
