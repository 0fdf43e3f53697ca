"""Card-only checks of the PyTorch port; they skip without a CUDA device.

This file imports neither JAX nor the JAX package's tests, so it runs on
the card's machine, which has no JAX (tests/conftest.py imports it, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import EDGE_CASES
from orb_slam_2_ros_tpu_torch.bench_match_kernel import (assert_equal,
                                                        make_case)
from orb_slam_2_ros_tpu_torch.config import (CameraConfig, MapConfig,
                                             OrbConfig, SENSOR_RGBD,
                                             SENSOR_STEREO, SlamConfig,
                                             TrackingConfig)
from orb_slam_2_ros_tpu_torch import kernel_timing
from orb_slam_2_ros_tpu_torch.frontend import matcher
from orb_slam_2_ros_tpu_torch.io import SyntheticRGBD, SyntheticStereo
from orb_slam_2_ros_tpu_torch.map.state import MapState
from orb_slam_2_ros_tpu_torch.ops import match_kernel
from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam_2_ros_tpu_torch.pipeline.slam import System
from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK, Tracker


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(256, 640), (1536, 1536), (4096, 1536)])
def test_cuda_masked_best_two_matches_plain(cuda, shape):
    args = [torch.from_numpy(x).to(cuda) for x in make_case(*shape, seed=3)]
    before = match_kernel.LAUNCHES
    got = match_kernel.masked_best_two(*args)
    assert match_kernel.LAUNCHES == before + 1
    want = match_kernel.masked_best_two_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_masked_best_two_edge_cases(cuda, case):
    """Ragged shapes (no multiple of any tile), M = 1, the largest M, no
    column passing, every gate open: all four outputs equal the plain
    version's."""
    N, M, gates = case
    args = [torch.from_numpy(x).to(cuda)
            for x in make_case(N, M, seed=4, gates=gates)]
    got = match_kernel.masked_best_two(*args)
    want = match_kernel.masked_best_two_reference(*args)
    assert assert_equal(got, want, f"{N}x{M} {gates}") == 0
    assert got[0]._base is not None and got[0]._base.shape == (4, N)
    has = int((want[1] < 1024).sum())
    assert has == {"closed": 0, "open": N}.get(gates, has)


def test_cuda_tracker_defaults_to_the_card(cuda):
    assert Tracker(SlamConfig()).device.type == "cuda"


def small_cfg():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    return SlamConfig(
        sensor=SENSOR_RGBD, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640,
                      local_map_cap=1024),
        tracking=TrackingConfig(min_init_stereo_kps=200))


def test_cuda_tracker_matches_cpu(cuda):
    """The slice on the card against the same slice on the CPU: same
    states, inliers within 5%, camera centres within 5 mm (float sums run
    in another order on the card)."""
    cfg = small_cfg()
    ds = SyntheticRGBD(cfg, n_frames=8, seed=0)
    grays = np.stack([ds[i][0] for i in range(8)])
    depths = np.stack([ds[i][1] for i in range(8)])
    recs = {}
    for dev in ("cpu", cuda):
        before = match_kernel.LAUNCHES
        recs[str(dev)] = Tracker(cfg, device=dev).process_chunk(
            grays, depths, ds.timestamps)
        launches = match_kernel.LAUNCHES - before
        assert launches == (0 if dev == "cpu" else 4 * 8)
    cpu, gpu = recs["cpu"], recs["cuda"]
    assert [r.state for r in gpu] == [r.state for r in cpu] == [OK] * 8
    for c, g in zip(cpu, gpu):
        assert abs(g.n_inliers - c.n_inliers) <= 0.05 * c.n_inliers
    np.testing.assert_allclose(np.stack([r.c_w for r in gpu]),
                               np.stack([r.c_w for r in cpu]), atol=5e-3)


def test_cuda_system_defaults_to_the_card(cuda):
    system = System(SlamConfig(), enable_loop_closing=False)
    assert system.device.type == "cuda"
    assert all(v.is_cuda for v in system.tracker.map._asdict().values())


def test_cuda_mapping_step_matches_cpu(cuda):
    """One mapping step from one map, on the CPU and on the card. The map is
    built on the CPU (40 frames: 3 keyframes). The step's 8 fusion calls
    launch the matcher kernel, and each equals its plain version on the
    call's own arguments. Integer outputs: the same keyframe count, spawned
    and fused counts; culled points and the live count within 1%; the
    observation table and the remapped associations equal on >= 98% of
    their entries (the BA's float sums run in another order on the card, so
    an edge at the chi2 gate can fall the other way)."""
    cfg = small_cfg()
    n = 40
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0)
    tracker = Tracker(cfg, device="cpu")
    tracker.process_chunk(np.stack([ds[i][0] for i in range(n)]),
                          np.stack([ds[i][1] for i in range(n)]),
                          ds.timestamps)
    m_cpu, last_cpu = tracker.carry.m, tracker.carry.last_mp
    assert int(m_cpu.n_kfs) >= 3

    out = {}
    for dev in ("cpu", "cuda"):
        m = MapState(*(v.to(dev) for v in m_cpu))
        mapper = LocalMapper(cfg, window=8)
        before = match_kernel.LAUNCHES
        with kernel_timing.capture_calls(matcher, "masked_best_two") as calls:
            m2, n_culled, last2 = mapper.run(m, last_cpu.to(dev))
        assert len(calls) == 8
        assert match_kernel.LAUNCHES - before == (8 if dev == "cuda" else 0)
        if dev == "cuda":
            assert all(v.is_cuda for v in m2._asdict().values())
            for args in calls:
                got = match_kernel.masked_best_two_cuda(*args)
                want = match_kernel.masked_best_two_reference(*args)
                assert assert_equal(got, want, "fusion call") == 0
        step = mapper.last_step
        out[dev] = dict(
            n_kfs=int(m2.n_kfs), n_mps=int(m2.n_mps), n_culled=int(n_culled),
            n_spawned=int(step["n_spawned"]), n_fused=int(step["n_fused"]),
            kf_mp=m2.kf_mp.cpu().numpy(), last=last2.cpu().numpy(),
            valid=int(m2.mp_valid.sum()))
    cpu, gpu = out["cpu"], out["cuda"]
    for key in ("n_kfs", "n_spawned", "n_fused"):
        assert gpu[key] == cpu[key], key
    for key in ("n_mps", "n_culled"):
        assert abs(gpu[key] - cpu[key]) <= 0.01 * cpu[key], key
    assert gpu["n_mps"] == gpu["valid"] and cpu["n_culled"] > 0
    assert (gpu["kf_mp"] == cpu["kf_mp"]).mean() >= 0.98
    assert (gpu["last"] == cpu["last"]).mean() >= 0.98


def test_cuda_full_system_matches_cpu(cuda):
    """``System`` with loop closing on (its default) chooses the card, keeps
    the loop closer's state there, and over 24 frames tracks, maps and
    ingests as the same system does on the CPU (no loop on 24 frames)."""
    import dataclasses

    from orb_slam_2_ros_tpu_torch.config import VocabConfig
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    pending = System(cfg)           # no vocabulary: trained at the first chunk
    assert pending.device.type == "cuda" and pending._vocab_pending
    n = 24
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0)
    grays = np.stack([ds[i][0] for i in range(n)])
    depths = np.stack([ds[i][1] for i in range(n)])
    train = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8),
                                              dtype=np.uint32)
    out = {}
    for dev in ("cpu", "cuda"):
        voc = vocabulary.train_vocabulary(train, cfg, seed=0, device=dev)
        system = System(cfg, ba_window=8, vocab=voc,
                        device=None if dev == "cuda" else dev)
        lc = system.loop_closer
        assert lc.state.db.kf_word.device.type == dev
        recs = system.track_chunk(grays, depths, ds.timestamps)
        system.flush()
        assert lc._n_ingested == system.tracker.n_kfs >= 3
        assert lc.n_loops_closed == 0 and not lc._pending_verdict
        out[dev] = ([r.state for r in recs], system.tracker.n_kfs,
                    np.stack([r.c_w for r in recs]),
                    lc.state.db.kf_word[:lc._n_ingested].cpu().numpy())
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu[0] == cpu[0] == [OK] * n and gpu[1] == cpu[1]
    np.testing.assert_allclose(gpu[2], cpu[2], atol=5e-3)
    assert (gpu[3] == cpu[3]).mean() >= 0.98


def _to(x, dev):
    """A NamedTuple of tensors (and plain numbers) on ``dev``."""
    return type(x)(*(v.to(dev) if torch.is_tensor(v) else v for v in x))


def test_cuda_relocalizer_matches_cpu(cuda):
    """One relocalization attempt on the card against the same attempt on
    the CPU, the card fed the CPU's RANSAC draw: the same ``ok`` and
    candidate, inliers within 2, the camera centre within 1e-3 m; the
    widening's one matcher call launches the kernel and equals the plain
    version on its own arguments. The map is built by ``System`` on the
    CPU over 32 frames."""
    import dataclasses

    from orb_slam_2_ros_tpu_torch.config import VocabConfig
    from orb_slam_2_ros_tpu_torch.frontend import frame as frame_mod
    from orb_slam_2_ros_tpu_torch.geometry import se3
    from orb_slam_2_ros_tpu_torch.pipeline import relocalization
    from orb_slam_2_ros_tpu_torch.place import vocabulary
    from orb_slam_2_ros_tpu_torch.solvers import pnp

    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    n = 32
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0)
    train = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8),
                                              dtype=np.uint32)
    voc = vocabulary.train_vocabulary(train, cfg, seed=0, device="cpu")
    system = System(cfg, ba_window=8, vocab=voc, device="cpu")
    system.track_chunk(np.stack([ds[i][0] for i in range(n)]),
                       np.stack([ds[i][1] for i in range(n)]), ds.timestamps)
    system.flush()
    m, st = system.tracker.map, system.loop_closer.state
    g, d = ds[20]
    drawn = []
    draw = pnp.draw_samples

    def recording(*args, **kwargs):
        drawn.append(draw(*args, **kwargs))
        return drawn[-1]

    out = {}
    for dev in ("cpu", "cuda"):
        frame = frame_mod.build_rgbd(torch.from_numpy(g).float(),
                                     torch.from_numpy(d).float(), cfg)
        frame = frame._replace(kps=_to(frame.kps, dev), **{
            f: getattr(frame, f).to(dev) for f in ("uv", "u_right", "depth")})
        reloc = relocalization.Relocalizer(cfg, _to(voc, dev))
        before = match_kernel.LAUNCHES
        with kernel_timing.capture_calls(matcher, "masked_best_two") as calls:
            if dev == "cpu":
                pnp.draw_samples = recording
                try:
                    res = reloc.relocalize(
                        m, st.db, st.kf_node, frame,
                        generator=torch.Generator().manual_seed(0))
                finally:
                    pnp.draw_samples = draw
            else:
                res = reloc.relocalize(
                    _to(m, dev), _to(st.db, dev), st.kf_node.to(dev), frame,
                    sample_idx=drawn[0].to(dev))
        assert len(calls) == relocalization.LAUNCHES
        assert match_kernel.LAUNCHES - before == (
            relocalization.LAUNCHES if dev == "cuda" else 0)
        if dev == "cuda":
            assert calls[0][0].shape[0] == cfg.map.max_mps
            got = match_kernel.masked_best_two_cuda(*calls[0])
            want = match_kernel.masked_best_two_reference(*calls[0])
            assert assert_equal(got, want, "relocalization widening") == 0
        ok, q, t, kp_mp, n_inl, c = res
        out[dev] = (bool(ok), int(c), int(n_inl),
                    se3.camera_center(q, t).cpu().numpy())
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu[0] == cpu[0] is True and gpu[1] == cpu[1]
    assert abs(gpu[2] - cpu[2]) <= 2
    np.testing.assert_allclose(gpu[3], cpu[3], atol=1e-3)


def stereo_cfg():
    """``tests/test_stereo_tracking.py``'s configuration."""
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=26.0, th_depth=50.0)
    return SlamConfig(
        sensor=SENSOR_STEREO, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640),
        tracking=TrackingConfig(min_init_stereo_kps=150))


def test_cuda_stereo_frame_matches_cpu(cuda):
    """One stereo frame on the card against the CPU, by overlap: >= 95% of
    the keypoints at the same pixel, and on those the matched set the same
    and the depth within 1e-3 m on >= 95%."""
    from orb_slam_2_ros_tpu_torch.frontend import frame as frame_mod

    cfg = stereo_cfg()
    gl, gr = SyntheticStereo(cfg, n_frames=1, seed=0)[0]
    f = {dev: frame_mod.build_stereo(torch.from_numpy(gl).to(dev),
                                     torch.from_numpy(gr).to(dev), cfg)
         for dev in ("cpu", "cuda")}
    xy = {k: v.kps.xy.cpu().numpy()[v.valid.cpu().numpy()]
          for k, v in f.items()}
    dep = {k: v.depth.cpu().numpy()[v.valid.cpu().numpy()]
           for k, v in f.items()}
    index = {tuple(p): i for i, p in enumerate(xy["cuda"])}
    pairs = [(i, index[tuple(p)]) for i, p in enumerate(xy["cpu"])
             if tuple(p) in index]
    assert len(pairs) >= 0.95 * len(xy["cpu"])
    a, b = np.array(pairs).T
    dc, dg = dep["cpu"][a], dep["cuda"][b]
    assert (dc > 0).sum() > 150
    assert ((dc > 0) == (dg > 0)).mean() >= 0.95
    assert (np.abs(dc - dg) <= 1e-3).mean() >= 0.95


def test_cuda_stereo_tracker_matches_cpu(cuda):
    """16 stereo frames of tracking on the card against the CPU: the same
    states, every frame OK, camera centres within 5 mm, the kernel launched
    4 times a frame."""
    cfg = stereo_cfg()
    n = 16
    ds = SyntheticStereo(cfg, n_frames=n, seed=0)
    lefts = np.stack([ds[i][0] for i in range(n)])
    rights = np.stack([ds[i][1] for i in range(n)])
    recs = {}
    for dev in ("cpu", "cuda"):
        before = match_kernel.LAUNCHES
        recs[dev] = Tracker(cfg, device=dev).process_chunk(lefts, rights,
                                                           ds.timestamps)
        assert match_kernel.LAUNCHES - before == (0 if dev == "cpu"
                                                  else 4 * n)
    cpu, gpu = recs["cpu"], recs["cuda"]
    assert [r.state for r in gpu] == [r.state for r in cpu] == [OK] * n
    np.testing.assert_allclose(np.stack([r.c_w for r in gpu]),
                               np.stack([r.c_w for r in cpu]), atol=5e-3)


def mono_cfg():
    """``tests/test_mono_tracking.py``'s configuration."""
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    return SlamConfig(
        sensor=0, camera=cam,
        orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
        map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640),
        tracking=TrackingConfig(min_init_mono_matches=60))


def test_cuda_mono_system_matches_cpu(cuda):
    """Mono ``System`` over 16 frames of the arc of
    ``tests/test_mono_tracking.py`` on the card against the CPU: the same
    first OK frame, every later frame OK on both, the same keyframe count,
    the point counts within 5%, the Sim3-aligned ATE of both below 0.05 m;
    on the card the kernel launched 4 times per tracked frame plus 8 times
    per mapping step, and equal to its plain version on every call."""
    from orb_slam_2_ros_tpu_torch.io import ate_rmse
    cfg = mono_cfg()
    n = 16
    ds = SyntheticRGBD(cfg, n_frames=24, seed=0, radius=1.5, angle_range=0.9)
    grays = np.stack([ds[i][0] for i in range(n)])
    out = {}
    for dev in ("cpu", "cuda"):
        system = System(cfg, ba_window=8, enable_loop_closing=False,
                        device=dev)
        tracked = [0]
        process_chunk = system.tracker.process_chunk

        def counted(g, *args, **kwargs):
            tracked[0] += len(g)
            return process_chunk(g, *args, **kwargs)

        system.tracker.process_chunk = counted
        before = match_kernel.LAUNCHES
        with kernel_timing.capture_calls(matcher, "masked_best_two") as calls:
            recs = system.track_chunk(grays, None, ds.timestamps[:n])
        launched = match_kernel.LAUNCHES - before
        states = [r.state for r in recs]
        ok = [r for r in recs if r.state == OK]
        ate = ate_rmse(np.stack([r.c_w for r in ok]),
                       np.stack([ds.gt_pose_wc(r.frame_id)[1] for r in ok]),
                       with_scale=True)
        out[dev] = (states, system.tracker.n_kfs,
                    int(system.tracker.map.mp_valid.sum()), ate)
        if dev == "cuda":
            assert launched == (4 * tracked[0]
                                + 8 * system.mapper.n_executed) > 0
            for args in calls:
                assert_equal(match_kernel.masked_best_two_cuda(*args),
                             match_kernel.masked_best_two_reference(*args),
                             "a mono call")
    (cs, ck, cp, ca), (gs, gk, gp, ga) = out["cpu"], out["cuda"]
    first = cs.index(OK)
    assert gs.index(OK) == first
    assert all(s == OK for s in gs[first:]) and all(s == OK
                                                    for s in cs[first:])
    assert gk == ck and abs(gp - cp) <= 0.05 * cp
    assert ga < 0.05 and ca < 0.05


def test_cuda_vo_frame_matches_cpu(cuda):
    """One localization-only frame on the card against the CPU from the
    same carry (a map of the view straight ahead, the camera yawed 1.2 rad
    so that the map is out of view and the frame rides the temporal VO
    points): the same state, inliers within 2, the pose within 1e-3; on
    the card 6 launches (the VO search and its widened retry among them),
    each equal to its plain version."""
    from orb_slam_2_ros_tpu_torch.io.synthetic import make_room, render
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5, bf=20.0, th_depth=50.0)
    cfg = SlamConfig(sensor=SENSOR_RGBD, camera=cam,
                     orb=OrbConfig(n_features=500, n_levels=3, max_kps=640),
                     map=MapConfig(max_kfs=16, max_mps=4096, max_kps=640),
                     tracking=TrackingConfig(min_init_stereo_kps=200))
    loc = cfg.replace(localization_only=True)
    planes = make_room(0)

    def view(yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return render(planes, R, np.zeros(3, np.float32), cam)

    g0, d0 = view(0.0)
    yaws = np.linspace(0.0, 1.2, 26)
    frames = [view(y) for y in yaws]
    base = Tracker(cfg, device="cpu")
    base.process(g0, d0, 0.0)
    tracker = Tracker(loc, device="cpu")
    tracker.attach_map(base.map)
    tracker.process_chunk(np.stack([f[0] for f in frames[:-1]]),
                          np.stack([f[1] for f in frames[:-1]]),
                          list(range(len(frames) - 1)))
    carry = tracker.carry
    recs = {}
    for dev in ("cpu", "cuda"):
        t = Tracker(loc, device=dev)
        t.carry = type(carry)(*[
            x._replace(**{f: v.to(dev) for f, v in x._asdict().items()})
            if hasattr(x, "_asdict") else x.to(dev) for x in carry])
        before = match_kernel.LAUNCHES
        with kernel_timing.capture_calls(matcher, "masked_best_two") as calls:
            recs[dev] = t.process(*frames[-1], 0.0)
        if dev == "cuda":
            assert match_kernel.LAUNCHES - before == 6
            for args in calls:
                assert_equal(match_kernel.masked_best_two_cuda(*args),
                             match_kernel.masked_best_two_reference(*args),
                             "a VO frame's call")
            assert bool(t.carry.last_vo.any())
    cpu, gpu = recs["cpu"], recs["cuda"]
    assert gpu.state == cpu.state == OK
    assert abs(gpu.n_inliers - cpu.n_inliers) <= 2
    np.testing.assert_allclose(gpu.c_w, cpu.c_w, atol=1e-3)


def test_cuda_world_of_one_on_nccl(cuda):
    """A world of 1 on NCCL: ``distributed_bundle_adjustment`` equals
    ``bundle_adjustment`` on the card, within 1e-5."""
    import torch.distributed as dist
    from orb_slam_2_ros_tpu_torch.geometry import camera, se3
    from orb_slam_2_ros_tpu_torch.parallel import dist_ba, multihost
    from orb_slam_2_ros_tpu_torch.solvers import ba

    made = not dist.is_initialized()
    m = multihost.global_mesh()
    try:
        assert dist.get_backend() == "nccl" and m.device.type == "cuda"
        cfg = SlamConfig()
        rng = np.random.default_rng(0)
        n_cams, n_pts = 4, 64
        pw = torch.from_numpy(np.stack([
            rng.uniform(-2, 2, n_pts), rng.uniform(-1, 1, n_pts),
            rng.uniform(3, 7, n_pts)], -1).astype(np.float32)).to(cuda)
        xi = torch.tensor([[0.2 * i, 0.0, 0.0, 0.0, 0.01 * i, 0.0]
                           for i in range(n_cams)], device=cuda)
        q, t = se3.exp(xi)
        ci = torch.arange(n_cams, device=cuda).repeat_interleave(n_pts)
        mi = torch.arange(n_pts, device=cuda).repeat(n_cams)
        obs = camera.project_stereo(cfg.camera, se3.apply(q[ci], t[ci],
                                                          pw[mi]))
        E = n_cams * n_pts
        prob = ba.BAProblem(cam_idx=ci, mp_idx=mi, obs=obs,
                            is_stereo=torch.ones(E, dtype=torch.bool,
                                                 device=cuda),
                            inv_sigma2=torch.ones(E, device=cuda),
                            valid=torch.ones(E, dtype=torch.bool,
                                             device=cuda))
        dq, dt = se3.exp(torch.tensor([0.02, -0.01, 0.01, 0.005, -0.01,
                                       0.004], device=cuda))
        q1, t1 = se3.compose(dq, dt, q[1], t[1])
        q_p, t_p = q.clone(), t.clone()
        q_p[1], t_p[1] = q1, t1
        cam_free = torch.zeros(n_cams, dtype=torch.bool, device=cuda)
        cam_free[1] = True
        free = torch.ones(n_pts, dtype=torch.bool, device=cuda)
        want = ba.bundle_adjustment(q_p, t_p, cam_free, pw, free, prob, cfg,
                                    phases=(3, 3), cg_iters=10)
        got = dist_ba.distributed_bundle_adjustment(
            m, q_p, t_p, cam_free, pw, free, prob, cfg, phases=(3, 3),
            cg_iters=10)
        for g, w in zip(got[:3], want[:3]):
            assert g.is_cuda
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
        assert torch.equal(got[3], want[3])
    finally:
        if made:
            multihost.shutdown()
