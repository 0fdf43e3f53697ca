"""Port parity of the local-mapping slice as a whole, on the small
configuration of ``tests/test_torch_tracking.py`` and the 24 synthetic frames
of ``tests/test_slam_system.py``.

- One ``LocalMapper.run`` from an identical start: the JAX tracker alone
  builds a map over 40 frames (it takes its third keyframe at frame 32), the
  map crosses over through ``convert.map_state_from_numpy`` and both mappers
  (window 8) run once: same ``n_kfs``, ``n_mps`` and
  ``n_culled``, ``kf_mp`` equal on >= 98% of the entries, the remapped
  ``last_mp`` on >= 98%, keyframe poses within 1e-4.
- The slice: ``System(enable_loop_closing=False, ba_window=8)`` on both
  sides: the same per-frame states, the same keyframe count, map points
  within 3%, camera centres within 5 mm.
- The port's ``System`` alone: the mapper runs exactly on the chunks that
  inserted a keyframe, ``last_mp`` follows the compaction, keyframe-pool
  compaction re-bases the records, ``reset``, and what is not ported raises.
  ``System`` with loop closing on is held in ``tests/test_torch_system_loop.py``.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.pipeline import local_mapping as jlm
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.pipeline import tracking as jtrack
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import local_mapping as tlm
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_torch_tracking import small_cfg

N_FRAMES = 24
N_STEP_FRAMES = 40      # the tracker alone has 3 keyframes by then
WINDOW = 8


@pytest.fixture(scope="module")
def seq():
    cfg = small_cfg()
    ds = SyntheticRGBD(cfg, n_frames=N_FRAMES, seed=0)
    grays = np.stack([ds[i][0] for i in range(N_FRAMES)])
    depths = np.stack([ds[i][1] for i in range(N_FRAMES)])
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return dict(cfg=cfg, tcfg=tcfg, grays=grays, depths=depths,
                ts=list(ds.timestamps))


@pytest.fixture(scope="module")
def port_system(seq):
    """The port's System over the 24 frames, with every call of the mapper
    recorded as (keyframes before the chunk's step, executed or not)."""
    system = tslam.System(seq["tcfg"], ba_window=WINDOW,
                          enable_loop_closing=False, device="cpu")
    steps = []
    run = system.mapper.run

    def recording(m, *args, **kwargs):
        before = system.mapper.n_executed
        out = run(m, *args, **kwargs)
        steps.append((kwargs["n_kfs"], system.mapper.n_executed > before,
                      dict(system.mapper.last_step or {})))
        return out

    system.mapper.run = recording
    recs = system.track_chunk(seq["grays"], seq["depths"], seq["ts"])
    return system, recs, steps


def test_one_mapping_step_from_identical_start(seq):
    cfg = seq["cfg"]
    ds = SyntheticRGBD(cfg, n_frames=N_STEP_FRAMES, seed=0)
    jt = jtrack.Tracker(cfg)
    jt.process_chunk(np.stack([ds[i][0] for i in range(N_STEP_FRAMES)]),
                     np.stack([ds[i][1] for i in range(N_STEP_FRAMES)]),
                     list(ds.timestamps))
    m0 = jax.device_get(jt.carry.m._asdict())
    last0 = np.asarray(jt.carry.last_mp)
    assert int(m0["n_kfs"]) >= 3

    jmap, jculled, jlast = jlm.LocalMapper(cfg, window=WINDOW).run(
        jt.carry.m, jt.carry.last_mp)
    mapper = tlm.LocalMapper(seq["tcfg"], window=WINDOW)
    tmap, tculled, tlast = mapper.run(
        convert.map_state_from_numpy(m0, "cpu"),
        torch.from_numpy(last0.copy()))

    assert int(tmap.n_kfs) == int(jmap.n_kfs)
    assert int(tmap.n_mps) == int(jmap.n_mps) == int(tmap.mp_valid.sum())
    assert int(tculled) == int(jculled) > 0
    agree = (tmap.kf_mp.numpy() == np.asarray(jmap.kf_mp)).mean()
    agree_last = (tlast.numpy() == np.asarray(jlast)).mean()
    print(f"kf_mp agreement {agree:.4f}, last_mp agreement {agree_last:.4f}; "
          f"step {mapper.last_step}")
    assert agree >= 0.98 and agree_last >= 0.98
    np.testing.assert_allclose(tmap.kf_q.numpy(), np.asarray(jmap.kf_q),
                               atol=1e-4)
    np.testing.assert_allclose(tmap.kf_t.numpy(), np.asarray(jmap.kf_t),
                               atol=1e-4)
    np.testing.assert_array_equal(tmap.kf_valid.numpy(),
                                  np.asarray(jmap.kf_valid))
    # the counters keep the dtype the tracker and the conversion expect
    for f in ("n_kfs", "n_mps", "mp_obs_cnt", "mp_visible", "mp_found"):
        assert getattr(tmap, f).dtype == torch.int32, f
    assert mapper.last_ba_free_points == int(mapper.last_step["n_ba_free"]) > 0
    # the same map again: no keyframe arrived, so the step does nothing
    again, culled, _ = mapper.run(tmap, tlast)
    assert again is tmap and int(culled) == 0 and mapper.n_executed == 1
    assert mapper.last_ba_free_points == 0
    _, _, _ = mapper.run(tmap, tlast, force=True)
    assert mapper.n_executed == 2


def test_system_matches_reference(seq, port_system):
    js = jslam.System(seq["cfg"], enable_local_ba=True, ba_window=WINDOW,
                      enable_loop_closing=False)
    jrecs = js.track_chunk(seq["grays"], seq["depths"], seq["ts"])
    system, trecs, _ = port_system
    assert len(trecs) == len(jrecs) == N_FRAMES
    assert [r.state for r in trecs] == [r.state for r in jrecs]
    assert all(r.state == ttrack.OK for r in trecs)
    assert [r.is_keyframe for r in trecs] == [r.is_keyframe for r in jrecs]
    assert system.tracker.n_kfs == js.tracker.n_kfs
    n_t = int(system.tracker.map.mp_valid.sum())
    n_j = int(np.asarray(js.tracker.map.mp_valid).sum())
    jc = np.stack([r.c_w for r in jrecs])
    tc = np.stack([r.c_w for r in trecs])
    print(f"map points {n_t} / {n_j}; max camera-centre difference "
          f"{np.abs(jc - tc).max():.2e} m; culled {system.n_culled_total} / "
          f"{js.n_culled_total}")
    assert abs(n_t - n_j) <= 0.03 * n_j
    np.testing.assert_allclose(tc, jc, atol=5e-3)
    assert abs(system.n_culled_total - js.n_culled_total) \
        <= 0.03 * js.n_culled_total
    # the trajectory composed through the keyframes that the windowed BA
    # has moved since the records were made
    jposes, jts = js.tracker.composed_trajectory()
    tposes, tts = system.tracker.composed_trajectory()
    assert tts == jts and len(tposes) == N_FRAMES
    jcc = np.stack([c for _, c in jposes])
    tcc = np.stack([c for _, c in tposes])
    print(f"composed: max camera-centre difference "
          f"{np.abs(jcc - tcc).max():.2e} m; moved from the records by "
          f"{np.abs(tcc - tc).max():.2e} m")
    np.testing.assert_allclose(tcc, jcc, atol=5e-3)
    assert np.abs(tcc - tc).max() > 0          # the BA did move keyframes


def test_mapper_runs_on_keyframe_chunks_only(seq, port_system):
    system, recs, steps = port_system
    C = system.tracker.CHUNK
    kf_chunks = [any(r.is_keyframe for r in recs[w0:w0 + C])
                 for w0 in range(0, N_FRAMES, C)]
    assert [ran for _, ran, _ in steps] == kf_chunks
    assert system.mapper.n_executed == sum(kf_chunks) >= 2
    assert [n for n, _, _ in steps][-1] == system.tracker.n_kfs
    assert system.n_culled_total == sum(
        int(s["n_culled"]) for _, ran, s in steps if ran) > 0
    for _, ran, s in steps:
        if ran:
            assert all(np.isfinite(end) and end <= start
                       for start, end in s["ba_cost"])
    # pool invariants after the last step: a live count, no dangling id
    m = system.tracker.map
    assert int(m.n_mps) == int(m.mp_valid.sum())
    kf_mp = m.kf_mp.numpy()
    assert m.mp_valid.numpy()[kf_mp[kf_mp >= 0]].all()
    last = system.tracker.carry.last_mp.numpy()
    assert m.mp_valid.numpy()[last[last >= 0]].all()
    assert all(v.device.type == "cpu" for v in m._asdict().values())


def test_last_mp_rides_through_compaction(seq, port_system):
    """Culling a low row of the pool moves every later point down by one;
    the tracker's association vector must name the same points after."""
    system, _, _ = port_system
    m = system.tracker.map
    last = system.tracker.carry.last_mp
    held = last[last >= 0]
    pos_before = m.mp_pos[held.long()]
    victim = int(torch.nonzero(m.mp_valid)[0])
    holes = m._replace(
        mp_valid=m.mp_valid.index_fill(0, torch.tensor([victim]), False),
        kf_mp=torch.where(m.kf_mp == victim, -1, m.kf_mp))
    mapper = tlm.LocalMapper(seq["tcfg"], window=WINDOW)
    m2, _, last2 = mapper.run(holes, last, full=False)
    kept = (held != victim) & (last2[last >= 0] >= 0)
    assert int(kept.sum()) > 50 and int(m2.n_mps) < int(m.n_mps)
    assert (last2[last >= 0][kept] < held[kept]).all()      # ids moved
    light = mapper.last_step
    assert int(light["n_spawned"]) == int(light["n_fused"]) == 0
    # the points are the same ones (the LIGHT step's BA moved them a little)
    moved = (m2.mp_pos[last2[last >= 0][kept].long()] - pos_before[kept])
    assert float(moved.norm(dim=-1).median()) < 0.05
    # with compaction off the ids stay as they are
    _, _, last3 = tlm.LocalMapper(seq["tcfg"], window=WINDOW).run(
        holes, last, allow_compact=False, full=False)
    assert torch.equal(last3, last)


def test_compact_keyframe_pool_rebases_records(seq):
    system = tslam.System(seq["tcfg"], ba_window=WINDOW,
                          enable_loop_closing=False, device="cpu")
    system.track_chunk(seq["grays"], seq["depths"], seq["ts"])
    assert system.compact_keyframe_pool() == 0      # nothing culled yet
    poses0, ts0 = system.tracker.composed_trajectory()
    m = system.tracker.map
    n = int(m.n_kfs)
    assert n >= 3
    cull = torch.zeros_like(m.kf_valid)
    cull[1] = True                                  # a middle keyframe
    system.tracker.carry = system.tracker.carry._replace(m=m._replace(
        kf_valid=m.kf_valid & ~cull,
        kf_mp=torch.where(cull[:, None], -1, m.kf_mp),
        kf_kp_valid=m.kf_kp_valid & ~cull[:, None]))
    assert system.compact_keyframe_pool() == 1
    assert system.n_kf_compactions == 1 and system.tracker.n_kfs == n - 1
    assert system.mapper.has_work(0)                # the gate is re-armed
    assert max(r.ref_kf for r in system.records) == n - 2
    poses1, ts1 = system.tracker.composed_trajectory()
    assert ts1 == ts0
    for (R0, c0), (R1, c1) in zip(poses0, poses1):
        np.testing.assert_allclose(c1, c0, atol=1e-4)
        np.testing.assert_allclose(R1, R0, atol=1e-4)


def test_reset_and_single_frame(seq):
    system = tslam.System(seq["tcfg"], enable_local_ba=False,
                          enable_loop_closing=False, device="cpu")
    assert system.mapper is None
    rec = system.track_rgbd(seq["grays"][0], seq["depths"][0], seq["ts"][0])
    assert rec.state == ttrack.OK and system.tracker.n_kfs == 1
    assert system.n_culled_total == 0 and system.flush() == []
    system.reset()
    assert system.tracker.n_kfs == 0 and system.n_resets == 1
    recs = system.track_chunk(seq["grays"][:4], seq["depths"][:4])
    assert all(r.state == ttrack.OK for r in recs)
    assert len(system.records) == 5


def test_unported_modes_raise(seq, tmp_path):
    """Mono, localization-only and map loading are ported (Slices 6 and
    7a), the trajectory savers and the debug image too (Slice 7b); what
    still raises is Slice 8's ``mesh=``. Before any frame the savers write
    empty files and there is no debug image."""
    cfg = seq["tcfg"]
    off = dict(enable_loop_closing=False, device="cpu")
    system = tslam.System(cfg, **off)
    for saver in (system.save_trajectory_tum,
                  system.save_keyframe_trajectory_tum,
                  system.save_trajectory_kitti):
        path = tmp_path / f"{saver.__name__}.txt"
        saver(str(path))
        assert path.read_text() == ""
    assert system.render_debug_image() is None
    assert system.map_points().shape == (0, 3)
    with pytest.raises(NotImplementedError):
        tslam.System(cfg, mesh=object(), **off)
    # the monocular and stereo sensors and localization-only mode are
    # ported
    mono = cfg.replace(sensor=0)
    assert tslam.System(mono, **off).mono_init is not None
    assert tlm.LocalMapper(mono).cfg.sensor == 0
    stereo = cfg.replace(sensor=1)
    assert tslam.System(stereo, **off).tracker.cfg.sensor == 1
    assert tlm.LocalMapper(stereo).cfg.sensor == 1
    loc = tslam.System(cfg.replace(localization_only=True), **off)
    assert loc.localization_only and loc.relocalizer is None
