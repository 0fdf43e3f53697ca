"""The port's mesh path through the pipeline, over gloo ranks on the CPU.

- ``LoopCloser(mesh=)`` on the drifted ring of
  ``tests/test_loop_closing.py::build_looped_map(small_cfg())`` (its
  keypoints given the right coordinate an RGB-D frame would have from
  their depth, so that the all-free global BA is well posed), over 2 ranks
  (``mp`` = 2: the GBA's points and edges split) against a world of 1:
  keyframe poses and points within 1e-3, the same loops closed and global
  BAs finished and rejected, every rank's map equal to rank 0's bit for
  bit.
- The mesh GBA moves the cameras under ``gba_structure_only=True`` (the
  reference's mesh branch, ``loop_closing.py:950-963``, has no counterpart
  of the dense branch's structure-only switch), where the dense GBA holds
  every camera where it was.
- ``System(cfg, device="cpu", mesh=)`` over 2 ranks (``kf`` = 2: the local
  BA's rows split) for two chunks of a small synthetic sequence: every
  rank's records and map equal to rank 0's bit for bit, and the frame
  states, keyframes, map points and mapping steps equal to a world of 1's,
  camera centres within 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.parallel import mesh
from orb_slam_2_ros_tpu_torch.pipeline import loop_closing as tlc
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.place import vocabulary as tvoc

from test_torch_dist_ba import assert_ranks_equal, run_ranks

torch.set_num_threads(2)

MIN_GAP = 6
N_FRAMES = 32
WINDOW = 8


# --------------------------------------------------------------- rank jobs

def _map_out(m):
    return {f: getattr(m, f).numpy() for f in ("kf_q", "kf_t", "mp_pos",
                                                 "mp_valid", "kf_mp")}


def _job_loop_closer(n_mp, ring, tcfg):
    """The closer on the ring with the GBA on a mesh, for the ring's
    configuration and for ``gba_structure_only=True``; with ``n_mp`` 1 the
    dense GBA's structure-only run too."""
    m0 = convert.map_state_from_numpy(ring["map"], "cpu")
    voc = tvoc.train_vocabulary(ring["descs"], tcfg, seed=0, device="cpu")
    msh = mesh.make_mesh(n_kf=1, n_mp=n_mp, device="cpu")
    cfg_so = tcfg.replace(solver=dataclasses.replace(
        tcfg.solver, gba_structure_only=True))
    runs = [("free", tcfg, msh), ("structure_only", cfg_so, msh)]
    if n_mp == 1:
        runs.append(("dense_structure_only", cfg_so, None))
    out = {}
    for name, cfg, msh_ in runs:
        lc = tlc.LoopCloser(cfg, voc, min_kfs_between_loops=MIN_GAP,
                            background_gba=True, mesh=msh_)
        m = m0
        for _ in range(8):
            m, closed = lc.process(m, defer=False)
            if closed:
                break
        before = _map_out(m)
        m = lc.run_gba_to_completion(m)
        out[name] = {"before": before, "after": _map_out(m),
                     "counts": np.array([lc.n_loops_closed, lc.n_gba_finished,
                                         lc.n_gba_rejected, lc.n_ladders])}
    return out


def _job_system(n_kf, seq, tcfg):
    """``System`` over the sequence in chunks, then ``flush``."""
    rng = np.random.default_rng(0)
    voc = tvoc.train_vocabulary(
        rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32), tcfg, seed=0,
        device="cpu")
    msh = mesh.make_mesh(n_kf=n_kf, n_mp=1, device="cpu")
    system = tslam.System(tcfg, ba_window=WINDOW, vocab=voc, mesh=msh)
    assert system.device.type == "cpu" and system.mapper.mesh is msh
    C = system.tracker.CHUNK
    for w0 in range(0, N_FRAMES, C):
        system.track_chunk(seq["grays"][w0:w0 + C], seq["depths"][w0:w0 + C],
                           seq["ts"][w0:w0 + C])
    system.flush()
    recs = system.records
    return {"map": _map_out(system.tracker.map),
            "states": np.array([r.state for r in recs]),
            "keyframes": np.array([r.is_keyframe for r in recs]),
            "c_w": np.stack([r.c_w for r in recs]),
            "counts": np.array([system.tracker.n_kfs,
                                int(system.tracker.map.n_mps),
                                system.mapper.n_executed,
                                system.loop_closer._n_ingested])}


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def ring():
    import jax
    from test_loop_closing import build_looped_map, small_cfg
    cfg = small_cfg()
    m, gt, descs = build_looped_map(cfg)
    d = jax.device_get(m._asdict())
    depth = np.asarray(d["kf_depth"])
    d["kf_ur"] = np.where(depth > 0, np.asarray(d["kf_uv"])[..., 0]
                          - cfg.camera.bf / np.maximum(depth, 1e-6),
                          -1.0).astype(np.float32)
    return {"map": d, "descs": np.asarray(descs)}, \
        convert.config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def closer_runs(ring, tmp_path_factory):
    data, tcfg = ring
    tmp = tmp_path_factory.mktemp("closer")
    return {n: run_ranks(_job_loop_closer, n, (n, data, tcfg), tmp)
            for n in (1, 2)}


@pytest.fixture(scope="module")
def system_runs(tmp_path_factory):
    from orb_slam_2_ros_tpu_torch.io.synthetic import SyntheticRGBD
    from test_torch_tracking import small_cfg
    from orb_slam_2_ros_tpu.config import VocabConfig
    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    ds = SyntheticRGBD(tcfg, n_frames=N_FRAMES, seed=0)
    seq = {"grays": np.stack([ds[i][0] for i in range(N_FRAMES)]),
           "depths": np.stack([ds[i][1] for i in range(N_FRAMES)]),
           "ts": list(ds.timestamps)}
    tmp = tmp_path_factory.mktemp("system")
    return {n: run_ranks(_job_system, n, (n, seq, tcfg), tmp)
            for n in (1, 2)}


# ------------------------------------------------------------------- tests

def test_loop_closer_on_two_ranks_equals_a_world_of_one(closer_runs):
    one, two = closer_runs[1][0], closer_runs[2][0]
    for name in ("free", "structure_only"):
        a, b = one[name], two[name]
        np.testing.assert_array_equal(b["counts"], a["counts"])
        assert a["counts"][0] == 1 and a["counts"][1] == 1, a["counts"]
        for f in ("kf_q", "kf_t", "mp_pos"):
            np.testing.assert_allclose(b["after"][f], a["after"][f],
                                       atol=1e-3, err_msg=f"{name} {f}")
        np.testing.assert_array_equal(b["after"]["mp_valid"],
                                      a["after"]["mp_valid"])
    assert_ranks_equal(closer_runs[2])


def test_mesh_gba_moves_cameras_under_structure_only(closer_runs):
    one = closer_runs[1][0]
    for name, moves in (("structure_only", True),
                        ("dense_structure_only", False)):
        run = one[name]
        assert run["counts"][1] == 1 and run["counts"][2] == 0, run["counts"]
        moved = np.abs(run["after"]["kf_t"] - run["before"]["kf_t"]).max(-1)
        # the first keyframe holds the gauge on both paths
        assert moved[0] == 0.0
        if moves:
            assert moved.max() > 1e-3, moved
        else:
            np.testing.assert_array_equal(run["after"]["kf_q"],
                                          run["before"]["kf_q"])
            assert moved.max() == 0.0
        assert np.abs(run["after"]["mp_pos"]
                      - run["before"]["mp_pos"]).max() > 1e-4


def test_system_on_two_ranks_equals_a_world_of_one(system_runs):
    one, two = system_runs[1][0], system_runs[2][0]
    np.testing.assert_array_equal(two["states"], one["states"])
    np.testing.assert_array_equal(two["keyframes"], one["keyframes"])
    np.testing.assert_array_equal(two["counts"], one["counts"])
    assert one["counts"][2] >= 2            # mapping steps ran
    np.testing.assert_allclose(two["c_w"], one["c_w"], atol=1e-3)
    assert_ranks_equal(system_runs[2])
