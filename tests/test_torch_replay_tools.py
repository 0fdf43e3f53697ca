"""The tools that start one package from the other's state, on a small
reference pass dumped chunk by chunk: the first 32 frames of the hard pass
at ``tests/test_torch_tracking.py``'s size (320x240), loop closing on, one
vocabulary file for both, through ``tools/reference_passes.py``'s
``_full_system_pass`` with ``--dump``.

- ``tools/reference_passes.py replay`` from the reference's own state at
  chunk 1 gives the chunk log the pass gave, field for field, and the same
  keyframes: the dump and its restore lose nothing the chunk reads.
- ``tools/hard_divergence.py chunk N`` from the reference's state at chunk
  0 (the tracker not yet started, the map empty) and at chunk 1 (OK, two
  keyframes) gives the reference's keyframes, their source frames, the
  verdict dispatched and every frame OK: the tracker's state is the
  dump's, not forced.
- ``chunk 0 --state-out`` writes the port's state in the dump's layout;
  ``replay --state`` starts the reference from it. The map it restores is
  the port's exactly, and chunk 1 from there inserts the keyframes the
  reference's own run inserted.

Every check is exact.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu.config import VocabConfig
from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.pipeline.tracking import OK
from orb_slam_2_ros_tpu.place import vocabulary as jvoc

from test_torch_tracking import small_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rp, hd = _tool("reference_passes"), _tool("hard_divergence")


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """(dump dir, vocabulary file, the reference pass's output)."""
    d = tmp_path_factory.mktemp("dump")
    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    train = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8),
                                              dtype=np.uint32)
    voc_path = str(d / "voc.npz")
    jvoc.save_npz(jvoc.train_vocabulary(train, cfg, seed=0), voc_path)
    ds = SyntheticRGBD(cfg, n_frames=288, seed=0, trajectory="twoloop",
                       exposure_drift=0.25)
    out = rp._full_system_pass("hard", cfg, ds, N, jvoc.load_npz(voc_path),
                               dump=str(d))
    assert out["ok"] == N
    return str(d), voc_path, out


def _state(d, name):
    return rp._read(os.path.join(d, f"{name}.pkl.gz"))


def _kf_frames(state, k0=0):
    m = state["carry"]["m"]
    return m["kf_frame_id"][k0:int(m["n_kfs"])].tolist()


def test_dump_holds_the_tracker_state_and_configuration(dump):
    d, _, _ = dump
    assert _state(d, "chunk_00")["tracker_state"] == 0   # NO_IMAGES_YET
    assert _state(d, "chunk_01")["tracker_state"] == OK
    cfg = rp._config_from_dict(_state(d, "config"))
    assert cfg == dataclasses.replace(small_cfg(),
                                      vocab=VocabConfig(k=6, levels=3))


def test_reference_replays_its_own_dump_exactly(dump):
    d, voc, out = dump
    r = rp.replay("1", d, voc)
    assert r["chunks"] == [dict(out["chunks"][1], ok=16),
                           dict(out["chunks"][2], ok=16)]
    k0 = int(_state(d, "chunk_01")["carry"]["m"]["n_kfs"])
    assert r["new_keyframe_frames"] == _kf_frames(_state(d, "flush"), k0)
    assert [s for _, s, _, _ in r["records"]] == [OK] * 16


@pytest.mark.parametrize("n", [0, 1])
def test_port_replays_a_reference_chunk(dump, n):
    d, voc, out = dump
    r = hd.chunk(str(n), d, voc)
    ref = r["reference_after"]
    print(r["port_logs"], ref)
    assert r["port_new_keyframe_frames"] == ref["new_keyframe_frames"]
    assert ref["new_keyframe_frames"] == _kf_frames(
        _state(d, "chunk_01" if n == 0 else "flush"),
        int(_state(d, f"chunk_{n:02d}")["carry"]["m"]["n_kfs"]))
    if n == 0:
        assert ref["new_keyframe_frames"][0] == 0    # the initialization
    log = r["port_logs"][0]
    assert log["dispatched"] == out["chunks"][n]["dispatched"]
    assert log["ok"] == 16
    assert [rec[1] for rec in r["records"]] == [OK] * 16


def test_reference_replays_from_the_port_state(dump, tmp_path):
    d, voc, out = dump
    path = str(tmp_path / "port_chunk_01.pkl.gz")
    r = hd.chunk("0", d, voc, state_out=path)
    port = rp._read(path)
    assert port["tracker_state"] == OK and port["n_records"] == 16
    assert _kf_frames(port) == r["port_new_keyframe_frames"]

    from orb_slam_2_ros_tpu.pipeline.slam import System
    system = System(rp._config_from_dict(_state(d, "config")),
                    vocab=jvoc.load_npz(voc))
    rp._restore_state(system, port)
    m = system.tracker.carry.m
    for k, v in port["carry"]["m"].items():
        np.testing.assert_array_equal(np.asarray(getattr(m, k)), v, err_msg=k)

    back = rp.replay("1", d, voc, path)
    assert back["chunks"][0]["ok"] == 16
    assert back["new_keyframe_frames"] == _kf_frames(
        _state(d, "flush"), int(port["carry"]["m"]["n_kfs"]))
