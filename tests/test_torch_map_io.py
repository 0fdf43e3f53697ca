"""Map save/load between the two packages (Slice 7a), on the small RGB-D
configuration of ``tests/test_slam_system.py``.

Both systems run loop closing (the default) over the first 16 frames of
the 24-frame orbit and save their maps. The npz layout is the reference's:
the ``MapState`` fields by name (descriptor words as uint32), the
vocabulary (``vocab__node_desc``, ``vocab__word_weight``, ``vocab__klu``)
and the loop closer (``loop__*``; the port keeps ``n_ingested`` on the
host and writes it as ``loop__n_ingested``).

- Both packages write the same keys, and their ``MapState`` has the same
  fields (so no field is dropped on either side).
- A map saved by the reference loads in the port: every map field, the
  vocabulary and the loop closer's state (its index count included) equal
  to the file; the port saves it again into a file equal to the first,
  array by array (the round trip).
- A map saved by the port loads in the reference, the same way.
- Relocalization against a loaded map (``tests/test_slam_system.py::
  test_map_persistence_with_vocab_and_loop_state``): localization-only
  mode on the reference's map, frames 8-15 in chunks of 4 from the map's
  origin: at least 2 OK frames in the second chunk and the last one
  within 0.08 m of the ground truth, the map unchanged; then a
  relocalization of frame 15 against the loaded map and its loaded BoW
  index (nothing re-ingested) succeeds, the pose within 0.08 m of the
  ground truth; the same on both sides.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.map import state as jmap
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.map import state as tmap
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_tracking_e2e import small_cfg

torch.set_num_threads(2)

N_MAP = 16


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = small_cfg()
    ds = SyntheticRGBD(cfg, n_frames=24, seed=0)
    grays = np.stack([ds[i][0] for i in range(len(ds))])
    depths = np.stack([ds[i][1] for i in range(len(ds))])
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    d = tmp_path_factory.mktemp("maps")
    js = jslam.System(cfg, enable_local_ba=True, ba_window=8)
    js.track_chunk(grays[:N_MAP], depths[:N_MAP], ds.timestamps[:N_MAP])
    ts = tslam.System(tcfg, enable_local_ba=True, ba_window=8, device="cpu")
    ts.track_chunk(grays[:N_MAP], depths[:N_MAP], ds.timestamps[:N_MAP])
    paths = dict(ref=str(d / "ref.npz"), port=str(d / "port.npz"))
    assert js.save_map(paths["ref"]) and ts.save_map(paths["port"])
    return dict(cfg=cfg, tcfg=tcfg, ds=ds, grays=grays, depths=depths,
                dir=d, **paths)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _loc(cfg):
    return dataclasses.replace(cfg, localization_only=True)


def _port_saved_arrays(system):
    """What the port's loaded system holds, under the file's keys."""
    out = {f: v for f, v in convert.to_numpy(system.tracker.map).items()}
    v = system.vocab
    out["vocab__node_desc"] = v.node_desc.numpy().view(np.uint32)
    out["vocab__word_weight"] = v.word_weight.numpy()
    out["vocab__klu"] = np.array([v.k, v.levels, v.levels_up], np.int32)
    st = convert.to_numpy(system.loop_closer.state)
    for f, a in st.items():
        if f == "db":
            out.update({"loop__db_" + g: b for g, b in a.items()})
        else:
            out["loop__" + f] = a
    out["loop__n_ingested"] = np.array(system.loop_closer._n_ingested)
    return out


def _reference_held_arrays(system):
    out = {f: np.asarray(v) for f, v in
           jax.device_get(system.tracker.map._asdict()).items()}
    v = system.vocab
    out["vocab__node_desc"] = np.asarray(v.node_desc)
    out["vocab__word_weight"] = np.asarray(v.word_weight)
    out["vocab__klu"] = np.array([v.k, v.levels, v.levels_up], np.int32)
    st = jax.device_get(system.loop_closer.state._asdict())
    for f, a in st.items():
        if f == "db":
            out.update({"loop__db_" + g: np.asarray(b)
                        for g, b in a._asdict().items()})
        else:
            out["loop__" + f] = np.asarray(a)
    return out


def _assert_same(arrays, want, what):
    assert set(arrays) == set(want), (what, set(arrays) ^ set(want))
    for k in want:
        a, b = np.asarray(arrays[k]), np.asarray(want[k])
        assert a.shape == b.shape, (what, k)
        if a.dtype == np.uint32 or b.dtype == np.uint32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def test_both_packages_write_the_same_keys(saved):
    assert tmap.MapState._fields == jmap.MapState._fields
    ref, port = _npz(saved["ref"]), _npz(saved["port"])
    assert set(ref) == set(port)
    assert set(tmap.MapState._fields) <= set(port)
    for k in ("vocab__node_desc", "mp_desc", "kf_desc"):
        assert ref[k].dtype == port[k].dtype == np.uint32, k
    assert int(port["loop__n_ingested"]) == int(port["n_kfs"]) >= 2


def test_reference_map_loads_in_the_port(saved):
    want = _npz(saved["ref"])
    system = tslam.System(saved["tcfg"], enable_local_ba=False,
                          load_map=saved["ref"], device="cpu")
    _assert_same(_port_saved_arrays(system), want, "port holds ref map")
    assert system.tracker.carry.initialized and system.relocalizer
    again = str(saved["dir"] / "ref_through_port.npz")
    system.save_map(again)
    _assert_same(_npz(again), want, "ref map saved again by the port")


def test_port_map_loads_in_the_reference(saved):
    want = _npz(saved["port"])
    system = jslam.System(saved["cfg"], enable_local_ba=False,
                          load_map=saved["port"])
    _assert_same(_reference_held_arrays(system), want, "ref holds port map")
    again = str(saved["dir"] / "port_through_ref.npz")
    system.save_map(again)
    _assert_same(_npz(again), want, "port map saved again by the ref")


def _relocalize_from_origin(system, saved):
    ds, grays, depths = saved["ds"], saved["grays"], saved["depths"]
    recs = []
    for s in (8, 12):
        recs += system.track_chunk(grays[s:s + 4], depths[s:s + 4],
                                   list(ds.timestamps[s:s + 4]))
    ok = [r for r in recs[4:] if r.state == ttrack.OK]
    assert len(ok) >= 2, [r.state for r in recs]
    R0, c0 = ds.gt_pose_wc(0)
    r = ok[-1]
    gt_c = R0.T @ (ds.gt_pose_wc(12 + r.frame_id - recs[4].frame_id)[1] - c0)
    assert np.linalg.norm(r.c_w - gt_c) < 0.08
    return [r.state for r in recs]


def _centre_error(system, ds, i):
    """Distance of the tracker's current camera centre from frame i's
    ground truth in the map's frame (anchored at frame 0)."""
    q = np.asarray(system.tracker.carry.q, np.float64)
    t = np.asarray(system.tracker.carry.t, np.float64)
    w, x, y, z = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]])
    R0, c0 = ds.gt_pose_wc(0)
    return np.linalg.norm(-R.T @ t - R0.T @ (ds.gt_pose_wc(i)[1] - c0))


def test_port_relocalizes_against_a_loaded_map(saved):
    ds = saved["ds"]
    port = tslam.System(_loc(saved["tcfg"]), enable_local_ba=False,
                        load_map=saved["ref"], device="cpu")
    n_mps = int(port.tracker.map.n_mps)
    n_ingested = port.loop_closer._n_ingested
    got = _relocalize_from_origin(port, saved)
    assert int(port.tracker.map.n_mps) == n_mps       # the map stayed frozen
    # an explicit relocalization of the last frame against the loaded map
    # and its loaded BoW index (nothing is re-ingested)
    assert port.relocalize()
    assert port.n_relocalized == 1
    assert port.loop_closer._n_ingested == n_ingested
    assert _centre_error(port, ds, 15) < 0.08
    ref = jslam.System(_loc(saved["cfg"]), enable_local_ba=False,
                       load_map=saved["ref"])
    want = _relocalize_from_origin(ref, saved)
    assert ref.relocalize()
    assert _centre_error(ref, ds, 15) < 0.08
    print("states: reference", want, "port", got)
