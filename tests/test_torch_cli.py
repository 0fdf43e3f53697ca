"""The port's user-facing surface of Slice 7b against the reference: the
trajectory savers, ``map_points``, the debug image, wire-format input and
the CLI runner.

- Savers: the reference's ``System`` runs 16 frames (two of them blank, so
  LOST records exist); its tracking carry and records are carried into the
  port's ``System`` with ``convert``; the TUM, keyframe-TUM and KITTI files
  of the two are equal byte for byte, and ``map_points`` equal.
- Debug image: every pixel above the 20-row status bar equals the
  reference's ``draw_frame`` (OpenCV) on the same inputs, for map points,
  VO points, match lines and keypoints at the border; ``status_text`` is
  the reference's string. ``System.render_debug_image`` draws what the
  reference's drawer draws from the port's own state.
- Wire input: ``tests/test_wire_path.py``'s check on the port: a TUM
  directory through the indexed float path and through the native
  prefetcher's u8/u16 path gives bit-identical records.
- ``run.main(["--device", "cpu", ...])`` on a small synthetic sequence
  writes what it is asked to; without ``--device`` it means the card.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from orb_slam_2_ros_tpu.config import VocabConfig
from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.pipeline import frame_drawer as jdraw
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu_torch import convert, presets, run
from orb_slam_2_ros_tpu_torch.io import datasets as tds
from orb_slam_2_ros_tpu_torch.io.trajectory import read_tum
from orb_slam_2_ros_tpu_torch.pipeline import frame_drawer as tdraw
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_torch_loop_closing import _np
from test_torch_tracking import small_cfg

torch.set_num_threads(2)

N = 16
BLANK = (12, 13)


@pytest.fixture(scope="module")
def carried():
    """The reference's System over 16 frames (frames 12 and 13 blank), and
    the port's System holding the same carry and records."""
    cfg = small_cfg()
    ds = SyntheticRGBD(cfg, n_frames=N, seed=0)
    g = np.stack([ds[i][0] for i in range(N)])
    d = np.stack([ds[i][1] for i in range(N)])
    g[list(BLANK)] = 0.0
    jsys = jslam.System(cfg, enable_loop_closing=False)
    jsys.track_chunk(g, d, list(ds.timestamps))
    jsys.flush()
    states = [r.state for r in jsys.records]
    assert states.count(ttrack.LOST) >= 1 and states.count(ttrack.OK) >= 12
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tsys = tslam.System(tcfg, enable_loop_closing=False, device="cpu")
    tsys.tracker.carry = convert.track_carry_from_numpy(
        _np(jsys.tracker.carry), "cpu")
    tsys.tracker.records = [ttrack.FrameRecord(**dataclasses.asdict(r))
                            for r in jsys.records]
    tsys.tracker.state = jsys.tracker.state
    return dict(cfg=cfg, tcfg=tcfg, jsys=jsys, tsys=tsys, ds=ds, g=g, d=d)


@pytest.mark.parametrize("saver", ["save_trajectory_tum",
                                   "save_keyframe_trajectory_tum",
                                   "save_trajectory_kitti"])
def test_savers_equal_the_references_byte_for_byte(carried, tmp_path, saver):
    a, b = str(tmp_path / "ref.txt"), str(tmp_path / "port.txt")
    getattr(carried["jsys"], saver)(a)
    getattr(carried["tsys"], saver)(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    lines = open(b).read().splitlines()
    n_ok = sum(r.state == ttrack.OK for r in carried["tsys"].records)
    if saver == "save_trajectory_tum":
        assert len(lines) == n_ok          # LOST frames skipped
    elif saver == "save_trajectory_kitti":
        assert len(lines) > n_ok           # every frame with a keyframe


def test_composed_trajectory_keeps_lost_frames_on_request(carried):
    tr = carried["tsys"].tracker
    kept, ts_kept = tr.composed_trajectory(skip_lost=False)
    ok, ts_ok = tr.composed_trajectory()
    assert set(ts_ok) < set(ts_kept)
    lost_ts = [r.timestamp for r in tr.records if r.state != ttrack.OK
               and r.ref_kf is not None and r.ref_kf >= 0]
    assert sorted(set(ts_kept) - set(ts_ok)) == sorted(lost_ts)


@pytest.mark.parametrize("min_obs", [0, 2, 4])
def test_map_points_equal_the_references(carried, min_obs):
    np.testing.assert_array_equal(carried["tsys"].map_points(min_obs),
                                  carried["jsys"].map_points(min_obs))


def test_read_tum_gives_back_the_composed_trajectory(carried, tmp_path):
    p = str(tmp_path / "t.txt")
    carried["tsys"].save_trajectory_tum(p)
    ts, poses = read_tum(p)
    want, want_ts = carried["tsys"].tracker.composed_trajectory()
    np.testing.assert_allclose(ts, want_ts, atol=1e-6)
    for (R, c), (Rw, cw) in zip(poses, want):
        np.testing.assert_allclose(c, cw, atol=1e-6)
        np.testing.assert_allclose(R, Rw, atol=1e-6)


def _drawer_inputs(seed, H=120, W=160, P=40):
    rng = np.random.default_rng(seed)
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    xy = np.stack([rng.uniform(-3, W + 3, P), rng.uniform(-3, H + 3, P)],
                  -1).astype(np.float32)
    valid = rng.uniform(size=P) < 0.9
    has_map = rng.uniform(size=P) < 0.5
    has_vo = rng.uniform(size=P) < 0.4
    ref_xy = np.stack([rng.uniform(0, W - 1, P), rng.uniform(0, H - 1, P)],
                      -1).astype(np.float32)
    matches = np.where(rng.uniform(size=P) < 0.6,
                       rng.integers(0, P, P), -1).astype(np.int32)
    return gray, xy, valid, has_map, has_vo, ref_xy, matches


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["map", "vo", "init"])
def test_draw_frame_equals_opencv_above_the_bar(seed, mode):
    gray, xy, valid, has_map, has_vo, ref_xy, matches = _drawer_inputs(seed)
    kw = dict(state=2 if mode != "init" else 1, n_matches=7, n_kfs=3,
              n_mps=99, localization_only=mode == "vo")
    if mode == "vo":
        kw["kp_has_vo"] = has_vo
    if mode == "init":
        kw.update(init_ref_xy=ref_xy, init_matches=matches)
    want = jdraw.draw_frame(gray, xy, valid, has_map, **kw)
    got = tdraw.draw_frame(gray, xy, valid, has_map, **kw)
    H = gray.shape[0]
    assert got.shape == want.shape == (H + 20, gray.shape[1], 3)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got[:H], want[:H])
    assert (got[H:] > 0).any()      # the status text is drawn


@pytest.mark.parametrize("state,loc,text", [
    (2, False, "SLAM MODE | KFs: 3, MPs: 99, Matches: 7"),
    (3, True, "LOST. TRYING TO RELOCALIZE | LOCALIZATION | KFs: 3, MPs: 99, "
              "Matches: 7"),
    (0, False, "WAITING FOR IMAGES | KFs: 3, MPs: 99, Matches: 7"),
    (9, False, "? | KFs: 3, MPs: 99, Matches: 7")])
def test_status_text_is_the_references(state, loc, text):
    assert tdraw.status_text(state, 3, 99, 7, loc) == text


def test_render_debug_image_draws_like_the_reference(carried, monkeypatch):
    tsys = carried["tsys"]
    tsys._last_frame_inputs = (carried["g"][-1], carried["d"][-1])
    seen = {}
    draw = tdraw.draw_frame

    def recording(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return draw(*args, **kwargs)
    monkeypatch.setattr(tdraw, "draw_frame", recording)
    img = tsys.render_debug_image()
    H, W = carried["cfg"].camera.height, carried["cfg"].camera.width
    assert img.shape == (H + 20, W, 3) and img.dtype == np.uint8
    want = jdraw.draw_frame(*seen["args"], **seen["kwargs"])
    np.testing.assert_array_equal(img[:H], want[:H])
    green = (img[:H, :, 1] > 200) & (img[:H, :, 0] < 100)
    assert green.sum() > 50
    kw = seen["kwargs"]
    assert kw["n_kfs"] == int(tsys.tracker.map.n_kfs)
    assert kw["state"] == carried["jsys"].tracker.state


def test_write_png_reads_back(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (30, 40, 3), np.uint8)
    p = str(tmp_path / "x.png")
    tdraw.write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p))[:, :, ::-1], img)


def _write_tum_fixture(root, cfg, n):
    """Synthetic RGB-D frames in the TUM layout (``tests/test_wire_path.py``)."""
    ds = SyntheticRGBD(cfg, n_frames=n, seed=0)
    os.makedirs(f"{root}/rgb")
    os.makedirs(f"{root}/depth")
    with open(f"{root}/rgb.txt", "w") as fr, \
            open(f"{root}/depth.txt", "w") as fd:
        for i in range(n):
            gray, depth = ds[i]
            g8 = np.clip(np.round(gray), 0, 255).astype(np.uint8)
            raw = np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)
            raw[depth <= 0] = 0
            t = ds.timestamps[i]
            Image.fromarray(g8).save(f"{root}/rgb/{t:.6f}.png")
            Image.fromarray(raw).save(f"{root}/depth/{t:.6f}.png")
            fr.write(f"{t:.6f} rgb/{t:.6f}.png\n")
            fd.write(f"{t:.6f} depth/{t:.6f}.png\n")


def test_wire_input_equals_float_input(tmp_path):
    cfg = small_cfg()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    _write_tum_fixture(str(tmp_path), cfg, N)
    tum = tds.TumRGBD(str(tmp_path))
    off = dict(enable_local_ba=False, enable_loop_closing=False, device="cpu")
    sys_f = tslam.System(tcfg, **off)
    recs_f = sys_f.track_chunk(np.stack([tum[i][0] for i in range(N)]),
                               np.stack([tum[i][1] for i in range(N)]),
                               list(tum.timestamps))
    pf = tds.make_prefetcher(tum)
    out = [pf.next() for _ in range(N)]
    pf.close()
    gw, dw = np.stack([o[0] for o in out]), np.stack([o[1] for o in out])
    assert gw.dtype == np.uint8 and dw.dtype == np.uint16
    sys_w = tslam.System(tcfg, **off)
    recs_w = sys_w.track_chunk(gw, dw, list(tum.timestamps))
    assert [r.state for r in recs_f] == [r.state for r in recs_w]
    assert recs_w[-1].state == ttrack.OK
    for rf, rw in zip(recs_f, recs_w):
        np.testing.assert_array_equal(rf.c_w, rw.c_w)
        np.testing.assert_array_equal(rf.R_wc, rw.R_wc)
    # the relocalization frame of a wire chunk is metric, as the float one
    g, aux = sys_w._to_float_frame(gw[3], dw[3])
    np.testing.assert_array_equal(aux.numpy(),
                                  dw[3].astype(np.float32) * np.float32(1e-3))


def test_run_main_on_a_small_synthetic_sequence(tmp_path, monkeypatch,
                                                capsys):
    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    monkeypatch.setitem(presets.PRESETS, "small",
                        lambda sensor=tcfg.sensor: tcfg.replace(sensor=sensor))
    out = {k: str(tmp_path / f"{k}") for k in ("traj", "kf", "img", "map")}
    res = run.main(["--device", "cpu", "--dataset", "synthetic", "--preset",
                    "small", "--frames", "16", "--save-traj", out["traj"],
                    "--save-kf-traj", out["kf"], "--save-debug-image",
                    out["img"], "--save-map", out["map"] + ".npz"])
    text = capsys.readouterr().out
    for line in ("training vocabulary on", "[   0-  16) tracked 16/16",
                 "done: 16 frames", "loops closed: 0", "metrics:",
                 "ATE RMSE vs ground truth:", "trajectory ->",
                 "debug image ->", "map ->"):
        assert line in text, line
    assert res["ok"] == 16 and res["ate_m"] < 0.05
    assert len(open(out["traj"]).read().splitlines()) == 16
    assert len(open(out["kf"]).read().splitlines()) == int(
        res["system"].tracker.map.n_kfs)
    img = np.asarray(Image.open(out["img"]))
    assert img.shape == (240 + 20, 320, 3)
    assert os.path.exists(out["map"] + ".npz")
