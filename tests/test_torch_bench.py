"""Port parity of ``python -m orb_slam_2_ros_tpu_torch.bench`` against the
JAX package's ``bench.py`` (imported as the reference; its JAX side runs
on the CPU), at the small configuration of ``tests/test_torch_tracking.py``
(320x240, 500 features, 3 levels).

- ``cached_seq``: the frames and the ground truth equal the reference's
  bit for bit (the renderer's own parity test,
  ``tests/test_torch_config_io.py``, holds the frames bit for bit too), a
  second call reads the cache, and two image sizes never share a file.
- ``bench_tracker_only`` on a 48-frame orbit (two warm chunks, one timed):
  the timed OK count equal to the reference's and nonzero, although the
  port's tracker has already fetched its records (its ``flush()`` returns
  nothing); the ATE over all frames within 5 mm of the reference's and
  both below 0.03 m (``tests/test_torch_tracking.py``'s tolerances).
- The full system's warm-up-and-reset protocol (``bench.py:187-200``,
  without the TPU's ``precompile``) with loop closing on, on the 24 frames
  of ``tests/test_torch_system_loop.py`` and one vocabulary handed to both
  packages: equal OK counts, keyframes and map points, the composed ATE
  within 5 mm (``tests/test_torch_system.py``'s tolerance); and in the port
  that run equals a fresh ``System``'s on the same frames, every record,
  map and loop-closing field equal.
- The output line: the keys that ``bench.py`` prints, read from its source
  with ``ast``, in its order; ``vs_baseline`` = value / 30; the JSON is the
  last line on stdout. Without a card, or with a device that is not one,
  ``main`` exits non-zero with a message.

The mono pass is held in ``tests/test_torch_bench_mono.py``.
"""

import ast
import dataclasses
import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch

from orb_slam_2_ros_tpu.config import VocabConfig
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import bench as tbench
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack

from test_torch_tracking import small_cfg

torch.set_num_threads(2)


def _import_reference_bench():
    """The top-level ``bench.py``. Importing it points JAX's compilation
    cache at the bench's own directory; the suite's setting is put back."""
    cache_dir = jax.config.jax_compilation_cache_dir
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    import bench
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    if env is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return bench


rbench = _import_reference_bench()

N_TRACK = 48            # two warm chunks and one timed
N_SYSTEM = 24


def _configs(cfg=None):
    cfg = cfg or small_cfg()
    return cfg, convert.config_from_dict(dataclasses.asdict(cfg))


def _reference_seq(monkeypatch, *args, **kwargs):
    """``bench.cached_seq`` rendering afresh: its cache file (under /tmp,
    named without the image size) is neither read nor written."""
    with monkeypatch.context() as m:
        m.setattr(rbench.os.path, "exists", lambda path: False)
        m.setattr(rbench.np, "savez_compressed", lambda *a, **k: None)
        return rbench.cached_seq(*args, **kwargs)


@pytest.mark.parametrize("trajectory, drift, stereo", [
    ("orbit", 0.0, False), ("orbit", 0.0, True), ("twoloop", 0.25, False)],
    ids=["rgbd_orbit", "stereo_orbit", "twoloop_drift"])
def test_cached_seq_matches_reference(monkeypatch, tmp_path, trajectory,
                                      drift, stereo):
    cfg, tcfg = _configs()
    want = _reference_seq(monkeypatch, cfg, 3, trajectory,
                          exposure_drift=drift, stereo=stereo)
    kw = dict(exposure_drift=drift, stereo=stereo, workers=1,
              cache_dir=str(tmp_path))
    got = tbench.cached_seq(tcfg, 3, trajectory, **kw)
    assert os.path.exists(tbench.cache_path(tcfg, 3, trajectory, drift,
                                            stereo=stereo,
                                            cache_dir=str(tmp_path)))
    again = tbench.cached_seq(tcfg, 3, trajectory, **kw)     # from the file
    for seq in (got, again):
        assert len(seq) == len(want) == 3
        np.testing.assert_array_equal(seq.grays, want.grays)
        np.testing.assert_array_equal(seq.depths, want.depths)
        np.testing.assert_array_equal(seq.timestamps, want.timestamps)
        for i in range(3):
            for a, b in zip(seq.gt_pose_wc(i), want.gt_pose_wc(i)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(seq[i], want[i]):
                np.testing.assert_array_equal(a, b)


def test_cache_key_holds_the_image_size(tmp_path):
    _, tcfg = _configs()
    full = tcfg.replace(camera=dataclasses.replace(tcfg.camera, width=640,
                                                   height=480))
    small = tbench.cache_path(tcfg, 96, "orbit", cache_dir=str(tmp_path))
    large = tbench.cache_path(full, 96, "orbit", cache_dir=str(tmp_path))
    assert small != large
    assert "320x240" in small and "640x480" in large
    assert os.path.basename(small).startswith("slam_bench_torch_")
    assert os.path.basename(large) != "slam_bench_rgbd_orbit_96_0_0.npz"


def test_tracker_only_matches_reference(tmp_path):
    cfg, tcfg = _configs()
    ds = tbench.cached_seq(tcfg, N_TRACK, "orbit", workers=1,
                           cache_dir=str(tmp_path))
    _, jt, jrecs = rbench.bench_tracker_only(cfg, ds, N_TRACK, "reference")
    _, tt, trecs = tbench.bench_tracker_only(tcfg, ds, N_TRACK, "port",
                                             device="cpu")
    # the port fetched every chunk's records as it went
    assert tt.flush() == []
    assert len(trecs) == len(jrecs) == N_TRACK
    warm = tbench.N_WARM_CHUNKS * tt.chunk
    assert warm == 32
    t_ok = sum(r.state == ttrack.OK for r in trecs[warm:])
    j_ok = sum(r.state == ttrack.OK for r in jrecs[warm:])
    assert t_ok == j_ok == N_TRACK - warm
    gt = np.stack([ds.gt_pose_wc(i)[1] for i in range(N_TRACK)])
    ate_t = tbench.ate_rmse(np.stack([r.c_w for r in tt.records]), gt)
    ate_j = tbench.ate_rmse(np.stack([r.c_w for r in jt.records]), gt)
    assert ate_t < 0.03 and ate_j < 0.03
    assert abs(ate_t - ate_j) < 5e-3


@pytest.fixture(scope="module")
def system_seq(tmp_path_factory):
    """The 24 frames of ``tests/test_torch_system_loop.py`` and a 6^3
    vocabulary trained once by the reference and handed to the port."""
    cfg, tcfg = _configs(dataclasses.replace(
        small_cfg(), vocab=VocabConfig(k=6, levels=3)))
    ds = tbench.cached_seq(tcfg, N_SYSTEM, "orbit", workers=1,
                           cache_dir=str(tmp_path_factory.mktemp("seq")))
    rng = np.random.default_rng(0)
    train = rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32)
    jv = jvoc.train_vocabulary(train, cfg, seed=0)
    tv = convert.vocabulary_from_numpy(jax.device_get(jv._asdict()), "cpu")
    return dict(cfg=cfg, tcfg=tcfg, ds=ds, jvoc=jv, tvoc=tv)


@pytest.fixture(scope="module")
def port_full(system_seq):
    return tbench.bench_full_system(system_seq["tcfg"], system_seq["ds"],
                                    system_seq["tvoc"], device="cpu")


def test_full_system_protocol_matches_reference(system_seq, port_full):
    ds = system_seq["ds"]
    js = jslam.System(system_seq["cfg"], vocab=system_seq["jvoc"])
    C = js.tracker.chunk
    chunks = rbench.stage_chunks(js.tracker, ds.grays, ds.depths, C)
    ts = ds.timestamps
    # bench.py:187-200 without the loop closer's precompile
    for i in range(2):
        js.track_chunk(*chunks[i], list(ts[i * C:(i + 1) * C]),
                       defer_fetch=True)
    js.reset()
    js.tracker.flush()
    js.tracker.records.clear()
    js._frame_counter = 0
    for i, (g, d) in enumerate(chunks):
        js.track_chunk(g, d, list(ts[i * C:(i + 1) * C]), defer_fetch=True)
    js.flush()

    out, system = port_full
    j_ok = sum(r.state == ttrack.OK for r in js.records)
    assert out["ok"] == j_ok == N_SYSTEM
    assert len(system.records) == len(js.records) == N_SYSTEM
    assert system.tracker.n_kfs == js.tracker.n_kfs >= 3
    assert int(system.tracker.map.n_mps) == int(js.tracker.carry.m.n_mps)
    assert out["loops"] == js.loop_closer.n_loops_closed == 0
    assert out["gba_finished"] == js.loop_closer.n_gba_finished == 0
    ate_j = tbench.composed_ate(js, ds)
    assert abs(out["ate_m"] - ate_j) < 5e-3
    assert out["ate_m"] < 0.03
    assert system.n_resets == 1
    assert out["fps"] > 0 and out["ladder_chunks"] == []


def test_reset_then_pass_equals_a_fresh_system(system_seq, port_full):
    _, system = port_full
    ds = system_seq["ds"]
    fresh = tbench.System(system_seq["tcfg"], vocab=system_seq["tvoc"],
                          device="cpu")
    for chunk in tbench._wire_chunks(fresh.tracker, ds.grays, ds.depths,
                                     ds.timestamps):
        fresh.track_chunk(*chunk)
    fresh.flush()
    assert len(system.records) == len(fresh.records) == N_SYSTEM
    for a, b in zip(system.records, fresh.records):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, (f.name, a.frame_id)
    m, m0 = system.tracker.map, fresh.tracker.map
    for f in m._fields:
        assert torch.equal(getattr(m, f), getattr(m0, f)), f
    for f in ("initialized", "q", "t", "vel_q", "vel_t", "last_mp",
              "ref_tracked", "since_kf", "frame_id", "since_reloc"):
        assert torch.equal(getattr(system.tracker.carry, f),
                           getattr(fresh.tracker.carry, f)), f
    lc, lc0 = system.loop_closer, fresh.loop_closer
    st, st0 = lc.state._asdict(), lc0.state._asdict()
    for f in st:
        if f == "db":
            for g in st[f]._fields:
                assert torch.equal(getattr(st[f], g), getattr(st0[f], g)), g
        else:
            assert torch.equal(st[f], st0[f]), f
    assert lc._n_ingested == lc0._n_ingested == system.tracker.n_kfs
    assert len(lc._pending_verdict) == len(lc0._pending_verdict) == 0
    assert torch.equal(lc._generator.get_state(), lc0._generator.get_state())
    assert torch.equal(system._reloc_generator.get_state(),
                       fresh._reloc_generator.get_state())
    assert system.mapper._prev_n_kfs == fresh.mapper._prev_n_kfs
    assert tbench.composed_ate(system, ds) == tbench.composed_ate(fresh, ds)


def _reference_keys():
    """The keys of the line that ``bench.py``'s ``main`` prints, from its
    source: the literal keys of the printed dict, then the ``results``
    entries it spreads, in the order ``main`` assigns them."""
    tree = ast.parse(inspect.getsource(rbench))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    assigned = sorted(
        (n.lineno, n.targets[0].slice.value) for n in ast.walk(main)
        if isinstance(n, ast.Assign)
        and isinstance(n.targets[0], ast.Subscript)
        and isinstance(n.targets[0].value, ast.Name)
        and n.targets[0].value.id == "results")
    printed = next(
        n.args[0].args[0] for n in ast.walk(main)
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "print"
        and n.args and isinstance(n.args[0], ast.Call)
        and getattr(n.args[0].func, "attr", None) == "dumps")
    literal = [k.value for k in printed.keys if k is not None]
    spread = [k for _, k in assigned if k != "slam_system_fps_1chip"]
    assert literal == ["metric", "value", "unit", "vs_baseline"]
    return literal + spread


def _results():
    return {"slam_system_fps_1chip": 2.5, "slam_system_ate_m": 0.054,
            "loops_closed": 1, "slam_hard_ate_m": 0.22,
            "hard_loops_closed": 2, "rgbd_tracking_fps_1chip": 3.0,
            "rgbd_tracking_ate_m": 0.0024, "stereo_tracking_fps_1chip": 2.9,
            "stereo_system_fps_1chip": 2.7, "mono_system_fps_1chip": 2.6}


def test_output_line_has_the_reference_keys(monkeypatch, capsys):
    keys = _reference_keys()
    assert len(keys) == 13
    line = tbench.output_line(_results())
    assert list(line) == keys
    assert line["metric"] == "slam_system_fps_1chip"
    assert line["value"] == 2.5 and line["vs_baseline"] == 2.5 / 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbench, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(tbench, "run_passes", lambda device: _results())
    tbench.main([])
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1]
    assert json.loads(last) == line
    assert list(json.loads(last)) == keys
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in out.err


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]],
                         ids=["no_card", "cpu_device"])
def test_main_needs_a_card(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "run_passes", lambda device: pytest.fail(
        "the passes ran without a card"))
    with pytest.raises(SystemExit) as e:
        tbench.main(argv)
    assert e.value.code not in (0, None)
    assert "bench:" in str(e.value.code)
    assert capsys.readouterr().out == ""
