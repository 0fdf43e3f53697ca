"""Port parity of ``System`` with loop closing on (its default), on the small
configuration of ``tests/test_torch_tracking.py`` with a 6^3 vocabulary and
the 24 synthetic frames of ``tests/test_torch_system.py``.

Against the reference ``System(cfg, vocab=voc)``: the same per-frame states
and keyframe flags, the same keyframe count, every keyframe ingested, the
BoW database's words equal, no loop on 24 frames, camera centres within
5 mm (that file's tolerance). The vocabulary bootstrap extracts what the
reference's extracts (97% of the rows) and trains the reference's tree bit
for bit from the same descriptors. The port alone: verdicts are consumed one chunk late and
drained by ``flush``, the mapper must not compact while a global BA is in
flight, ``reset`` clears the closer, ``metrics()``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam_2_ros_tpu.config import VocabConfig
from orb_slam_2_ros_tpu.frontend import frame as jframe
from orb_slam_2_ros_tpu.io.synthetic import SyntheticRGBD
from orb_slam_2_ros_tpu.pipeline import slam as jslam
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.frontend import extractor as textractor
from orb_slam_2_ros_tpu_torch.pipeline import slam as tslam
from orb_slam_2_ros_tpu_torch.pipeline import tracking as ttrack
from orb_slam_2_ros_tpu_torch.place import vocabulary as tvoc

from test_torch_tracking import small_cfg

# Several test processes share the machine's cores; PyTorch's default of
# one thread per core in each of them makes the many small operations of
# these tests spin against each other (a 16 s fixture took 540 s in a run
# with six workers). Two threads per process keep them out of each other's way.
torch.set_num_threads(2)

N_FRAMES = 24
WINDOW = 8


@pytest.fixture(scope="module")
def seq():
    cfg = dataclasses.replace(small_cfg(), vocab=VocabConfig(k=6, levels=3))
    ds = SyntheticRGBD(cfg, n_frames=N_FRAMES, seed=0)
    grays = np.stack([ds[i][0] for i in range(N_FRAMES)])
    depths = np.stack([ds[i][1] for i in range(N_FRAMES)])
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    train = rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32)
    return dict(cfg=cfg, tcfg=tcfg, grays=grays, depths=depths,
                ts=list(ds.timestamps),
                jvoc=jvoc.train_vocabulary(train, cfg, seed=0),
                tvoc=tvoc.train_vocabulary(train, tcfg, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def port_system(seq):
    """The port's System, loop closing on, over the 24 frames; every call
    of the closer and the mapper logged in order."""
    system = tslam.System(seq["tcfg"], ba_window=WINDOW, vocab=seq["tvoc"],
                          device="cpu")
    log = []
    lc = system.loop_closer

    def wrap(obj, name, note):
        fn = getattr(obj, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append((name, note(args, kwargs, out)))
            return out
        setattr(obj, name, wrapped)

    wrap(lc, "dispatch", lambda a, k, out: a[1])
    wrap(lc, "consume_host", lambda a, k, out: (a[1], a[2]))
    wrap(lc, "finish_pending", lambda a, k, out: len(lc._pending_verdict))
    wrap(lc, "step_background", lambda a, k, out: out[1])
    wrap(system.mapper, "run", lambda a, k, out: k["allow_compact"])
    recs = system.track_chunk(seq["grays"], seq["depths"], seq["ts"])
    queued = len(lc._pending_verdict)
    system.flush()
    return system, recs, log, queued


def test_system_with_loop_closing_matches_reference(seq, port_system):
    js = jslam.System(seq["cfg"], enable_local_ba=True, ba_window=WINDOW,
                      vocab=seq["jvoc"])
    jrecs = js.track_chunk(seq["grays"], seq["depths"], seq["ts"])
    js.flush()
    system, trecs, _, _ = port_system
    assert [r.state for r in trecs] == [r.state for r in jrecs]
    assert all(r.state == ttrack.OK for r in trecs)
    assert [r.is_keyframe for r in trecs] == [r.is_keyframe for r in jrecs]
    assert system.tracker.n_kfs == js.tracker.n_kfs >= 3
    jl, tl = js.loop_closer, system.loop_closer
    assert tl.n_loops_closed == jl.n_loops_closed == 0
    assert tl.n_ladders == 0 and not tl.gba_running
    assert tl._n_ingested == int(jl.state.n_ingested) == system.tracker.n_kfs
    n = tl._n_ingested
    # the same keyframes gave the same words (up to the few keypoints the
    # two extractors rank differently)
    agree = (tl.state.db.kf_word[:n].numpy()
             == np.asarray(jl.state.db.kf_word)[:n]).mean()
    assert agree > 0.98, agree
    np.testing.assert_array_equal(tl.state.db.kf_valid.numpy(),
                                  np.asarray(jl.state.db.kf_valid))
    jc = np.stack([r.c_w for r in jrecs])
    tc = np.stack([r.c_w for r in trecs])
    np.testing.assert_allclose(tc, jc, atol=5e-3)
    assert all(v.device.type == "cpu"
               for v in tl.state._asdict().values() if torch.is_tensor(v))


def test_verdicts_are_consumed_one_chunk_late(seq, port_system):
    system, _, log, queued = port_system
    names = [n for n, _ in log]
    # two tracker chunks (16 + 8 frames): the first chunk's verdict is
    # consumed in the second chunk, the second's by flush
    per_chunk = ["run", "dispatch", "step_background"]
    assert names == per_chunk + per_chunk + [
        "consume_host",                         # chunk 2 consumes chunk 1's
        "consume_host", "finish_pending"]       # flush consumes chunk 2's
    assert queued == 1
    assert system.loop_closer._pending_verdict == []
    # dispatch was told the keyframe count the chunk's records carry
    kfs = [v for n, v in log if n == "dispatch"]
    assert kfs[-1] == system.tracker.n_kfs and kfs[0] <= kfs[1]
    assert [v for n, v in log if n == "consume_host"][0][0] == -1
    assert all(v is True for n, v in log if n == "run")     # no GBA ran


def test_no_compaction_while_a_gba_is_in_flight(seq):
    system = tslam.System(seq["tcfg"], ba_window=WINDOW, vocab=seq["tvoc"],
                          device="cpu")
    lc = system.loop_closer
    lc.gba = object()                       # a GBA in flight
    lc.step_background = lambda m: (m, False)
    seen = []
    run = system.mapper.run

    def recording(*args, **kwargs):
        seen.append(kwargs["allow_compact"])
        return run(*args, **kwargs)

    system.mapper.run = recording
    compactions = []
    system.compact_keyframe_pool = lambda: compactions.append(1)
    system.KF_COMPACT_WATERMARK = 0.0       # the pool always counts as full
    system.track_chunk(seq["grays"][:4], seq["depths"][:4], seq["ts"][:4])
    assert seen == [False] and not compactions
    lc.gba = None
    system.track_chunk(seq["grays"][4:8], seq["depths"][4:8], seq["ts"][4:8])
    assert seen == [False, True] and compactions == [1]


def test_vocabulary_bootstrap_gives_the_references_tree(seq):
    """The bootstrap extracts from the float gray images as the reference's
    ``build_mono`` does (at least 97% of the descriptor rows are the same
    rows; the two extractors rank a few keypoints differently), and from
    the same descriptors it trains the reference's tree bit for bit."""
    system = tslam.System(seq["tcfg"], ba_window=WINDOW, device="cpu")
    assert system._vocab_pending and system.loop_closer is None
    system.track_chunk(seq["grays"][:8], seq["depths"][:8], seq["ts"][:8])
    assert not system._vocab_pending and system.loop_closer is not None
    assert system.loop_closer._n_ingested == system.tracker.n_kfs
    tdescs, jdescs = [], []
    for i in (0, 2, 4, 6):              # 4 frames sampled across the 8
        gray = np.asarray(seq["grays"][i], np.float32)
        kps = textractor.extract(torch.from_numpy(gray), seq["tcfg"].orb)
        tdescs.append(kps.desc[kps.valid].numpy().view(np.uint32))
        f = jframe.build_mono(jnp.asarray(gray), seq["cfg"])
        jdescs.append(np.asarray(f.kps.desc)[np.asarray(f.valid)])
        same = len(set(map(bytes, tdescs[-1])) & set(map(bytes, jdescs[-1])))
        assert same >= 0.97 * len(jdescs[-1]), (i, same, len(jdescs[-1]))
    want = jvoc.train_vocabulary(np.concatenate(tdescs), seq["cfg"],
                                 seed=seq["cfg"].seed)
    np.testing.assert_array_equal(
        system.vocab.node_desc.numpy().view(np.uint32),
        np.asarray(want.node_desc))
    np.testing.assert_array_equal(system.vocab.word_weight.numpy(),
                                  np.asarray(want.word_weight))
    # the reference's own bootstrap, from its own descriptors, gives a tree
    # of the same shape
    js = jslam.System(seq["cfg"], ba_window=WINDOW)
    js._bootstrap_vocabulary(seq["grays"][:8])
    assert js.vocab.node_desc.shape == tuple(system.vocab.node_desc.shape)


def test_default_vocabulary_matches_reference(seq):
    with pytest.warns(UserWarning, match="RANDOM-descriptor"):
        tv = tslam.default_vocabulary(seq["tcfg"], "cpu")
    jv = jslam.default_vocabulary(seq["cfg"], warn=False)
    np.testing.assert_array_equal(tv.node_desc.numpy().view(np.uint32),
                                  np.asarray(jv.node_desc))


def test_reset_clears_the_closer_and_metrics(seq, port_system):
    system, recs, _, _ = port_system
    met = system.metrics()
    assert met["frames"] == N_FRAMES and met["loops_closed"] == 0
    assert met["keyframes"] == system.tracker.n_kfs
    assert met["map_points"] == int(system.tracker.map.mp_valid.sum())
    assert met["points_culled"] == system.n_culled_total
    stages = met["stages"]
    # the System's stages and the program's other top-level spans (the
    # frame build, B1's wrapper); the dotted names are their parts
    assert {s for s in stages if "." not in s} == {
        "tracking", "local_mapping", "loop_closing", "frontend", "b1"}
    assert stages["tracking"]["count"] == 2
    assert stages["frontend"]["count"] == N_FRAMES
    counters = {"tracking.pose_lm_iters", "tracking.pose_lm_idle_iters"}
    assert stages["tracking.pose_lm_iters"]["count"] == 80 * N_FRAMES
    assert all(stages[c]["total_ms"] == 0 for c in counters)
    assert all(s["total_ms"] > 0 for name, s in stages.items()
               if name not in counters)
    assert system.last_big_change_idx == 0
    lc = system.loop_closer
    assert lc._n_ingested > 0 and bool(lc.state.db.kf_valid.any())
    lc._pending_verdict.append(torch.tensor([-1, 0], dtype=torch.int32))
    lc.gba = object()
    system.reset()
    assert lc._n_ingested == 0 and not bool(lc.state.db.kf_valid.any())
    assert lc._pending_verdict == [] and not lc.gba_running
    assert system.last_big_change_idx == 1 == system.n_resets
    assert system.tracker.n_kfs == 0


def test_system_defaults_mean_loop_closing(seq):
    off = tslam.System(seq["tcfg"], enable_loop_closing=False, device="cpu")
    assert off.loop_closer is None and not off._vocab_pending
    assert off.relocalizer is None      # relocalization needs the BoW index
    assert off.metrics()["loops_closed"] == 0
    on = tslam.System(seq["tcfg"], vocab=seq["tvoc"], device="cpu")
    assert on.loop_closing_enabled and on.loop_closer.background_gba
    # the relocalizer shares the closer's vocabulary (and its BoW index)
    assert on.relocalizer.vocab is on.loop_closer.vocab is seq["tvoc"]
