"""Port parity of loop closing on the drifted ring of
``tests/test_loop_closing.py`` (K = 16, P = 256, M = 1024, vocabulary 6^3).

One module-scoped fixture runs the reference's ``LoopCloser`` over the 8
calls of its own test and records every program's inputs and outputs; each
of the port's programs then runs on the recorded inputs, carried over by
``convert``:

- ``search_by_node`` and ``search_by_projection_pose(exclude_kp=...)``: exact;
- ``_ingest_and_detect`` call by call: ``LoopState`` equal field by field
  (weights within 1e-6), the same verdict at the same call;
- ``_sim3_check`` with the reference's RANSAC draw handed in: the same
  verdict, inlier count and widened matches, the Sim3 within 1e-4;
- ``_apply_correction``: ``kf_mp``, ``mp_valid``, ``mp_visible`` and
  ``mp_found`` exact, poses and points within 1e-3, the loop edge recorded;
- ``_gba_start`` / ``_gba_step`` / ``_gba_finish`` on the recorded states
  (within 1e-3);
- ``LoopCloser.process(defer=False)`` to a closed loop at the same call,
  with the same points fused. Its largest keyframe translation error is held
  within 5e-2 of the reference's, not 5e-3: the ring's global BA (monocular
  edges, every camera free but one) is ill-conditioned in float32, and the
  REFERENCE's own end state moves between 0.066, 0.088 and 0.092 m when its
  snapshot is perturbed by 2e-7 relative; before the global BA the two
  sides agree within 1e-3 (``_apply_correction``);
- the same ring under ``gba_structure_only=True``, the configuration's
  default and a well-posed problem: every GBA chunk within 1e-3 of the
  reference's from its snapshot, and the port's own closer within 5e-3 of
  the reference's end state;
- ``apply_kf_compaction`` on a remap that drops a row and an edge;
- ``defer=True``: a verdict is consumed exactly one call late.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_2_ros_tpu.frontend import matcher as jmatcher
from orb_slam_2_ros_tpu.pipeline import loop_closing as jlc
from orb_slam_2_ros_tpu.place import vocabulary as jvoc
from orb_slam_2_ros_tpu.solvers import ba as jba
from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.frontend import matcher as tmatcher
from orb_slam_2_ros_tpu_torch.pipeline import loop_closing as tlc
from orb_slam_2_ros_tpu_torch.pipeline.local_mapping import _kf_as_frame
from orb_slam_2_ros_tpu_torch.solvers import ba as tba

from test_loop_closing import (N_KF, build_looped_map, pose_err_deg_m,
                               small_cfg)

# Several test processes share the machine's cores; PyTorch's default of
# one thread per core in each of them makes the many small operations of
# these tests spin against each other (a 16 s fixture took 540 s in a run
# with six workers). Two threads per process keep them out of each other's way.
torch.set_num_threads(2)

PROGRAMS = ("_ingest_and_detect", "_sim3_check", "_apply_correction",
            "_gba_start", "_gba_step", "_gba_finish")
N_CALLS = 8
MIN_GAP = 6


def _np(x):
    """A pytree of jax arrays as numpy (NamedTuples become dicts)."""
    if hasattr(x, "_asdict"):
        return {k: _np(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    return np.asarray(jax.device_get(x))


def _reference_trace(cfg):
    """The reference's closer over the 8 calls, every program recorded."""
    m, gt, descs = build_looped_map(cfg)
    voc = jvoc.train_vocabulary(descs, cfg, seed=0)
    lc = jlc.LoopCloser(cfg, voc, min_kfs_between_loops=MIN_GAP)
    calls = {name: [] for name in PROGRAMS}
    programs = {name: getattr(lc, name) for name in PROGRAMS}
    for name in PROGRAMS:
        def recording(*args, _fn=programs[name], _name=name):
            out = _fn(*args)
            calls[_name].append((args, out))
            return out
        setattr(lc, name, recording)
    m0 = m
    closed_at = None
    for i in range(N_CALLS):
        m, did = lc.process(m, defer=False)
        if did and closed_at is None:
            closed_at = i
    assert closed_at is not None and lc.n_loops_closed == 1
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tvoc = convert.vocabulary_from_numpy(_np(voc._asdict()) | dict(
        k=voc.k, levels=voc.levels, levels_up=voc.levels_up), "cpu")
    return dict(cfg=cfg, tcfg=tcfg, voc=voc, tvoc=tvoc, m0=m0, m_end=m,
                gt=gt, lc=lc, calls=calls, programs=programs,
                closed_at=closed_at)


@pytest.fixture(scope="module")
def trace():
    return _reference_trace(small_cfg())


@pytest.fixture(scope="module")
def trace_structure_only():
    """The same ring under the configuration's default, the global BA that
    holds every camera and refines the landmarks alone."""
    cfg = small_cfg()
    return _reference_trace(dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, gba_structure_only=True)))


def _tmap(jm):
    return convert.map_state_from_numpy(_np(jm), "cpu")


def _tstate(jst):
    return convert.loop_state_from_numpy(_np(jst), "cpu")


def _assert_state_equal(tst, jst):
    got, want = convert.to_numpy(tst), _np(jst)
    for f in tlc.LoopState._fields:
        if f == "db":
            np.testing.assert_array_equal(got["db"]["kf_word"],
                                          want["db"]["kf_word"])
            np.testing.assert_array_equal(got["db"]["kf_valid"],
                                          want["db"]["kf_valid"])
            np.testing.assert_allclose(got["db"]["kf_wt"],
                                       want["db"]["kf_wt"], atol=1e-6)
        elif got[f].dtype.kind == "f":
            np.testing.assert_allclose(got[f], want[f], atol=1e-4, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_search_by_node_and_exclude_kp(trace):
    (jm, jst, c, k, _), _ = trace["calls"]["_sim3_check"][-1]
    c, k = int(c), int(k)
    tm, tst = _tmap(jm), _tstate(jst)
    cfg, tcfg = trace["cfg"], trace["tcfg"]
    jvk = jm.kf_kp_valid[k] & (jm.kf_mp[k] >= 0)
    jvc = jm.kf_kp_valid[c] & (jm.kf_mp[c] >= 0)
    for kw in (dict(), dict(nn_ratio=0.9, check_rotation=False)):
        jout = jmatcher.search_by_node(
            jm.kf_desc[k], jst.kf_node[k], jvk, jm.kf_angle[k],
            jm.kf_desc[c], jst.kf_node[c], jvc, jm.kf_angle[c], cfg, **kw)
        tout = tmatcher.search_by_node(
            tm.kf_desc[k], tst.kf_node[k],
            tm.kf_kp_valid[k] & (tm.kf_mp[k] >= 0), tm.kf_angle[k],
            tm.kf_desc[c], tst.kf_node[c],
            tm.kf_kp_valid[c] & (tm.kf_mp[c] >= 0), tm.kf_angle[c], tcfg, **kw)
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int((tout[0] >= 0).sum()) >= 20
    # projection search of c's points into k with half of k's keypoints
    # taken out
    exclude = np.arange(jm.P) % 2 == 0
    mp_c = jnp.clip(jm.kf_mp[c], 0)
    jfr = jlc._kf_as_frame(jm, k)
    jout = jmatcher.search_by_projection_pose(
        jm.mp_pos[mp_c], jm.kf_desc[c], jm.kf_octave[c], jvc, jm.kf_q[c],
        jm.kf_t[c], jfr, cfg, th=10.0, check_rotation=False,
        exclude_kp=jnp.asarray(exclude))
    tfr = _kf_as_frame(tm, torch.tensor(k))
    tmp_c = torch.clamp(tm.kf_mp[c], min=0).long()
    targs = (tm.mp_pos[tmp_c], tm.kf_desc[c], tm.kf_octave[c],
             tm.kf_kp_valid[c] & (tm.kf_mp[c] >= 0), tm.kf_q[c], tm.kf_t[c],
             tfr, tcfg)
    tout = tmatcher.search_by_projection_pose(
        *targs, th=10.0, check_rotation=False,
        exclude_kp=torch.from_numpy(exclude))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((tout[0] >= 0).sum()) > 0
    assert not bool((tout[0] >= 0)[torch.from_numpy(exclude)].any())
    free = tmatcher.search_by_projection_pose(*targs, th=10.0,
                                              check_rotation=False)
    assert bool((free[0] >= 0)[torch.from_numpy(exclude)].any())


def test_ingest_and_detect_step_by_step(trace):
    """The port's own chain of states over the reference's calls: every
    state equal to the reference's, the verdict the same at each call."""
    calls = trace["calls"]["_ingest_and_detect"]
    assert len(calls) == N_CALLS
    tst = tlc.empty_state(trace["tcfg"], "cpu")
    n_ing = 0
    found_at = []
    for i, ((jm, jst_in), (jst_out, jcand, jk)) in enumerate(calls):
        tm = _tmap(jm)
        if i > trace["closed_at"]:
            # the correction rewrote the closer's state; restart from the
            # reference's
            tst = _tstate(jst_in)
        _assert_state_equal(tst, jst_in)
        tst, verdict, n_ing = tlc._ingest_and_detect(
            tm, tst, trace["tcfg"], trace["tvoc"], 3 * MIN_GAP, int(jm.n_kfs),
            n_ing)
        _assert_state_equal(tst, jst_out)
        assert n_ing == int(jst_out.n_ingested) == min(4 * (i + 1), N_KF)
        cand, k = verdict.tolist()
        assert cand == int(jcand), i
        if cand >= 0:
            assert k == int(jk)
            found_at.append(i)
    assert found_at and found_at[0] == trace["closed_at"]


def _reference_draw(jm, jst, c, k, key, cfg):
    """The (256, 3) sample indices of the reference's ``ransac_sim3`` for
    this ladder: its pairing, then its one line that draws."""
    valid_k = jm.kf_kp_valid[k] & (jm.kf_mp[k] >= 0)
    valid_c = jm.kf_kp_valid[c] & (jm.kf_mp[c] >= 0)
    c_to_k, _ = jmatcher.search_by_node(
        jm.kf_desc[k], jst.kf_node[k], valid_k, jm.kf_angle[k],
        jm.kf_desc[c], jst.kf_node[c], valid_c, jm.kf_angle[c], cfg)
    mp_k = jm.kf_mp[k][jnp.clip(c_to_k, 0)]
    pair_ok = (c_to_k >= 0) & (mp_k >= 0) & (jm.kf_mp[c] >= 0)
    pw = pair_ok.astype(jnp.float32)
    pw = pw / jnp.maximum(jnp.sum(pw), 1e-9)
    return np.asarray(jax.random.choice(key, jm.P, shape=(256, 3),
                                        replace=True, p=pw))


def test_sim3_check_with_the_references_draw(trace):
    calls = trace["calls"]["_sim3_check"]
    assert len(calls) >= 1
    for (jm, jst, c, k, key), jout in calls:
        c, k = int(c), int(k)
        idx = _reference_draw(jm, jst, c, k, key, trace["cfg"])
        tout = tlc._sim3_check(_tmap(jm), _tstate(jst), c, k, trace["tcfg"],
                               sample_idx=torch.from_numpy(idx))
        accepted, n_inl, q12, t12, s12, kp_w, counts = tout
        assert bool(accepted) == bool(jout[0])
        assert int(n_inl) == int(jout[1]) >= 20
        np.testing.assert_array_equal(kp_w.numpy(), np.asarray(jout[5]))
        np.testing.assert_allclose(q12.numpy(), np.asarray(jout[2]), atol=1e-4)
        np.testing.assert_allclose(t12.numpy(), np.asarray(jout[3]), atol=1e-4)
        np.testing.assert_allclose(s12.numpy(), np.asarray(jout[4]), atol=1e-5)
        assert counts.tolist()[:2] == [int(bool(jout[0])), int(jout[1])]
        assert counts.dtype == torch.int32 and s12.shape == (1,)
    assert bool(calls[-1][1][0])            # the last ladder was accepted


def test_apply_correction(trace):
    (jm, jst, c, k, q12, t12, s12, kp_w), (jm2, jst2) = \
        trace["calls"]["_apply_correction"][0]
    c, k = int(c), int(k)
    tm2, tst2 = tlc._apply_correction(
        _tmap(jm), _tstate(jst), c, k,
        *[torch.from_numpy(np.asarray(x).copy()) for x in (q12, t12, s12, kp_w)],
        trace["tcfg"])
    want = _np(jm2)
    got = convert.to_numpy(tm2)
    for f in ("kf_mp", "mp_valid", "mp_visible", "mp_found", "kf_valid",
              "n_kfs", "n_mps"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("kf_q", "kf_t", "mp_pos"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-3, err_msg=f)
    assert (want["mp_valid"] != _np(jm)["mp_valid"]).sum() > 0   # it fused
    # the loop edge is recorded, the counters are cleared
    _assert_state_equal(tst2, jst2)
    assert int(tst2.n_loop_edges) == 1 and int(tst2.last_loop_kf) == k
    assert (int(tst2.loop_ei[0]), int(tst2.loop_ej[0])) == (c, k)
    assert int(tst2.consist_cnt.sum()) == 0
    # the correction moved the drifted half toward the truth
    gt = trace["gt"]
    before = pose_err_deg_m(jm.kf_q[k], jm.kf_t[k], *gt[k])[1]
    after = pose_err_deg_m(jnp.asarray(got["kf_q"][k]),
                           jnp.asarray(got["kf_t"][k]), *gt[k])[1]
    assert after < 0.5 * before


def test_gba_programs(trace):
    tcfg = trace["tcfg"]
    (jm, jst), jg0 = trace["calls"]["_gba_start"][0]
    tg = tlc._gba_start(_tmap(jm), _tstate(jst), tcfg)
    got, want = convert.to_numpy(tg), _np(jg0)
    for f in tg._fields:
        if got[f].dtype.kind == "f":
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert bool(tg.cam_free[1:N_KF].all()) and not bool(tg.cam_free[0])
    # one chunk from the reference's snapshot: the error both reach (the
    # all-free problem is ill-conditioned in float32, see
    # tests/test_torch_gba.py)
    (jg_in,), jg_out = trace["calls"]["_gba_step"][0]
    tg1 = tlc._gba_step(convert.dense_gba_state_from_numpy(_np(jg_in), "cpu"),
                        tcfg)
    print(f"GBA chunk: err {float(jg_in.err):.4g} -> port "
          f"{float(tg1.err):.4g}, reference {float(jg_out.err):.4g}")
    assert float(tg1.err) < 0.5 * float(jg_in.err)
    assert float(tg1.err) < 2.0 * float(jg_out.err)
    np.testing.assert_allclose(tg1.t.numpy(), np.asarray(jg_out.t), atol=5e-2)
    # the reconciliation, from the reference's final GBA state
    (jm_f, jg_f), jm_out = trace["calls"]["_gba_finish"][0]
    tm_out = tlc._gba_finish(
        _tmap(jm_f), convert.dense_gba_state_from_numpy(_np(jg_f), "cpu"))
    for f in ("kf_q", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(tm_out, f).numpy(),
                                   np.asarray(getattr(jm_out, f)), atol=1e-4,
                                   err_msg=f)


def test_gba_finish_propagates_to_later_keyframes(trace):
    """Keyframes and points created while the GBA ran follow their nearest
    in-GBA ancestor (the ``cummax`` in place of the associative scan)."""
    (jm_f, jg_f), _ = trace["calls"]["_gba_finish"][0]
    n0 = N_KF - 3
    jg = jg_f._replace(n0=jnp.int32(n0), nm0=jnp.int32(200))
    want = trace["programs"]["_gba_finish"](jm_f, jg)
    tm_out = tlc._gba_finish(
        _tmap(jm_f), convert.dense_gba_state_from_numpy(_np(jg), "cpu"))
    for f in ("kf_q", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(tm_out, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   err_msg=f)


def _max_trn_err(kf_q, kf_t, gt):
    errs = np.asarray([pose_err_deg_m(jnp.asarray(kf_q[i]),
                                      jnp.asarray(kf_t[i]), *gt[i])[1]
                       for i in range(N_KF)])
    assert np.isfinite(errs).all(), errs
    return float(errs.max())


@pytest.fixture(scope="module")
def port_run(trace):
    """The port's closer over the same 8 calls, with its own RANSAC draw."""
    lc = tlc.LoopCloser(trace["tcfg"], trace["tvoc"],
                        min_kfs_between_loops=MIN_GAP)
    m = _tmap(trace["m0"])
    closed_at = []
    for i in range(N_CALLS):
        m, did = lc.process(m, defer=False)
        if did:
            closed_at.append(i)
    return lc, m, closed_at


def test_process_closes_the_ring_like_the_reference(trace, port_run):
    lc, m, closed_at = port_run
    jl = trace["lc"]
    assert closed_at == [trace["closed_at"]]
    assert lc.n_loops_closed == jl.n_loops_closed == 1
    assert lc.n_ladders == len(trace["calls"]["_sim3_check"])
    assert lc.n_corrections == 1
    assert (lc.n_gba_finished, lc.n_gba_rejected, lc.n_gba_aborts) == \
        (jl.n_gba_finished, jl.n_gba_rejected, jl.n_gba_aborts)
    assert not lc.gba_running and lc._pending_verdict == []
    ladder = [e for e in lc.events if e["kind"] == "ladder"][-1]
    assert ladder["accepted"] and ladder["n_inl"] >= 20
    assert ladder["n_inl"] + ladder["n_widened"] >= 40
    assert [e["kind"] for e in lc.events][-1] == "gba"
    jm = trace["m_end"]
    want = _max_trn_err(np.asarray(jm.kf_q), np.asarray(jm.kf_t), trace["gt"])
    got = _max_trn_err(m.kf_q.numpy(), m.kf_t.numpy(), trace["gt"])
    print(f"max keyframe translation error: port {got:.4f} m, reference "
          f"{want:.4f} m")
    assert abs(got - want) < 5e-2 and got < 0.12
    # the same fusion: the same points survive
    np.testing.assert_array_equal(m.mp_valid.numpy(), np.asarray(jm.mp_valid))
    assert (m.kf_mp.numpy() == np.asarray(jm.kf_mp)).mean() > 0.99
    _assert_state_equal(lc.state._replace(
        loop_rq=_tstate(jl.state).loop_rq, loop_rt=_tstate(jl.state).loop_rt),
        jl.state)
    np.testing.assert_allclose(lc.state.loop_rt.numpy(),
                               np.asarray(jl.state.loop_rt), atol=5e-3)
    assert abs(lc._loop_edge_residual(m) - jl._loop_edge_residual(jm)) < 5e-3


def test_structure_only_gba_like_the_reference(trace_structure_only):
    """``gba_structure_only=True``, the default: a well-posed problem (one
    damped 3x3 solve per landmark), so every GBA program is held to the
    reference's within 1e-3 from the reference's own snapshot, and the
    port's own closer (its own RANSAC draw) to the reference's end state
    within 5e-3."""
    tr = trace_structure_only
    tcfg, jl = tr["tcfg"], tr["lc"]
    assert tcfg.solver.gba_structure_only
    (jm, jst), jg0 = tr["calls"]["_gba_start"][0]
    tg = tlc._gba_start(_tmap(jm), _tstate(jst), tcfg)
    assert not bool(tg.cam_free.any()) and not bool(jg0.cam_free.any())
    np.testing.assert_allclose(float(tg.err), float(jg0.err), rtol=1e-4)
    steps = tr["calls"]["_gba_step"]
    assert len(steps) == tcfg.solver.global_ba_iters // tlc.GBA_CHUNK_ITERS
    for (jg_in,), jg_out in steps:
        tg1 = tlc._gba_step(
            convert.dense_gba_state_from_numpy(_np(jg_in), "cpu"), tcfg)
        np.testing.assert_allclose(tg1.pos.numpy(), np.asarray(jg_out.pos),
                                   atol=1e-3)
        np.testing.assert_allclose(float(tg1.err), float(jg_out.err),
                                   rtol=1e-3)
        assert torch.equal(tg1.q, torch.from_numpy(np.asarray(jg_in.q)))
        assert torch.equal(tg1.t, torch.from_numpy(np.asarray(jg_in.t)))
    assert float(steps[0][1].err) < float(steps[0][0][0].err)
    # the damping path is held over the first three iterations, while each
    # step still gains more than float noise (the landmarks are at their
    # optimum by then, where an accept is a coin's toss on both sides)
    jg3 = jba.dense_gba_chunk(steps[0][0][0], tr["cfg"], n_iters=3)
    tg3 = tba.dense_gba_chunk(
        convert.dense_gba_state_from_numpy(_np(steps[0][0][0]), "cpu"), tcfg,
        n_iters=3, structure_only=True)
    np.testing.assert_allclose(float(tg3.lam), float(jg3.lam), rtol=1e-5)
    np.testing.assert_allclose(tg3.pos.numpy(), np.asarray(jg3.pos), atol=1e-4)
    # the port's own closer from the same map
    lc = tlc.LoopCloser(tcfg, tr["tvoc"], min_kfs_between_loops=MIN_GAP)
    m = _tmap(tr["m0"])
    closed_at = []
    for i in range(N_CALLS):
        m, did = lc.process(m, defer=False)
        if did:
            closed_at.append(i)
    assert closed_at == [tr["closed_at"]]
    assert (lc.n_loops_closed, lc.n_gba_finished, lc.n_gba_rejected) == \
        (jl.n_loops_closed, jl.n_gba_finished, jl.n_gba_rejected) == (1, 1, 0)
    jm_end = tr["m_end"]
    want = _max_trn_err(np.asarray(jm_end.kf_q), np.asarray(jm_end.kf_t),
                        tr["gt"])
    got = _max_trn_err(m.kf_q.numpy(), m.kf_t.numpy(), tr["gt"])
    print(f"structure-only: max keyframe translation error: port {got:.4f} "
          f"m, reference {want:.4f} m")
    assert abs(got - want) < 5e-3
    np.testing.assert_array_equal(m.mp_valid.numpy(),
                                  np.asarray(jm_end.mp_valid))
    np.testing.assert_allclose(m.kf_t.numpy(), np.asarray(jm_end.kf_t),
                               atol=5e-3)
    np.testing.assert_allclose(m.mp_pos.numpy()[m.mp_valid.numpy()],
                               np.asarray(jm_end.mp_pos)[m.mp_valid.numpy()],
                               atol=5e-3)


def test_apply_kf_compaction(trace, port_run):
    """Both closers, after the loop, through a remap that drops row 2 and
    the loop edge's keyframe (so the edge goes too)."""
    jl = trace["lc"]
    lc = tlc.LoopCloser(trace["tcfg"], trace["tvoc"],
                        min_kfs_between_loops=MIN_GAP)
    lc.state = _tstate(jl.state)
    lc._n_ingested = int(jl.state.n_ingested)
    lc._pending_verdict = [torch.tensor([1, 2], dtype=torch.int32)]
    K = trace["cfg"].map.max_kfs
    st0 = jl.state
    try:
        for drop in ((2,), (2, int(st0.loop_ei[0]))):
            keep = np.ones(K, bool)
            keep[list(drop)] = False
            remap = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
            jl.state = st0
            jl.apply_kf_compaction(remap)
            lc.state = _tstate(st0)
            lc._n_ingested = int(st0.n_ingested)
            lc.apply_kf_compaction(remap)
            _assert_state_equal(lc.state, jl.state)
            assert lc._n_ingested == int(jl.state.n_ingested) \
                == N_KF - len(drop)
            assert lc._pending_verdict == []
            assert int(lc.state.n_loop_edges) == (1 if len(drop) == 1 else 0)
    finally:
        jl.state = st0


def test_deferred_verdicts_land_one_call_late(trace, port_run):
    _, _, closed_at = port_run
    lc = tlc.LoopCloser(trace["tcfg"], trace["tvoc"],
                        min_kfs_between_loops=MIN_GAP, background_gba=True)
    m = _tmap(trace["m0"])
    closed = []
    for i in range(N_CALLS):
        m, did = lc.process(m, n_kfs=N_KF)
        assert len(lc._pending_verdict) <= 1
        if did:
            closed.append(i)
            assert lc.gba_running       # stepped in the background
    assert closed == [closed_at[0] + 1]
    # the queue drains at the end of a sequence, and the GBA on request
    lc.dispatch(m, N_KF)
    m, did = lc.finish_pending(m)
    assert not did and lc._pending_verdict == []
    steps = 0
    while lc.gba_running:
        m, finished = lc.step_background(m)
        steps += 1
    assert finished and steps == 4          # 20 iterations in chunks of 5
    assert lc.n_gba_finished == 1
    m2, finished = lc.step_background(m)
    assert m2 is m and not finished
    # a verdict whose keyframe was culled meanwhile is dropped unseen
    dead = m._replace(kf_valid=m.kf_valid.clone())
    dead.kf_valid[3] = False
    n = lc.n_ladders
    assert lc.consume_host(dead, 3, N_KF - 1) == (dead, False)
    assert lc.consume_host(dead, -1, N_KF - 1) == (dead, False)
    assert lc.n_ladders == n
    lc.reset()
    assert lc._n_ingested == 0 and not bool(lc.state.db.kf_valid.any())
    assert lc.n_loops_closed == 1           # the counters go on
