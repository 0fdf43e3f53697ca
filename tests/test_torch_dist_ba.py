"""The port's distributed back end (``parallel/``) over gloo ranks on the
CPU, against the reference's single-device solvers.

The reference's own ``tests/test_dist_ba.py`` holds its sharded functions
equal to its single-device ones on a virtual 8-device mesh; that compile
takes minutes, so here the port's sharded functions are held to the
reference's single-device functions (or to the port's single-device
functions where those are held to the reference), at the reference's
tolerances:

- ``gba_init`` + ``gba_chunk`` (one device) against the reference's on
  ``tests/test_ba.py::make_ba_problem(6, 120)`` (the reference's snapshot,
  carried over by ``convert.gba_state_from_numpy``, equal to the port's):
  q 2e-4, t 2e-3, pos 1e-3,
  ``err`` 1e-3 relative (near the optimum an LM step can be accepted on
  one side and refused on the other by float noise, so ``lam`` may differ);
- ``pad_problem``: equal to the reference's;
- ``distributed_bundle_adjustment`` over 2 and 4 ranks against the
  reference's ``bundle_adjustment``: q 2e-4, t 2e-3, mean pose errors within
  1e-3 of each other, the edge inlier masks equal once the padding is cut
  (``test_dist_ba.py:28-36``);
- ``distributed_windowed_ba`` over 4 ranks (``kf`` x ``mp`` = 2 x 2 and
  4 x 1) against the port's single-device windowed BA on
  ``make_ba_problem(8, 150)``: q 2e-4, t 2e-3, equal free counts, the inlier
  masks equal on more than 99% of the edges (``test_dist_ba.py:121-128``);
- ``distributed_gba_chunk`` (points sharded) over 2 and 4 ranks against the
  port's single-device ``gba_chunk``, after each of two chunks of 5
  iterations: q 2e-4, t 2e-3, ``err`` 1e-5 relative, pos 2e-4 (the optimum
  is reached within the first chunk, and there a step that moves the error
  by float noise is taken on one side and refused on the other: points
  8 m deep then differ by 1e-4, and ``lam`` differs);
- ``distributed_pose_optimization`` over 2 ranks against the reference's
  ``pose_optimization``: q 1e-4, t 1e-3, the inlier masks equal;
- every rank's outputs equal rank 0's bit for bit; the mesh's rank layout
  and groups; ``multihost`` without a group; a ``cuda`` mesh raises
  without NCCL or without a card.

The ranks are spawned processes that import only ``torch`` and the port
(the JAX side stays in the parent), each with one thread, a 60 s
rendezvous timeout and a file store under the test's own directory, and
the parent joins them with a deadline, so a hang fails one test.
"""

import dataclasses
import datetime
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam_2_ros_tpu_torch import convert
from orb_slam_2_ros_tpu_torch.parallel import (dist_ba, dist_pose, mesh,
                                               multihost)
from orb_slam_2_ros_tpu_torch.solvers import ba as tba

torch.set_num_threads(2)

RANK_TIMEOUT_S = 240


# ----------------------------------------------------------- spawned ranks

def _rank_entry(rank, world, store, job, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = job(*args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(job, world, args, tmp_dir, timeout=RANK_TIMEOUT_S):
    """``job(*args)`` in ``world`` spawned gloo ranks; the list of their
    results, rank 0's first. Fails if a rank fails or outlives
    ``timeout``."""
    out_dir = os.path.join(str(tmp_dir), f"ranks_{job.__name__}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, os.path.join(out_dir, "store"), job,
                               args, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    # the ranks' own files: numpy arrays and dicts, not only tensors
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def assert_ranks_equal(results):
    """Every rank's outputs equal rank 0's, bit for bit."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        assert res.keys() == first.keys()
        for k in first:
            a, b = first[k], res[k]
            if isinstance(a, dict):
                assert_ranks_equal([a, b])
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b)), (r, k)


# ------------------------------------------------------------ the problems

def _np(x):
    return np.asarray(x)


def _ba_problem(n_cams, n_pts):
    """``make_ba_problem``'s arrays as numpy, and the port's config."""
    from test_ba import make_ba_problem
    (cfg, prob, q0, t0, pos0, cam_free, q_true, t_true, _) = \
        make_ba_problem(n_cams=n_cams, n_pts=n_pts)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return dict(cfg=cfg, tcfg=tcfg, prob={f: _np(v) for f, v in
                                         prob._asdict().items()},
                q0=_np(q0), t0=_np(t0), pos0=_np(pos0),
                cam_free=_np(cam_free), q_true=_np(q_true),
                t_true=_np(t_true))


def _for_ranks(pr):
    """The problem without the reference's config, so that a rank unpickles
    nothing of the JAX package."""
    return {k: v for k, v in pr.items() if k != "cfg"}


def _tprob(p):
    return tba.BAProblem(
        cam_idx=_t(p["cam_idx"]).long(), mp_idx=_t(p["mp_idx"]).long(),
        obs=_t(p["obs"]), is_stereo=_t(p["is_stereo"]),
        inv_sigma2=_t(p["inv_sigma2"]), valid=_t(p["valid"]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _gba_state(pr):
    M = pr["pos0"].shape[0]
    return tba.gba_init(_t(pr["q0"]), _t(pr["t0"]), _t(pr["cam_free"]),
                        _t(pr["pos0"]), torch.ones(M, dtype=torch.bool),
                        _tprob(pr["prob"]), len(pr["q0"]), M, pr["tcfg"],
                        robust=False)


GBA_CHUNKS = 2          # the loop closer's 10 iterations in chunks of 5
GBA_ITERS = 5


def _gba_single(pr):
    """The single-device state after each chunk."""
    st, out = _gba_state(pr), []
    for _ in range(GBA_CHUNKS):
        st = tba.gba_chunk(st, pr["tcfg"], n_iters=GBA_ITERS)
        out.append(st)
    return out


def _table(pr, n_cams, n_pts):
    from test_ba import _problem_as_table
    from orb_slam_2_ros_tpu.solvers import ba as jba
    prob = jba.BAProblem(**pr["prob"])
    return [_np(a) for a in _problem_as_table(n_cams, n_pts, prob,
                                              pr["cfg"])]


WINDOW_ROWS = np.array([1, 2, 3, 4, 5, 6, 7, -1], np.int32)


def _windowed_single(pr, table):
    kf_uv, kf_ur, kf_oct, kf_mp, kp_valid = table
    M = pr["pos0"].shape[0]
    return tba.windowed_bundle_adjustment(
        _t(pr["q0"]), _t(pr["t0"]), _t(WINDOW_ROWS), _t(kf_uv), _t(kf_ur),
        _t(kf_oct), _t(kf_mp), _t(kp_valid), _t(pr["pos0"]),
        torch.ones(M, dtype=torch.bool), pr["tcfg"])


def _pose_problem():
    from test_pose_opt import make_problem
    cfg, pts, obs_uv, obs_ur, octv, _, _ = make_problem(
        n=201, noise=0.2, outlier_frac=0.2, stereo=True)
    return cfg, pts, obs_uv, obs_ur, octv


# --------------------------------------------------------------- rank jobs

def _job_edges(n_mp, ba_pr, gba_pr, pose, items):
    """Run on every rank of a world of ``n_mp``: the edge-sharded BA, the
    point-sharded GBA chunk, the pose LM (2 ranks), the mesh's layout and
    the session shard."""
    m = mesh.make_mesh(n_kf=1, n_mp=n_mp, device="cpu")
    tcfg = ba_pr["tcfg"]
    M = ba_pr["pos0"].shape[0]
    q, t, pos, inl = dist_ba.distributed_bundle_adjustment(
        m, _t(ba_pr["q0"]), _t(ba_pr["t0"]), _t(ba_pr["cam_free"]),
        _t(ba_pr["pos0"]), torch.ones(M, dtype=torch.bool),
        _tprob(ba_pr["prob"]), tcfg)
    out = {"ba": {"q": q.numpy(), "t": t.numpy(), "pos": pos.numpy(),
                  "inl": inl.numpy()}}

    st = dist_ba.shard_gba_state(m, _gba_state(gba_pr), gba_pr["tcfg"])
    out["gba"] = {}
    for c in range(GBA_CHUNKS):
        st = dist_ba.distributed_gba_chunk(m, st, gba_pr["tcfg"],
                                           n_iters=GBA_ITERS)
        whole = dist_ba.gather_gba_points(m, st, gba_pr["tcfg"])
        out["gba"][f"chunk{c}"] = {
            "q": st.q.numpy(), "t": st.t.numpy(), "pos": whole.pos.numpy(),
            "mp_free": whole.mp_free.numpy(), "lam": st.lam.numpy(),
            "err": st.err.numpy(), "local_rows": st.pos.shape[0],
            "local_edges": st.prob.cam_idx.shape[0]}

    if pose is not None:
        tcfg_p, pts, obs_uv, obs_ur, octv = pose
        q0, t0 = torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)
        q, t, inl, n_in = dist_pose.distributed_pose_optimization(
            m, q0, t0, _t(pts), _t(obs_uv), _t(obs_ur), _t(octv),
            torch.ones(len(pts), dtype=torch.bool), tcfg_p)
        out["pose"] = {"q": q.numpy(), "t": t.numpy(), "inl": inl.numpy(),
                       "n_in": n_in.numpy()}

    out["layout"] = {
        "kf": m.index("kf"), "mp": m.index("mp"),
        "mp_group": dist.get_process_group_ranks(m.group("mp")),
        "kf_group": dist.get_process_group_ranks(m.group("kf")),
        "session": multihost.local_session_shard(items)}
    try:
        mesh.make_mesh(n_kf=1, n_mp=n_mp, device="cuda")
        out["cuda_on_gloo"] = "built"
    except RuntimeError as e:
        out["cuda_on_gloo"] = str(e)
    return out


def _job_rows(layouts, pr, table):
    """Run on every rank of a world of 4: the row-sharded windowed BA on
    each (n_kf, n_mp) layout, and each layout's rank placement."""
    kf_uv, kf_ur, kf_oct, kf_mp, kp_valid = table
    M = pr["pos0"].shape[0]
    out = {}
    for n_kf, n_mp in layouts:
        m = mesh.make_mesh(n_kf=n_kf, n_mp=n_mp, device="cpu")
        stats = {}
        q, t, pos, inl, loose, nf = dist_ba.distributed_windowed_ba(
            m, _t(pr["q0"]), _t(pr["t0"]), _t(WINDOW_ROWS), _t(kf_uv),
            _t(kf_ur), _t(kf_oct), _t(kf_mp), _t(kp_valid), _t(pr["pos0"]),
            torch.ones(M, dtype=torch.bool), pr["tcfg"], stats=stats)
        out[f"{n_kf}x{n_mp}"] = {
            "q": q.numpy(), "t": t.numpy(), "pos": pos.numpy(),
            "inl": inl.numpy(), "loose": loose.numpy(), "n_free": nf.numpy(),
            "iters": np.asarray(stats["iters"]),
            "kf": m.index("kf"), "mp": m.index("mp"),
            "mp_group": dist.get_process_group_ranks(m.group("mp")),
            "kf_group": dist.get_process_group_ranks(m.group("kf"))}
    return out


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def problems():
    pose = _pose_problem()
    tpose = (convert.config_from_dict(dataclasses.asdict(pose[0])),) \
        + pose[1:]
    return {"ba": _ba_problem(6, 120), "gba": _ba_problem(6, 120),
            "rows": _ba_problem(8, 150), "pose": pose, "tpose": tpose}


ITEMS = list(range(10))


@pytest.fixture(scope="module")
def edge_runs(problems, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("edges")
    return {n: run_ranks(_job_edges, n,
                         (n, _for_ranks(problems["ba"]),
                          _for_ranks(problems["gba"]),
                          problems["tpose"] if n == 2 else None, ITEMS), tmp)
            for n in (2, 4)}


ROW_LAYOUTS = ((2, 2), (4, 1))


@pytest.fixture(scope="module")
def row_runs(problems, tmp_path_factory):
    pr = problems["rows"]
    table = _table(pr, 8, 150)
    res = run_ranks(_job_rows, 4, (ROW_LAYOUTS, _for_ranks(pr), table),
                    tmp_path_factory.mktemp("rows"))
    return res, _windowed_single(pr, table)


# ------------------------------------------------------------------- tests

def _mean_pose_err(q, t, q_true, t_true):
    from test_ba import mean_pose_err
    import jax.numpy as jnp
    return mean_pose_err(jnp.asarray(q), jnp.asarray(t), jnp.asarray(q_true),
                         jnp.asarray(t_true))


def test_gba_chunk_matches_reference(problems):
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.solvers import ba as jba
    pr = problems["gba"]
    M = pr["pos0"].shape[0]
    jst = jba.gba_init(jnp.asarray(pr["q0"]), jnp.asarray(pr["t0"]),
                       jnp.asarray(pr["cam_free"]), jnp.asarray(pr["pos0"]),
                       jnp.ones(M, bool), jba.BAProblem(**pr["prob"]),
                       len(pr["q0"]), M, pr["cfg"], robust=False)
    tst = _gba_state(pr)
    np.testing.assert_allclose(float(tst.err), float(jst.err), rtol=1e-5)
    # the reference's snapshot carried over is the port's own
    import jax
    carried = convert.gba_state_from_numpy(jax.device_get(jst._asdict()),
                                           "cpu")
    for f in ("q", "t", "pos", "cam_free", "mp_free", "lam", "n0", "nm0"):
        assert torch.equal(getattr(carried, f), getattr(tst, f)), f
    for f in tba.BAProblem._fields:
        assert torch.equal(getattr(carried.prob, f), getattr(tst.prob, f)), f
    for _ in range(GBA_CHUNKS):
        jst = jba.gba_chunk(jst, pr["cfg"], n_iters=GBA_ITERS)
        tst = tba.gba_chunk(tst, pr["tcfg"], n_iters=GBA_ITERS)
        np.testing.assert_allclose(tst.q.numpy(), _np(jst.q), atol=2e-4)
        np.testing.assert_allclose(tst.t.numpy(), _np(jst.t), atol=2e-3)
        np.testing.assert_allclose(tst.pos.numpy(), _np(jst.pos), atol=1e-3)
        np.testing.assert_allclose(float(tst.err), float(jst.err), rtol=1e-3)
    assert int(tst.n0) == int(jst.n0) and int(tst.nm0) == int(jst.nm0)


@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
def test_pad_problem_matches_reference(problems, n_shards):
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.parallel import dist_ba as jdist
    from orb_slam_2_ros_tpu.solvers import ba as jba
    p = problems["ba"]["prob"]
    cut = {f: v[:-5] for f, v in p.items()}      # 715 edges
    want = jdist.pad_problem(jba.BAProblem(
        **{f: jnp.asarray(v) for f, v in cut.items()}), n_shards)
    got = dist_ba.pad_problem(_tprob(cut), n_shards)
    for f in tba.BAProblem._fields:
        a, b = getattr(got, f).numpy(), _np(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


@pytest.mark.parametrize("n_mp", [2, 4])
def test_distributed_bundle_adjustment_matches_reference(problems,
                                                         edge_runs, n_mp):
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.solvers import ba as jba
    pr = problems["ba"]
    M = pr["pos0"].shape[0]
    q1, t1, _, inl1 = jba.bundle_adjustment(
        jnp.asarray(pr["q0"]), jnp.asarray(pr["t0"]),
        jnp.asarray(pr["cam_free"]), jnp.asarray(pr["pos0"]),
        jnp.ones(M, bool), jba.BAProblem(**pr["prob"]), pr["cfg"])
    got = edge_runs[n_mp][0]["ba"]
    np.testing.assert_allclose(got["q"], _np(q1), atol=2e-4)
    np.testing.assert_allclose(got["t"], _np(t1), atol=2e-3)
    assert abs(_mean_pose_err(got["q"], got["t"], pr["q_true"],
                              pr["t_true"])
               - _mean_pose_err(q1, t1, pr["q_true"], pr["t_true"])) < 1e-3
    valid = pr["prob"]["valid"]
    E = len(valid)
    assert len(got["inl"]) % n_mp == 0 and len(got["inl"]) >= E
    np.testing.assert_array_equal(got["inl"][:E][valid], _np(inl1)[valid])


@pytest.mark.parametrize("n_mp", [2, 4])
def test_distributed_gba_chunk_matches_single_device(problems, edge_runs,
                                                     n_mp):
    pr = problems["gba"]
    want = _gba_single(pr)
    M = pr["pos0"].shape[0]
    for c, w in enumerate(want):
        got = edge_runs[n_mp][0]["gba"][f"chunk{c}"]
        assert got["local_rows"] == M // n_mp
        assert got["local_edges"] == len(pr["prob"]["valid"]) // n_mp
        np.testing.assert_array_equal(got["mp_free"], w.mp_free.numpy())
        np.testing.assert_allclose(got["q"], w.q.numpy(), atol=2e-4)
        np.testing.assert_allclose(got["t"], w.t.numpy(), atol=2e-3)
        np.testing.assert_allclose(float(got["err"]), float(w.err),
                                   rtol=1e-5)
        # the problem reaches its optimum within the first chunk; there a
        # step that moves the error by float noise is taken on one side and
        # refused on the other, which moves points 8 m deep by 1e-4
        np.testing.assert_allclose(got["pos"], w.pos.numpy(), atol=2e-4)


@pytest.mark.parametrize("layout", ROW_LAYOUTS)
def test_distributed_windowed_ba_matches_single_device(problems, row_runs,
                                                       layout):
    pr = problems["rows"]
    res, want = row_runs
    q1, t1, pos1, inl1, _, nf1 = (x.numpy() for x in want)
    got = res[0][f"{layout[0]}x{layout[1]}"]
    np.testing.assert_allclose(got["q"], q1, atol=2e-4)
    np.testing.assert_allclose(got["t"], t1, atol=2e-3)
    assert int(got["n_free"]) == int(nf1)
    assert abs(_mean_pose_err(got["q"], got["t"], pr["q_true"],
                              pr["t_true"])
               - _mean_pose_err(q1, t1, pr["q_true"], pr["t_true"])) < 1e-3
    assert (got["inl"] == inl1).mean() > 0.99


def test_distributed_pose_optimization_matches_reference(problems,
                                                         edge_runs):
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.geometry import se3 as jse3
    from orb_slam_2_ros_tpu.solvers.pose_opt import pose_optimization
    cfg, pts, obs_uv, obs_ur, octv = problems["pose"]
    q0, t0 = jse3.identity()
    q, t, inl, n_in = pose_optimization(
        q0, t0, jnp.asarray(pts), jnp.asarray(obs_uv), jnp.asarray(obs_ur),
        jnp.asarray(octv), jnp.ones(len(pts), bool), cfg)
    got = edge_runs[2][0]["pose"]
    np.testing.assert_allclose(got["q"], _np(q), atol=1e-4)
    np.testing.assert_allclose(got["t"], _np(t), atol=1e-3)
    np.testing.assert_array_equal(got["inl"], _np(inl))
    assert int(got["n_in"]) == int(n_in)


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_equals_rank_zero(edge_runs, row_runs, n):
    runs = edge_runs[n]
    assert_ranks_equal([{k: r[k] for k in ("ba", "gba", "pose")
                         if k in r} for r in runs])
    if n == 4:
        assert_ranks_equal([{k: {f: v for f, v in r[k].items()
                                 if f not in ("kf", "mp", "mp_group",
                                              "kf_group")}
                             for k in r} for r in row_runs[0]])


def test_mesh_layout_and_groups(edge_runs, row_runs):
    for n, runs in edge_runs.items():
        for r, res in enumerate(runs):
            lay = res["layout"]
            assert (lay["kf"], lay["mp"]) == (0, r)
            assert lay["mp_group"] == list(range(n))
            assert lay["kf_group"] == [r]
            assert lay["session"] == ITEMS[r::n]
    for r, res in enumerate(row_runs[0]):
        a = res["2x2"]
        assert (a["kf"], a["mp"]) == (r // 2, r % 2)
        assert a["mp_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert a["kf_group"] == [r % 2, r % 2 + 2]
        b = res["4x1"]
        assert (b["kf"], b["mp"]) == (r, 0)
        assert b["mp_group"] == [r] and b["kf_group"] == [0, 1, 2, 3]


def test_multihost_without_a_group_is_a_no_op():
    assert not dist.is_initialized()
    assert multihost.initialize() == 0
    assert not dist.is_initialized()
    items = list(range(7))
    assert multihost.local_session_shard(items) == items
    with pytest.raises(ValueError):
        multihost.initialize("127.0.0.1:1", None, None, device="cpu")
    assert not dist.is_initialized()


def test_world_of_one_on_the_cpu():
    m = multihost.global_mesh(device="cpu")
    try:
        assert m.shape == {"kf": 1, "mp": 1}
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert m.device == torch.device("cpu")
        assert multihost.initialize() == 0      # a second call: the rank
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


def test_cuda_mesh_raises_without_nccl_or_card(edge_runs, monkeypatch):
    # a gloo world refuses a cuda mesh
    for res in edge_runs[2]:
        assert "NCCL" in res["cuda_on_gloo"], res["cuda_on_gloo"]
    # no card: the card's backend is refused before any group is made
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        multihost.global_mesh()
    assert not dist.is_initialized()
    # a card without NCCL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.global_mesh(device="cuda")
    assert not dist.is_initialized()
