"""Bundle adjustment over a mesh of process groups.

Port of ``orb_slam_2_ros_tpu/parallel/dist_ba.py``. Where the reference
wraps a solver in ``shard_map``, each rank here cuts its own block of the
sharded inputs (``mesh.shard_rows``), runs the solver with the axis's
process group (every edge or row sum is reduced over it, ``solvers/ba.py``)
and gathers the outputs that are sharded.

- ``distributed_bundle_adjustment``: the edge list over the ``mp`` axis,
  camera and point states the same on every rank.
- ``distributed_gba_chunk``: one chunk of the loop closer's global BA with
  the point pool as well as the edges split over the ``mp`` axis
  (``shard_gba_state``), so that both scale with the mesh and only the
  camera system (6K floats) is held whole by every rank.
- ``distributed_windowed_ba``: the local BA's observation-table rows over
  the ``kf`` axis.
"""

from __future__ import annotations

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.parallel.mesh import (Mesh, gather_rows,
                                                    pad_rows, shard_rows)
from orb_slam_2_ros_tpu_torch.solvers import ba


def pad_problem(prob: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    """Pad the edge axis to a multiple of the shard count: padding edges
    are invalid, name camera and point 0, and contribute zeros."""
    return ba.BAProblem(*(pad_rows(x, n_shards) for x in prob))


def _shard_problem(prob: ba.BAProblem, mesh: Mesh, axis: str):
    return ba.BAProblem(*(shard_rows(x, mesh, axis)
                          for x in pad_problem(prob, mesh.shape[axis])))


def shard_gba_state(mesh: Mesh, st: ba.GBAState,
                    cfg: SlamConfig) -> ba.GBAState:
    """This rank's part of a whole-map ``GBAState``: its share of the
    (padded) edges and its block of the point pool over the ``mp`` axis.
    The pool's size (``cfg.map.max_mps`` on the loop closer's path) must
    divide by the axis size."""
    axis = cfg.mesh.mp_axis
    n = mesh.shape[axis]
    M = st.pos.shape[0]
    if M % n:
        raise ValueError(f"the point pool ({M} rows) must divide over the "
                         f"{n} shards of the {axis} axis")
    return st._replace(prob=_shard_problem(st.prob, mesh, axis),
                       pos=shard_rows(st.pos, mesh, axis),
                       mp_free=shard_rows(st.mp_free, mesh, axis))


def gather_gba_points(mesh: Mesh, st: ba.GBAState,
                      cfg: SlamConfig) -> ba.GBAState:
    """The state with the whole point pool (``pos``, ``mp_free``) gathered
    from the ranks' blocks; the edges stay as they are."""
    g = mesh.group(cfg.mesh.mp_axis)
    return st._replace(pos=gather_rows(st.pos, g),
                       mp_free=gather_rows(st.mp_free, g))


def distributed_gba_chunk(mesh: Mesh, st: ba.GBAState, cfg: SlamConfig,
                          n_iters: int, cg_iters: int = 100) -> ba.GBAState:
    """One global-BA chunk (``n_iters`` LM iterations, no robust kernel)
    on a state cut by ``shard_gba_state``: per-edge point reads ride a
    gather of the (M, 3) position table, point-side sums come back reduced
    to the owned rows, and the camera system is reduced whole. Returns the
    state in the same layout."""
    axis = cfg.mesh.mp_axis
    return ba.gba_chunk(st, cfg, n_iters=n_iters, cg_iters=cg_iters,
                        robust=False, group=mesh.group(axis),
                        shard_points=True, n_shards=mesh.shape[axis])


def distributed_bundle_adjustment(mesh: Mesh, q, t, cam_free, pos, mp_free,
                                  prob: ba.BAProblem, cfg: SlamConfig,
                                  phases=(5, 10), cg_iters: int = 20):
    """Edge-parallel Schur-LM BA: the edges split over the ``mp`` axis,
    every reduction summed over it. Returns (q, t, pos, edge_inlier) with
    the edge mask in the PADDED layout (``prob.valid``'s length trims
    it)."""
    axis = cfg.mesh.mp_axis
    q, t, pos, inl = ba.bundle_adjustment(
        q, t, cam_free, pos, mp_free, _shard_problem(prob, mesh, axis), cfg,
        phases=phases, cg_iters=cg_iters, group=mesh.group(axis))
    return q, t, pos, gather_rows(inl, mesh.group(axis))


def distributed_windowed_ba(mesh: Mesh, kf_q, kf_t, window_rows, kf_uv,
                            kf_ur, kf_octave, kf_mp, kp_valid, mp_pos,
                            mp_free, cfg: SlamConfig, phases=(5, 10),
                            stats=None):
    """The windowed local BA with the observation table's rows split over
    the ``kf`` axis: each rank evaluates its rows' residuals and
    Jacobians, the camera system and the compact landmark accumulators are
    summed over the axis, and the small dense solve runs on every rank.
    The row count (2 * window on the mapper's path) must divide by the
    axis size. Returns what ``ba.windowed_bundle_adjustment`` returns, the
    row outputs gathered whole."""
    axis = cfg.mesh.kf_axis
    n = mesh.shape[axis]
    g = mesh.group(axis)
    rows = [shard_rows(x, mesh, axis)
            for x in (kf_q, kf_t, kf_uv, kf_ur, kf_octave, kf_mp, kp_valid)]
    q, t, uv, ur, octv, mp, kpv = rows
    q, t, pos, inl, loose, n_free = ba.windowed_bundle_adjustment(
        q, t, window_rows, uv, ur, octv, mp, kpv, mp_pos, mp_free, cfg,
        phases=phases, stats=stats, group=g, n_row_shards=n)
    return (gather_rows(q, g), gather_rows(t, g), pos, gather_rows(inl, g),
            gather_rows(loose, g), n_free)
