"""The port's sharded solvers against the reference's own sharded ones.

The reference's ``dist_ba.distributed_gba_chunk`` and
``distributed_windowed_ba`` run on its virtual 8-device CPU mesh
(``tests/conftest.py``), whose ``shard_map`` compile takes minutes, so this
file is marked ``slow`` and stays out of the quick pass; the quick pass
holds the port's sharded functions to the reference's single-device ones
(``tests/test_torch_dist_ba.py``).

- The GBA chunk with the point pool and the edges split (reference: 8
  shards; port: 2 and 4 gloo ranks) on ``make_ba_problem(6, 120)``, two
  chunks of 5 iterations: q 2e-4, t 2e-3, pos 2e-4, ``err`` 1e-5
  relative.
- The windowed BA with its rows split (reference: ``kf`` x ``mp`` = 4 x 2;
  port: 2 x 2 and 4 x 1) on ``make_ba_problem(8, 150)``: q 2e-4, t 2e-3,
  equal free counts, the inlier masks equal on more than 99% of the edges
  (``tests/test_dist_ba.py:121-128``).
"""

import numpy as np
import pytest

from test_torch_dist_ba import (GBA_CHUNKS, GBA_ITERS, ITEMS, ROW_LAYOUTS,
                                WINDOW_ROWS, _ba_problem, _for_ranks,
                                _job_edges, _job_rows, _table, run_ranks)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def reference_mesh():
    import jax
    from orb_slam_2_ros_tpu.parallel.mesh import make_mesh
    return lambda n_kf, n_mp: make_mesh(n_kf=n_kf, n_mp=n_mp,
                                        devices=jax.devices("cpu")[:8])


@pytest.mark.parametrize("n_mp", [2, 4])
def test_sharded_gba_chunk_matches_the_references(reference_mesh, n_mp,
                                                  tmp_path):
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.parallel import dist_ba as jdist
    from orb_slam_2_ros_tpu.solvers import ba as jba
    pr = _ba_problem(6, 120)
    M = pr["pos0"].shape[0]
    prob = jdist.pad_problem(jba.BAProblem(
        **{f: jnp.asarray(v) for f, v in pr["prob"].items()}), 8)
    jst = jba.gba_init(jnp.asarray(pr["q0"]), jnp.asarray(pr["t0"]),
                       jnp.asarray(pr["cam_free"]), jnp.asarray(pr["pos0"]),
                       jnp.ones(M, bool), prob, len(pr["q0"]), M, pr["cfg"],
                       robust=False)
    mesh = reference_mesh(1, 8)
    runs = run_ranks(_job_edges, n_mp, (n_mp, _for_ranks(pr),
                                        _for_ranks(pr), None, ITEMS),
                     tmp_path)
    for c in range(GBA_CHUNKS):
        jst = jdist.distributed_gba_chunk(mesh, jst, pr["cfg"],
                                          n_iters=GBA_ITERS)
        got = runs[0]["gba"][f"chunk{c}"]
        np.testing.assert_allclose(got["q"], np.asarray(jst.q), atol=2e-4)
        np.testing.assert_allclose(got["t"], np.asarray(jst.t), atol=2e-3)
        np.testing.assert_allclose(got["pos"], np.asarray(jst.pos),
                                   atol=2e-4)
        np.testing.assert_allclose(float(got["err"]), float(jst.err),
                                   rtol=1e-5)


def test_row_sharded_windowed_ba_matches_the_references(reference_mesh,
                                                        tmp_path):
    import jax.numpy as jnp
    from orb_slam_2_ros_tpu.parallel import dist_ba as jdist
    pr = _ba_problem(8, 150)
    table = _table(pr, 8, 150)
    kf_uv, kf_ur, kf_oct, kf_mp, kp_valid = (jnp.asarray(a) for a in table)
    M = pr["pos0"].shape[0]
    q1, t1, _, inl1, _, nf1 = jdist.distributed_windowed_ba(
        reference_mesh(4, 2), jnp.asarray(pr["q0"]), jnp.asarray(pr["t0"]),
        jnp.asarray(WINDOW_ROWS), kf_uv, kf_ur, kf_oct, kf_mp, kp_valid,
        jnp.asarray(pr["pos0"]), jnp.ones(M, bool), pr["cfg"])
    res = run_ranks(_job_rows, 4, (ROW_LAYOUTS, _for_ranks(pr), table),
                    tmp_path)
    for n_kf, n_mp in ROW_LAYOUTS:
        got = res[0][f"{n_kf}x{n_mp}"]
        np.testing.assert_allclose(got["q"], np.asarray(q1), atol=2e-4)
        np.testing.assert_allclose(got["t"], np.asarray(t1), atol=2e-3)
        assert int(got["n_free"]) == int(nf1)
        assert (got["inl"] == np.asarray(inl1)).mean() > 0.99
