"""Port parity of ``solvers/pose_graph``: the essential graph on a drifted
ring with a loop edge, against the reference on the same numpy inputs.

After the 20 iterations the poses agree within 1e-3 and the per-iteration
``chi2s`` within 1e-3 relative (1e-4 absolute once the graph has relaxed
below that); a fixed vertex stays where it was; an edge of weight zero
changes nothing; ``correct_points`` within 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import torch

from orb_slam_2_ros_tpu.config import SlamConfig as JSlamConfig
from orb_slam_2_ros_tpu.geometry import sim3 as jsim3
from orb_slam_2_ros_tpu.solvers import pose_graph as jpg
from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.solvers import pose_graph as tpg

# Several test processes share the machine's cores; PyTorch's default of
# one thread per core in each of them makes the many small operations of
# these tests spin against each other (a 16 s fixture took 540 s in a run
# with six workers). Two threads per process keep them out of each other's way.
torch.set_num_threads(2)

K = 16
N = 12          # vertices in use; the rest are fixed padding


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _ring(seed=0, extra_zero_edge=False):
    """A ring of N vertices whose odometry edges are exact and whose
    current estimates drift; one loop edge N-1 -> 0 measured from the
    truth, and a few duplicate edges (two edges between one vertex pair)."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(N) / N
    xi_true = np.stack([3 * np.sin(th), 0.1 * np.arange(N), 3 * np.cos(th),
                        0 * th, th, 0 * th, 0 * th], -1).astype(np.float32)
    q_true, t_true, s_true = jsim3.exp(jnp.asarray(xi_true))
    drift = np.cumsum(rng.normal(0, 0.01, (N, 7)), 0).astype(np.float32)
    drift[:, 6] *= 0.2
    drift[0] = 0
    dq, dt, ds = jsim3.exp(jnp.asarray(drift))
    q, t, s = jsim3.compose(dq, dt, ds, q_true, t_true, s_true)

    def pad(x, fill):
        out = np.tile(np.asarray(fill, np.float32), (K, 1))
        out[:N] = np.asarray(x)
        return out

    q, t, s = pad(q, [1, 0, 0, 0]), pad(t, [0, 0, 0]), pad(s, [1])
    qt, tt, st = (pad(q_true, [1, 0, 0, 0]), pad(t_true, [0, 0, 0]),
                  pad(s_true, [1]))
    ei = list(range(N - 1)) + [N - 1, 2, 2, 5]
    ej = list(range(1, N)) + [0, 7, 7, 9]
    w = [1.0] * (N - 1) + [2.0, 1.0, 0.5, 1.0]
    if extra_zero_edge:
        ei.append(1)
        ej.append(6)
        w.append(0.0)
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)
    # measurements: chain edges from the drifted estimates' own odometry,
    # the loop and shortcut edges from the truth
    def rel(qa, ta, sa, i, j):
        return jsim3.compose(qa[j], ta[j], sa[j],
                             *jsim3.inverse(qa[i], ta[i], sa[i]))
    rq, rt, rs = rel(jnp.asarray(q), jnp.asarray(t), jnp.asarray(s), ei, ej)
    tq, ttt, ts = rel(jnp.asarray(qt), jnp.asarray(tt), jnp.asarray(st),
                      ei, ej)
    from_truth = np.arange(len(ei)) >= N - 1
    rq = np.where(from_truth[:, None], tq, rq)
    rt = np.where(from_truth[:, None], ttt, rt)
    rs = np.where(from_truth[:, None], ts, rs)
    if extra_zero_edge:             # a wild measurement that must not count
        rt[-1] += 5.0
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[N:] = True
    return dict(q=q, t=t, s=s, ei=ei, ej=ej, rq=np.asarray(rq),
                rt=np.asarray(rt), rs=np.asarray(rs),
                w=np.asarray(w, np.float32), fixed=fixed), (qt, tt, st)


def _run_both(g, iters=None):
    order = ("q", "t", "s", "ei", "ej", "rq", "rt", "rs", "w", "fixed")
    jout = jpg.optimize_essential_graph(
        *[jnp.asarray(g[k]) for k in order], JSlamConfig(), iters=iters)
    tout = tpg.optimize_essential_graph(
        *[_t(g[k]) for k in order], SlamConfig(), iters=iters)
    return jout, tout


def test_essential_graph_matches_reference():
    g, truth = _ring()
    jout, tout = _run_both(g)
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    jc, tc = np.asarray(jout[3]), tout[3].numpy()
    assert tc.shape == jc.shape == (20,)
    np.testing.assert_allclose(tc, jc, rtol=1e-3, atol=1e-4)
    assert tc[-1] < 0.1 * tc[0]
    # the fixed vertex and the padding did not move
    np.testing.assert_array_equal(tout[0][0].numpy(), g["q"][0])
    np.testing.assert_array_equal(tout[1][N:].numpy(), g["t"][N:])
    # and the loop edge pulled the far side toward the truth
    before = np.linalg.norm(g["t"][:N] - truth[1][:N], axis=-1).max()
    after = np.linalg.norm(tout[1][:N].numpy() - truth[1][:N], axis=-1).max()
    assert after < before


def test_zero_weight_edge_does_nothing():
    g, _ = _ring()
    g0, _ = _ring(extra_zero_edge=True)
    _, a = _run_both(g, iters=5)
    _, b = _run_both(g0, iters=5)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def test_edge_residual_and_jacobian_shapes():
    g, _ = _ring()
    ei, ej = g["ei"].astype(np.int64), g["ej"].astype(np.int64)
    args = [g["q"][ei], g["t"][ei], g["s"][ei], g["q"][ej], g["t"][ej],
            g["s"][ej], g["rq"], g["rt"], g["rs"]]
    import jax
    jr = jax.vmap(jpg.edge_residual)(*map(jnp.asarray, args))
    tr = tpg.edge_residual(*map(_t, args))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    z7 = torch.zeros(7)
    Ji, Jj = tpg._edge_jacobians(z7, z7, *map(_t, args))
    assert Ji.shape == Jj.shape == (len(ei), 7, 7)
    jJi, jJj = jax.vmap(jax.jacfwd(jpg._residual_local, argnums=(0, 1)),
                        in_axes=(None, None) + (0,) * 9)(
        jnp.zeros(7), jnp.zeros(7), *map(jnp.asarray, args))
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), atol=1e-4)


def test_correct_points():
    g, truth = _ring()
    rng = np.random.default_rng(1)
    M = 50
    pos = rng.normal(0, 2, (M, 3)).astype(np.float32)
    owner = rng.integers(0, N, M).astype(np.int32)
    mask = rng.uniform(size=M) > 0.3
    jp = jpg.correct_points(jnp.asarray(pos), jnp.asarray(owner),
                            *map(jnp.asarray, (g["q"], g["t"], g["s"])),
                            *map(jnp.asarray, truth), jnp.asarray(mask))
    tp = tpg.correct_points(_t(pos), _t(owner),
                            *map(_t, (g["q"], g["t"], g["s"])),
                            *map(_t, truth), _t(mask))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(tp.numpy()[~mask], pos[~mask])
