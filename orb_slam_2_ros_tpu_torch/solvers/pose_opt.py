"""Pose-only optimization: one SE3 vertex, unary reprojection edges.

Port of ``orb_slam_2_ros_tpu/solvers/pose_opt.py`` (``Optimizer::
PoseOptimization``, ``Optimizer.cc:265-509``): 4 rounds of 10 LM
iterations; Huber kernel in the first 3 rounds; chi2 reclassification after
each round; invSigma2 = 1.2^(-2*octave); RGB-D edges are 3-dof (u, v, uR),
mono edges drop the uR component.

The reference leaves each round early through ``lax.while_loop``. Here each
round runs all its iterations, and a device-side ``done`` flag freezes
q, t, lambda, err, H and b once the exit test fires: the same result with
no host synchronisation per iteration.

The iterations launched after their round's ``done`` flag had fired do no
work. Inside ``done_flags()`` each solve appends its flags, the ``done``
flag at the start of every iteration of every round, as one (rounds x
iterations,) bool tensor on the device: their sum is the solve's idle
iterations, counted without a host read.

On the card the solve is one CUDA graph replay. The solve reads nothing
back to the host and its shapes are fixed by its inputs, so
``pose_optimization`` captures the eager body (``_pose_optimization_eager``)
once per key (input shapes, dtypes and devices, and the configuration
values the kernels bake in) over static input buffers, and every later call
copies its inputs in, replays the graph and returns clones of the outputs:
the same kernels, in the same order, on the same values as the eager solve,
for one host launch instead of thousands. CPU tensors, a ``torch.func``
transform (relocalization's vmapped solves) and a stream that is already
capturing take the eager body. The counters ``pose_lm.graph_captures`` and
``pose_lm.graph_replays`` say how often each happens.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from contextvars import ContextVar

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import se3
from orb_slam_2_ros_tpu_torch.ops.linalg import solve_spd
from orb_slam_2_ros_tpu_torch.pipeline.metrics import count

_EPS = 1e-9
_DONE_FLAGS: ContextVar = ContextVar("pose_lm_done_flags", default=None)


@contextlib.contextmanager
def done_flags():
    """Collect the ``done`` flags of the solves run inside: yields a list
    that gets one (rounds x iterations,) bool tensor per solve."""
    flags = []
    token = _DONE_FLAGS.set(flags)
    try:
        yield flags
    finally:
        _DONE_FLAGS.reset(token)


def _residual_jacobian(q, t, pts, obs, cfg: SlamConfig):
    """Per-edge error e = pred - obs (M, 3) and J = de/dxi (M, 3, 6) for the
    left-multiplied update T <- exp(xi) * T, xi = [rho, phi] (g2o's
    EdgeStereoSE3ProjectXYZOnlyPose linearizeOplus)."""
    cam = cfg.camera
    xc = se3.apply(q, t, pts)
    x, y = xc[:, 0], xc[:, 1]
    z = torch.clamp(xc[:, 2], min=_EPS)
    iz = 1.0 / z
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e = torch.stack([u, v, ur], dim=-1) - obs

    A = cam.fx * iz                 # du/dx
    B = -cam.fx * x * iz2           # du/dz
    C = cam.fy * iz                 # dv/dy
    D = -cam.fy * y * iz2           # dv/dz
    F = B + cam.bf * iz2            # dur/dz
    zros = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([A, zros, B, B * y, A * z - B * x, -A * y], -1),
        torch.stack([zros, C, D, -C * z + D * y, -D * x, C * x], -1),
        torch.stack([A, zros, F, F * y, A * z - F * x, -A * y], -1),
    ], dim=1)                       # (M, 3, 6)
    return e, J, z


def _edge_chi2(e, is_stereo, inv_sigma2):
    e2_mono = e[:, 0] ** 2 + e[:, 1] ** 2
    e2_stereo = e2_mono + e[:, 2] ** 2
    return torch.where(is_stereo, e2_stereo, e2_mono) * inv_sigma2


def pose_optimization(q0, t0, pts, obs_uv, obs_ur, octave, valid,
                      cfg: SlamConfig):
    """Optimize a world-to-camera pose against fixed 3D points.

    pts (M, 3); obs_uv (M, 2); obs_ur (M,) (-1 = mono edge); octave (M,)
    int32; valid (M,) bool. Returns (q, t, inlier (M,) bool, n_inliers).
    On the card, a replay of the eager solve's CUDA graph (see the module's
    doc); elsewhere the eager solve itself."""
    args = (q0, t0, pts, obs_uv, obs_ur, octave, valid)
    if not _graphable(args):
        return _pose_optimization_eager(*args, cfg)
    key = _graph_key(args, cfg)
    solve = _GRAPHS.get(key)
    if solve is None:
        if len(_GRAPHS) >= _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        # the pool of a live graph; a new one once none lives, since a pool
        # is released with its last graph
        pool = next(iter(_GRAPHS.values())).graph.pool() if _GRAPHS else None
        solve = _GRAPHS[key] = _GraphSolve(args, cfg, pool)
        count("pose_lm.graph_captures", 1)
    else:
        _GRAPHS.move_to_end(key)
    count("pose_lm.graph_replays", 1)
    return solve(args)


# captured solves, least recently used first. They share one memory pool,
# which is sound because their replays never overlap: each is stream-ordered
# after the last, and its outputs are cloned before the next
_GRAPHS: "OrderedDict[tuple, _GraphSolve]" = OrderedDict()
_MAX_GRAPHS = 4
_WARMUP = 3         # eager solves on a side stream before the capture


def _graphable(args) -> bool:
    """The graph path: every input a plain CUDA tensor (no ``torch.func``
    wrapper such as vmap's batched tensor), and no capture under way."""
    return (all(a.is_cuda for a in args)
            and not any(torch._C._functorch.is_functorch_wrapped_tensor(a)
                        for a in args)
            and not torch.cuda.is_current_stream_capturing())


def _graph_key(args, cfg: SlamConfig) -> tuple:
    """What a captured solve bakes in: the inputs' shapes, dtypes and
    devices, and the configuration values its kernels take as scalars."""
    cam, sc = cfg.camera, cfg.solver
    return (tuple((a.shape, a.dtype, a.device) for a in args),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cfg.orb.scale_factor,
            sc.huber_mono2, sc.huber_stereo2, sc.pose_rounds, sc.pose_iters)


class _GraphSolve:
    """One solve captured as a CUDA graph over static input buffers, after
    the ``torch.cuda.graph`` recipe: warm-up on a side stream (cuBLAS and
    cuSOLVER handles, workspaces, lazily loaded kernels), then the capture.
    A call copies its inputs in, replays, and returns clones, so that no
    output is overwritten by the next replay."""

    def __init__(self, args, cfg: SlamConfig, pool=None):
        with torch.cuda.device(args[0].device):
            self.static = [a.clone() for a in args]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            # the warm-up's and the capture's flags stay out of any caller's
            # done_flags(); the capture's are the graph's static flag output
            with done_flags() as flags:
                with torch.cuda.stream(side):
                    for _ in range(_WARMUP):
                        _pose_optimization_eager(*self.static, cfg)
                torch.cuda.current_stream().wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self.out = _pose_optimization_eager(*self.static, cfg)
            self.flags = flags[-1]

    def __call__(self, args):
        for s, a in zip(self.static, args):
            s.copy_(a)
        with torch.cuda.device(self.static[0].device):
            self.graph.replay()
        sink = _DONE_FLAGS.get()
        if sink is not None:
            sink.append(self.flags.clone())
        return tuple(o.clone() for o in self.out)


def _pose_optimization_eager(q0, t0, pts, obs_uv, obs_ur, octave, valid,
                             cfg: SlamConfig):
    """``pose_optimization``'s solve, launched op by op."""
    sc = cfg.solver
    is_stereo = obs_ur > 0
    inv_sigma2 = torch.pow(torch.full_like(obs_ur, cfg.orb.scale_factor),
                           -2.0 * octave.to(torch.float32))
    obs = torch.cat([obs_uv, obs_ur[:, None]], dim=-1)
    delta2 = torch.where(is_stereo, torch.full_like(obs_ur, sc.huber_stereo2),
                         torch.full_like(obs_ur, sc.huber_mono2))
    delta = torch.sqrt(delta2)
    comp_w = torch.stack([torch.ones_like(obs_ur), torch.ones_like(obs_ur),
                          is_stereo.to(torch.float32)], dim=-1)
    eye6 = torch.eye(6, dtype=torch.float32, device=pts.device)

    def weighted_system(q, t, edge_mask, use_kernel):
        e, J, z = _residual_jacobian(q, t, pts, obs, cfg)
        chi2 = _edge_chi2(e, is_stereo, inv_sigma2)
        live = edge_mask & (z > _EPS)
        if use_kernel:
            w_rob = torch.where(chi2 <= delta2, torch.ones_like(chi2),
                                delta / torch.clamp(torch.sqrt(chi2), min=_EPS))
        else:
            w_rob = torch.ones_like(chi2)
        w = torch.where(live, inv_sigma2 * w_rob, torch.zeros_like(chi2))
        Wc = comp_w * w[:, None]
        # S = [J | e] row-augmented: one (7 x 3M) @ (3M x 7) product gives
        # H and b together (full f32: TF32 is off package-wide)
        S = torch.cat([J, e[:, :, None]], dim=-1).reshape(-1, 7)
        G = (S * Wc.reshape(-1, 1)).T @ S
        if use_kernel:
            rho = torch.where(chi2 <= delta2, chi2,
                              2.0 * delta * torch.sqrt(chi2) - delta2)
        else:
            rho = chi2
        err = torch.sum(torch.where(live, rho, torch.zeros_like(rho)))
        return G[:6, :6], G[:6, 6], err

    def lm_round(q, t, edge_mask, use_kernel, n_iters, flags):
        H, b, err = weighted_system(q, t, edge_mask, use_kernel)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=pts.device)
        done = torch.zeros((), dtype=torch.bool, device=pts.device)
        for _ in range(n_iters):
            flags.append(done)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            xi = -solve_spd(Hd, b)
            dq, dt = se3.exp(xi)
            q_new, t_new = se3.compose(dq, dt, q, t)
            H_new, b_new, err_new = weighted_system(q_new, t_new, edge_mask,
                                                    use_kernel)
            improved = torch.all(torch.isfinite(xi)) & (err_new < err)
            take = improved & ~done
            q = torch.where(take, q_new, q)
            t = torch.where(take, t_new, t)
            H = torch.where(take, H_new, H)
            b = torch.where(take, b_new, b)
            lam_new = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                                  1e-9, 1e6)
            converged = ((torch.sum(xi * xi) < 1e-8)
                         | (improved & (err - err_new < 1e-5 * err))
                         | (~improved & (lam_new > 1e3)))
            lam = torch.where(done, lam, lam_new)
            err = torch.where(take, err_new, err)
            done = done | converged
        return q, t

    q, t = q0, t0
    inlier = valid
    flags = []
    for rnd in range(sc.pose_rounds):
        use_kernel = rnd < sc.pose_rounds - 1   # kernel dropped in last round
        q, t = lm_round(q, t, inlier, use_kernel, sc.pose_iters, flags)
        e, _, z = _residual_jacobian(q, t, pts, obs, cfg)
        chi2 = _edge_chi2(e, is_stereo, inv_sigma2)
        inlier = valid & (chi2 <= delta2) & (z > _EPS)
    sink = _DONE_FLAGS.get()
    if sink is not None and flags:
        sink.append(torch.stack(flags))
    return q, t, inlier, torch.sum(inlier, dtype=torch.int32)
