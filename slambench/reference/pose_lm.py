"""The plain reference of the tracker's pose solver: ORB-SLAM2's
``Optimizer::PoseOptimization`` (``Optimizer.cc:265-509``) written straight
from g2o's semantics, in float64 and with rotation matrices.

One SE(3) vertex, world to camera, and one unary reprojection edge per
matched keypoint: (u, v, u_right) for an edge with a right coordinate
(u_right = u - bf / z), (u, v) otherwise, weighted by
1.2^(-2 octave). Four rounds of at most ten Levenberg-Marquardt
iterations: a Huber kernel (delta^2 7.815 for three components, 5.991 for
two) in the first three rounds, and after every round the edges whose
chi^2 exceeds delta^2, or whose point lies behind the camera, are left
out of the next. An iteration solves (H + lambda diag(H)) xi = -b for a
left update T <- exp(xi) T, xi = [rho, phi]; it is taken when the cost
falls, lambda is multiplied by 0.3 then and by 5 otherwise, and a round
stops early once the step is tiny, the cost falls by less than 1e-5 of
itself, or lambda passes 1e3 without progress (g2o's defaults, as the
port states them).

The solver's inputs are the port's own (the matched points and keypoints
of a frame), so this follows the program one step from its own state; the
frontend and the matcher that made those inputs are checked by themselves.
``dtype=torch.bfloat16`` is the control: the same solver one precision
below the float32 the port's solver states (its 6 x 6 solve in float32,
which Cholesky needs).
"""

from __future__ import annotations

import math

import torch

EPS = 1e-9


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)])])


def _hat(v):
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def se3_exp(xi: torch.Tensor):
    """[rho, phi] -> (R, t): Rodrigues for the rotation, V(phi) rho for the
    translation."""
    rho, phi = xi[:3], xi[3:]
    th = float(torch.linalg.norm(phi.double()))
    K = _hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if th < 1e-5:
        a, b, c = 1.0, 0.5, 1.0 / 6.0
    else:
        a = math.sin(th) / th
        b = (1 - math.cos(th)) / th ** 2
        c = (th - math.sin(th)) / th ** 3
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    return R, V @ rho


def optimize(q0, t0, pts, obs_uv, obs_ur, octave, valid, cam, solver,
             scale_factor: float, dtype=torch.float64):
    """(R, t, inlier): the optimized world-to-camera pose from (q0, t0).
    ``cam`` has fx, fy, cx, cy, bf; ``solver`` pose_rounds, pose_iters,
    huber_mono2, huber_stereo2 (the configuration's fields)."""
    f = lambda x: x.to(dtype)  # noqa: E731
    R, t = f(quat_to_R(q0.double())), f(t0)
    X = f(pts)
    obs = f(torch.cat([obs_uv, obs_ur[:, None]], -1))
    stereo = obs_ur > 0
    inv_s2 = f(torch.pow(torch.tensor(scale_factor, dtype=torch.float64),
                         -2.0 * octave.double()))
    d2 = f(torch.where(stereo, solver["huber_stereo2"],
                       solver["huber_mono2"]))
    delta = torch.sqrt(d2)
    comp = f(torch.stack([torch.ones_like(obs_ur), torch.ones_like(obs_ur),
                          stereo.double()], -1))

    def residual(R, t):
        Xc = X @ R.T + t
        x, y = Xc[:, 0], Xc[:, 1]
        z = torch.clamp(Xc[:, 2], min=EPS)
        iz = 1.0 / z
        u = cam["fx"] * x * iz + cam["cx"]
        v = cam["fy"] * y * iz + cam["cy"]
        e = torch.stack([u, v, u - cam["bf"] * iz], -1) - obs
        chi2 = torch.where(stereo, (e * e).sum(-1), (e[:, :2] ** 2).sum(-1)) * inv_s2
        return Xc, x, y, z, iz, e, chi2

    def system(R, t, mask, kernel):
        _, x, y, z, iz, e, chi2 = residual(R, t)
        iz2 = iz * iz
        A, B = cam["fx"] * iz, -cam["fx"] * x * iz2
        C, D = cam["fy"] * iz, -cam["fy"] * y * iz2
        F = B + cam["bf"] * iz2
        zero = torch.zeros_like(z)
        J = torch.stack([
            torch.stack([A, zero, B, B * y, A * z - B * x, -A * y], -1),
            torch.stack([zero, C, D, -C * z + D * y, -D * x, C * x], -1),
            torch.stack([A, zero, F, F * y, A * z - F * x, -A * y], -1)], 1)
        live = mask & (z > EPS)
        sq = torch.sqrt(torch.clamp(chi2, min=EPS))
        w_rob = (torch.where(chi2 <= d2, torch.ones_like(chi2), delta / sq)
                 if kernel else torch.ones_like(chi2))
        w = torch.where(live, inv_s2 * w_rob, torch.zeros_like(chi2))
        W = comp * w[:, None]
        H = torch.einsum("nki,nk,nkj->ij", J, W, J)
        b = torch.einsum("nki,nk,nk->i", J, W, e)
        rho = (torch.where(chi2 <= d2, chi2, 2.0 * delta * sq - d2)
               if kernel else chi2)
        return H, b, torch.where(live, rho, torch.zeros_like(rho)).sum()

    inlier = valid.clone()
    for rnd in range(solver["pose_rounds"]):
        kernel = rnd < solver["pose_rounds"] - 1
        H, b, err = system(R, t, inlier, kernel)
        lam = 1e-4
        for _ in range(solver["pose_iters"]):
            Hd = (H + lam * torch.diag(torch.diagonal(H))).to(torch.float64) \
                + 1e-9 * torch.eye(6, dtype=torch.float64, device=H.device)
            L, info = torch.linalg.cholesky_ex(Hd.float() if dtype != torch.float64 else Hd)
            if int(info) != 0:
                xi = None
            else:
                xi = -torch.cholesky_solve(b.to(L.dtype)[:, None], L)[:, 0]
                xi = xi.to(dtype)
            improved = False
            if xi is not None and bool(torch.isfinite(xi).all()):
                dR, dt = se3_exp(xi)
                R2, t2 = dR @ R, dR @ t + dt
                H2, b2, err2 = system(R2, t2, inlier, kernel)
                improved = bool(err2 < err)
            lam_new = min(max(lam * 0.3 if improved else lam * 5.0, 1e-9), 1e6)
            step2 = float((xi.double() ** 2).sum()) if xi is not None else float("nan")
            if improved:
                converged = step2 < 1e-8 or float(err - err2) < 1e-5 * float(err)
                R, t, H, b, err = R2, t2, H2, b2, err2
            else:
                converged = step2 < 1e-8 or lam_new > 1e3
            lam = lam_new
            if converged:
                break
        _, _, _, z, _, _, chi2 = residual(R, t)
        inlier = valid & (chi2 <= d2) & (z > EPS)
    return R.double(), t.double(), inlier
