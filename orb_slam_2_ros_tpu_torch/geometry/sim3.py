"""Sim(3) similarity transforms: (quaternion, translation, scale).

Port of ``orb_slam_2_ros_tpu/geometry/sim3.py`` (g2o's ``Sim3`` type), used
by loop closing and the essential-graph optimisation. Layout: ``q`` (..., 4)
wxyz, ``t`` (..., 3), ``s`` (..., 1) scale. ``apply(q, t, s, x) = s * R @ x
+ t``. Every function broadcasts over leading axes and is written with
out-of-place operations only, so ``torch.func`` transforms go through it.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.geometry import se3

_EPS = 1e-8


def identity(shape=(), device=None):
    shape = tuple(shape)
    return (se3.quat_identity(shape, device),
            torch.zeros(shape + (3,), dtype=torch.float32, device=device),
            torch.ones(shape + (1,), dtype=torch.float32, device=device))


def from_se3(q, t):
    return q, t, torch.ones_like(t[..., :1])


def to_se3(q, t, s):
    """Sim3 -> SE3 with t/s (essential-graph SE3 recovery,
    ``Optimizer.cc:1134-1141``)."""
    return q, t / torch.clamp(s, min=_EPS)


def apply(q, t, s, x):
    return s * se3.quat_rotate(q, x) + t


def compose(qa, ta, sa, qb, tb, sb):
    """(Sa * Sb)(x) = Sa(Sb(x))."""
    q = se3.quat_normalize(se3.quat_mul(qa, qb))
    s = sa * sb
    t = sa * se3.quat_rotate(qa, tb) + ta
    return q, t, s


def inverse(q, t, s):
    qi = se3.quat_conj(q)
    si = 1.0 / torch.clamp(s, min=_EPS)
    ti = -si * se3.quat_rotate(qi, t)
    return qi, ti, si


def exp(xi):
    """sim(3) (..., 7) = [rho(3), phi(3), sigma(1)] -> (q, t, s).

    Closed-form W matrix (g2o ``sim3.h`` constructor from a 7-vector), with
    the reference's series fallbacks near zero angle and zero log-scale."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = se3.quat_exp(phi)
    s = torch.exp(sigma)
    theta, _, _ = se3._safe_norm(phi, 1e-7)

    # W = A*I + B*[phi]x + C*[phi]x^2 with the standard sim3 coefficients
    sig2 = sigma * sigma
    th2 = theta * theta
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5
    one = torch.ones_like(sigma)

    # A = (s - 1)/sigma  (-> 1 as sigma -> 0)
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = torch.clamp(sig2 + th2, min=_EPS)
    a_coef = (s * sin_t) * sigma + (1.0 - s * cos_t) * theta
    B_gen = (a_coef / torch.clamp(theta, min=_EPS)) / denom
    C_gen = (A - (s * cos_t - 1.0) * sigma / denom
             - (s * sin_t) * theta / denom) / torch.clamp(th2, min=_EPS)
    # sigma -> 0 limits (pure SE3 V matrix)
    B_se3 = torch.where(small_th, 0.5 - th2 / 24.0,
                        (1.0 - cos_t) / torch.clamp(th2, min=_EPS))
    C_se3 = torch.where(small_th, 1.0 / 6.0 - th2 / 120.0,
                        (theta - sin_t) / torch.clamp(th2 * theta, min=_EPS))
    # theta -> 0, sigma != 0 limits
    B_sig = torch.where(small_sig, 0.5 + sigma / 6.0,
                        (sigma * s - s + 1.0)
                        / torch.where(small_sig, one, sig2))
    C_sig = torch.where(
        small_sig, 1.0 / 6.0 + sigma / 24.0,
        (0.5 * sig2 * s + s - 1.0 - sigma * s)
        / torch.where(small_sig, one,
                      sig2 * torch.clamp(torch.abs(sigma), min=_EPS)
                      * torch.sign(sigma + _EPS)))
    B = torch.where(small_th, torch.where(small_sig, B_se3, B_sig), B_gen)
    C = torch.where(small_th, torch.where(small_sig, C_se3, C_sig), C_gen)

    cross1 = se3._cross(phi, rho)
    cross2 = se3._cross(phi, cross1)
    t = A * rho + B * cross1 + C * cross2
    return q, t, s


def log(q, t, s):
    """Inverse of ``exp``: W is rebuilt column by column from ``exp``'s
    linear map in rho and W rho = t is solved."""
    phi = se3.quat_log(q)
    sigma = torch.log(torch.clamp(s, min=_EPS))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)

    def col(e):
        xi = torch.cat([e.expand_as(phi), phi, sigma], dim=-1)
        return exp(xi)[1]

    c0, c1, c2 = col(eye[0]), col(eye[1]), col(eye[2])     # columns of W
    # Cramer's rule by triple products: det W is close to exp(sigma)-scaled
    # unity, and elementwise operations neither wait for the device nor
    # launch a batched factorisation per tangent of a forward-mode Jacobian
    c12 = se3._cross(c1, c2)
    det = torch.sum(c0 * c12, dim=-1, keepdim=True)
    rho = torch.cat([
        torch.sum(t * c12, dim=-1, keepdim=True),
        torch.sum(c0 * se3._cross(t, c2), dim=-1, keepdim=True),
        torch.sum(c0 * se3._cross(c1, t), dim=-1, keepdim=True)], dim=-1) / det
    return torch.cat([rho, phi, sigma], dim=-1)
