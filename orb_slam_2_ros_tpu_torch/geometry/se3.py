"""SE(3) rigid transforms as (quaternion, translation) tensors.

Port of ``orb_slam_2_ros_tpu/geometry/se3.py``. A pose is a pair ``q``
(..., 4) unit quaternion in (w, x, y, z) order and ``t`` (..., 3); every
function broadcasts over leading axes. Poses are world-to-camera ``Tcw``,
so ``apply(q, t, x_world) -> x_camera``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------- quaternions

def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonical sign: w >= 0 (keeps log well-behaved near identity)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> wxyz quaternion; branchless Shepperd."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=_EPS)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = torch.stack(
        [
            torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                         (m10 - m01) / (4 * w0)], -1),
            torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                         (m02 + m20) / (4 * x1)], -1),
            torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                         (m12 + m21) / (4 * y2)], -1),
            torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                         (m12 + m21) / (4 * z3), z3], -1),
        ],
        dim=-2,
    )  # (..., 4cand, 4)
    pivot = torch.stack([tr, m00, m11, m22], -1)
    idx = torch.argmax(pivot, dim=-1)
    gather_idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cand, -2, gather_idx)[..., 0, :]
    return quat_normalize(q)


def _safe_norm(v, small_th):
    """(norm, norm2, small), with the small branch evaluated from norm2
    only (the reference keeps the same form for differentiability)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < small_th * small_th
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return torch.where(small, torch.zeros_like(n), n), n2, small


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) vector (..., 3) -> unit quaternion."""
    theta, th2, small = _safe_norm(phi, 1e-6)
    half = 0.5 * theta
    k = torch.where(small, 0.5 - th2 / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=_EPS))
    w = torch.where(small, 1.0 - th2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> so(3) vector (..., 3)."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    n, _, small = _safe_norm(v, 1e-6)
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                    theta / torch.clamp(n, min=_EPS))
    return k * v


# ----------------------------------------------------------------- SE(3) ops

def identity(shape=(), device=None):
    return (quat_identity(shape, device),
            torch.zeros(tuple(shape) + (3,), dtype=torch.float32,
                        device=device))


def apply(q: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x_cam = R @ x_world + t."""
    return quat_rotate(q, x) + t


def compose(qa, ta, qb, tb):
    """(Ta * Tb): apply Tb first, then Ta."""
    return quat_normalize(quat_mul(qa, qb)), quat_rotate(qa, tb) + ta


def inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def relative(qa, ta, qb, tb):
    """T_ab = Ta * Tb^-1 (maps frame-b camera coords to frame-a)."""
    qbi, tbi = inverse(qb, tb)
    return compose(qa, ta, qbi, tbi)


def exp(xi: torch.Tensor):
    """se(3) twist (..., 6) = [rho(3), phi(3)] -> (q, t) with the V matrix;
    [translation, rotation] ordering as g2o's SE3Quat::exp."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = quat_exp(phi)
    theta, th2, small = _safe_norm(phi, 1e-5)
    a = torch.where(small, 0.5 - th2 / 24.0,
                    (1 - torch.cos(theta)) / torch.clamp(th2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(th2 * theta, min=_EPS))
    cross1 = _cross(phi, rho)
    cross2 = _cross(phi, cross1)
    t = rho + a * cross1 + b * cross2
    return q, t


def log(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = quat_log(q)
    theta, th2, small = _safe_norm(phi, 1e-5)
    a = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - 0.5 * theta * torch.cos(0.5 * theta)
                     / torch.clamp(torch.sin(0.5 * theta), min=_EPS))
                    / torch.clamp(th2, min=_EPS))
    cross1 = _cross(phi, t)
    cross2 = _cross(phi, cross1)
    rho = t - 0.5 * cross1 + a * cross2
    return torch.cat([rho, phi], dim=-1)


def to_matrix(q, t):
    """(q, t) -> homogeneous (..., 4, 4)."""
    R = quat_to_matrix(q)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=t.dtype,
                          device=t.device).expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(T):
    return quat_from_matrix(T[..., :3, :3]), T[..., :3, 3]


def camera_center(q, t):
    """Ow = -R^T t (KeyFrame::GetCameraCenter)."""
    return -quat_rotate(quat_conj(q), t)
