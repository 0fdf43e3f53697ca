"""EPnP + RANSAC: camera pose from 3D-2D correspondences (relocalization).

Port of ``orb_slam_2_ros_tpu/solvers/pnp.py`` (``PnPsolver``): control points
by PCA (``PnPsolver.cc:376-410``), barycentric coordinates (``:412-435``),
the 2n x 12 M matrix, the three beta approximations each polished by
Gauss-Newton on the control-point distance equations (``:668-859``), Horn's
absolute orientation for R, t (``:570-628``), and the case with the least
reprojection error (``compute_pose``, ``:440-468``).

Every function takes leading batch axes: RANSAC draws all its hypotheses up
front and solves them as one batch, and relocalization adds the candidate
keyframes as a further leading axis. A degenerate hypothesis (duplicate
points from the draw with replacement) gives a singular system; the solves
are ``torch.linalg.solve_ex`` with no error check, non-finite inputs to an
``eigh`` are replaced by the identity, and the hypothesis's pose is made
NaN with error ``inf``: it loses instead of raising or poisoning the batch,
and nothing waits for the device.
"""

from __future__ import annotations

import torch

from orb_slam_2_ros_tpu_torch.config import SlamConfig
from orb_slam_2_ros_tpu_torch.geometry import camera, se3
from orb_slam_2_ros_tpu_torch.ops.linalg import min_subspace
from orb_slam_2_ros_tpu_torch.ops.ties import first_argmax

MIN_SET = 6   # points per hypothesis (4 is minimal; 6 conditions the eig)
GN_ITERS = 5  # Gauss-Newton iterations on the betas (PnPsolver.cc:700)


def _all_finite(x: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Whether every entry of the trailing ``n_dims`` axes is finite."""
    ok = torch.isfinite(x)
    for _ in range(n_dims):
        ok = ok.all(dim=-1)
    return ok


def _eigh_finite(A: torch.Tensor):
    """``torch.linalg.eigh`` of the symmetric A (..., n, n), with a
    non-finite member replaced by the identity (an ``eigh`` of NaN raises
    on the CPU and fails its check on the card). Returns (evals, evecs,
    finite (...,) bool)."""
    ok = _all_finite(A, 2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    evals, evecs = torch.linalg.eigh(torch.where(ok[..., None, None], A, eye))
    return evals, evecs, ok


def _control_points(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4 control points (..., 4, 3): weighted centroid + principal axes
    (``PnPsolver::choose_control_points``)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    c0 = torch.sum(xw * w[..., None], dim=-2) / wsum
    d = (xw - c0[..., None, :]) * w[..., None]
    cov = d.mT @ d / wsum[..., None]
    evals, evecs, _ = _eigh_finite(cov)                  # ascending
    sig = torch.sqrt(torch.clamp(evals, min=1e-12))
    return torch.stack([c0,
                        c0 + sig[..., 2:3] * evecs[..., :, 2],
                        c0 + sig[..., 1:2] * evecs[..., :, 1],
                        c0 + sig[..., 0:1] * evecs[..., :, 0]], dim=-2)


def _barycentric(xw: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """alphas (..., n, 4) with sum 1: xw = alphas @ cws
    (``compute_barycentric_coordinates``). A singular CC gives non-finite
    alphas, as the reference's LU solve does."""
    ones4 = torch.ones_like(cws[..., :1, :1]).expand(
        cws.shape[:-2] + (1, 4))
    CC = torch.cat([cws.mT, ones4], dim=-2)                       # (..., 4, 4)
    X = torch.cat([xw.mT, torch.ones_like(xw[..., :1]).mT], dim=-2)
    return torch.linalg.solve_ex(CC, X)[0].mT


def _lstsq(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-9):
    """Small least squares by regularised normal equations (the reference's
    ``qr_solve`` stand-in, ``PnPsolver.cc:866``). A (..., r, c), b (..., r)."""
    c = A.shape[-1]
    G = A.mT @ A
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(c, dtype=A.dtype, device=A.device)
    G = G + (eps * tr / c)[..., None, None] * eye
    return torch.linalg.solve_ex(G, (A.mT @ b[..., None]))[0][..., 0]


def _horn_rt(xw: torch.Tensor, xc: torch.Tensor, w: torch.Tensor):
    """Absolute orientation world -> camera (``estimate_R_and_t``). Returns
    (q, t); NaN where the input was not finite."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_w = torch.sum(xw * w[..., None], dim=-2) / wsum
    mu_c = torch.sum(xc * w[..., None], dim=-2) / wsum
    Mtx = ((xc - mu_c[..., None, :]) * w[..., None]).mT @ (
        xw - mu_w[..., None, :])
    Sxx, Sxy, Sxz = Mtx[..., 0, 0], Mtx[..., 0, 1], Mtx[..., 0, 2]
    Syx, Syy, Syz = Mtx[..., 1, 0], Mtx[..., 1, 1], Mtx[..., 1, 2]
    Szx, Szy, Szz = Mtx[..., 2, 0], Mtx[..., 2, 1], Mtx[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, evq, ok = _eigh_finite(N)
    q = evq[..., :, -1]
    q = se3.quat_conj(q * torch.sign(q[..., :1] + 1e-12))   # world->camera
    q = torch.where(ok[..., None], q, torch.full_like(q, float("nan")))
    t = mu_c - se3.quat_rotate(q, mu_w)
    return q, t


# the 6 control-point pairs, and the 10 products b_a b_b (a >= b) in the
# column order [11, 21, 22, 31, 32, 33, 41, 42, 43, 44]
_PAIRS = torch.triu_indices(4, 4, offset=1)
_PROD = torch.tril_indices(4, 4)
_CASE_COLS = ([0, 1, 3, 6], [0, 1, 2], [0, 1, 2, 3, 4])


def epnp(xw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
         K: torch.Tensor):
    """EPnP with the reference's full beta-case search. xw (..., n, 3)
    world points, uv (..., n, 2) pixels, w (..., n) weights / mask, K (3, 3)
    intrinsics. Returns (q, t) world -> camera of the case with least
    reprojection error; NaN where every case failed."""
    dev, f32 = xw.device, xw.dtype
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cws = _control_points(xw, w)                      # (..., 4, 3)
    alphas = _barycentric(xw, cws)                    # (..., n, 4)

    # M rows: for each point 2 rows over the 12 control-point coordinates
    a = alphas * w[..., None]
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(a)
    ru = torch.stack([a * fx, zeros, a * (cx - u)[..., None]], dim=-1)
    rv = torch.stack([zeros, a * fy, a * (cy - v)[..., None]], dim=-1)
    n = xw.shape[-2]
    lead = xw.shape[:-2]
    M = torch.cat([ru.reshape(lead + (n, 12)), rv.reshape(lead + (n, 12))],
                  dim=-2)
    G = M.mT @ M
    G_ok = _all_finite(G, 2)
    G = torch.where(G_ok[..., None, None], G,
                    torch.eye(12, dtype=f32, device=dev))
    # the beta cases combine the 4 most-null vectors of G
    V = min_subspace(G, 4).mT.reshape(lead + (4, 4, 3))  # (vec, ctrl pt, 3)

    ii, jj = _PAIRS.to(dev)
    pa, pb = _PROD.to(dev)
    dv = V[..., :, ii, :] - V[..., :, jj, :]          # (..., 4, 6, 3)
    rho = torch.sum((cws[..., ii, :] - cws[..., jj, :]) ** 2, dim=-1)  # (..., 6)
    dots = torch.einsum("...aec,...bec->...eab", dv, dv)   # (..., 6, 4, 4)
    coef = torch.where(pa == pb, 1.0, 2.0).to(f32)
    L10 = dots[..., :, pa, pb] * coef                 # (..., 6, 10)

    def solve_case(cols):
        return _lstsq(L10[..., torch.tensor(cols, device=dev)], rho)

    zero = torch.zeros_like(rho[..., 0])
    # N=4: columns b11, b12, b13, b14 (PnPsolver.cc:668)
    b4 = solve_case(_CASE_COLS[0])
    b1 = torch.sqrt(torch.abs(b4[..., 0]))
    rest = (torch.where((b4[..., 0] < 0)[..., None], -b4[..., 1:], b4[..., 1:])
            / torch.clamp(b1, min=1e-12)[..., None])
    case1 = torch.cat([b1[..., None], rest], dim=-1)
    # N=2: columns b11, b12, b22 (PnPsolver.cc:712)
    b3 = solve_case(_CASE_COLS[1])
    sgn = torch.where(b3[..., 0] < 0, -1.0, 1.0)
    b1 = torch.sqrt(torch.abs(b3[..., 0]))
    b2 = torch.where(b3[..., 2] * sgn > 0, torch.sqrt(torch.abs(b3[..., 2])),
                     zero)
    b1 = torch.where(b3[..., 1] < 0, -b1, b1)
    case2 = torch.stack([b1, b2, zero, zero], dim=-1)
    # N=3: columns b11, b12, b22, b13, b23 (PnPsolver.cc:742)
    b5 = solve_case(_CASE_COLS[2])
    sgn = torch.where(b5[..., 0] < 0, -1.0, 1.0)
    b1 = torch.sqrt(torch.abs(b5[..., 0]))
    b2 = torch.where(b5[..., 2] * sgn > 0, torch.sqrt(torch.abs(b5[..., 2])),
                     zero)
    b1 = torch.where(b5[..., 1] < 0, -b1, b1)
    b3_ = b5[..., 3] / torch.where(torch.abs(b1) > 1e-12, b1,
                                   torch.full_like(b1, 1e-12))
    case3 = torch.stack([b1, b2, b3_, zero], dim=-1)

    # Gauss-Newton on the distance equations, the three cases as one batch
    # axis (PnPsolver::gauss_newton, PnPsolver.cc:697-710)
    betas = torch.stack([case1, case2, case3], dim=-2)   # (..., 3, 4)
    L10c, rhoc = L10[..., None, :, :], rho[..., None, :]
    ar4 = torch.arange(4, device=dev)
    onehot_a = (pa[:, None] == ar4[None, :]).to(f32)     # (10, 4)
    onehot_b = (pb[:, None] == ar4[None, :]).to(f32)
    for _ in range(GN_ITERS):
        prods = betas[..., pa] * betas[..., pb]              # (..., 3, 10)
        r = rhoc - (L10c @ prods[..., None])[..., 0]         # (..., 3, 6)
        dprod = (onehot_a * betas[..., pb, None]
                 + onehot_b * betas[..., pa, None])          # (..., 3, 10, 4)
        J = L10c @ dprod                                     # (..., 3, 6, 4)
        betas = betas + _lstsq(J, r)

    # pose of each case
    ccs = torch.einsum("...xc,...cpk->...xpk", betas, V)     # (..., 3, 4, 3)
    xc = alphas[..., None, :, :] @ ccs                       # (..., 3, n, 3)
    wc = w[..., None, :]
    flip = torch.sum(torch.where(wc > 0, torch.sign(xc[..., 2]),
                                 torch.zeros_like(wc)), dim=-1)
    xc = torch.where((flip < 0)[..., None, None], -xc, xc)   # cheirality
    xw3 = xw[..., None, :, :].expand(xc.shape)
    q, t = _horn_rt(xw3, xc, wc.expand(xc.shape[:-1]))
    prc = se3.apply(q[..., None, :], t[..., None, :], xw3)
    pr = torch.stack([fx * prc[..., 0] / prc[..., 2] + cx,
                      fy * prc[..., 1] / prc[..., 2] + cy], dim=-1)
    e = torch.sum((pr - uv[..., None, :, :]) ** 2, dim=-1)
    err = torch.sum(torch.where(wc > 0, e, torch.zeros_like(e)), dim=-1)
    finite = (_all_finite(q, 1) & _all_finite(t, 1) & torch.isfinite(err)
              & (G_ok & _all_finite(alphas, 2))[..., None])
    err = torch.where(finite, err, torch.full_like(err, float("inf")))
    best = first_argmax(-err)                                # (...,)
    q = torch.gather(q, -2, best[..., None, None].expand(best.shape + (1, 4)))
    t = torch.gather(t, -2, best[..., None, None].expand(best.shape + (1, 3)))
    ok = torch.isfinite(torch.gather(err, -1, best[..., None]))
    nan = float("nan")
    return (torch.where(ok, q[..., 0, :], torch.full_like(q[..., 0, :], nan)),
            torch.where(ok, t[..., 0, :], torch.full_like(t[..., 0, :], nan)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, c) at idx (..., H, S) -> (..., H, S, c)."""
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1, 1)).expand(lead + (idx.shape[-2]
                                                      * idx.shape[-1],
                                                      x.shape[-1]))
    return torch.gather(x.expand(lead + x.shape[-2:]), -2, flat).reshape(
        idx.shape + (x.shape[-1],))


def draw_samples(valid: torch.Tensor, n_hyp: int,
                 generator: torch.Generator = None) -> torch.Tensor:
    """(..., n_hyp, MIN_SET) int64 indices drawn with replacement among the
    valid entries of ``valid`` (..., N), uniformly where none is valid (a
    multinomial over zeros faults on the device)."""
    pw = valid.to(torch.float32).reshape(-1, valid.shape[-1])
    pw = pw + (torch.sum(pw, dim=-1, keepdim=True) == 0).to(torch.float32)
    idx = torch.multinomial(pw, n_hyp * MIN_SET, replacement=True,
                            generator=generator)
    return idx.reshape(valid.shape[:-1] + (n_hyp, MIN_SET))


def ransac_pnp(xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               cfg: SlamConfig, *, generator: torch.Generator = None,
               sample_idx: torch.Tensor = None, n_hyp: int = 256,
               th2: float = 5.991):
    """RANSAC EPnP: pose from 3D-2D matches under outliers.

    xw (..., N, 3), uv (..., N, 2), valid (..., N); leading axes are a
    batch of independent problems. The (..., n_hyp, 6) samples come from
    ``draw_samples`` on ``generator`` unless ``sample_idx`` gives them.
    th2 is the chi2 0.95 2-dof gate on the squared pixel error
    (``PnPsolver::SetRansacParameters``). The hypothesis with the most
    inliers wins, the lowest index among equal counts; EPnP over its inlier
    set refines it (``PnPsolver::Refine``) when that keeps at least as many.
    Returns (q, t, inlier_mask, n_inliers)."""
    K = camera.intrinsics(cfg.camera, xw.device)
    if sample_idx is None:
        sample_idx = draw_samples(valid, n_hyp, generator)
    idx = sample_idx.to(torch.int64)
    qs, ts = epnp(_take(xw, idx), _take(uv, idx),
                  torch.ones(idx.shape, dtype=xw.dtype, device=xw.device), K)

    def count(q, t):
        """Inlier masks (..., H, N) of the poses q (..., H, 4), t (..., H, 3)."""
        xc = se3.apply(q[..., None, :], t[..., None, :], xw[..., None, :, :])
        e = torch.sum((camera.project(cfg.camera, xc)
                       - uv[..., None, :, :]) ** 2, dim=-1)
        return valid[..., None, :] & (e < th2) & (xc[..., 2] > 0)

    inls = count(qs, ts)                                    # (..., H, N)
    counts = torch.sum(inls, dim=-1)
    best = first_argmax(counts)                             # (...,)
    sel = best[..., None, None]
    q = torch.gather(qs, -2, sel.expand(best.shape + (1, 4)))[..., 0, :]
    t = torch.gather(ts, -2, sel.expand(best.shape + (1, 3)))[..., 0, :]
    inl = torch.gather(inls, -2, sel.expand(best.shape + (1, inls.shape[-1])))[
        ..., 0, :]
    n_best = torch.gather(counts, -1, best[..., None])[..., 0]
    # refine on the best inlier set: EPnP over all inliers
    q2, t2 = epnp(xw, uv.expand(xw.shape[:-1] + (2,)), inl.to(xw.dtype), K)
    inl2 = count(q2[..., None, :], t2[..., None, :])[..., 0, :]
    better = torch.sum(inl2, dim=-1) >= n_best
    q = torch.where(better[..., None], q2, q)
    t = torch.where(better[..., None], t2, t)
    inl = torch.where(better[..., None], inl2, inl)
    return q, t, inl, torch.sum(inl, dim=-1, dtype=torch.int32)
