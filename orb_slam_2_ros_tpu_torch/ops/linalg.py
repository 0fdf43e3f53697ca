"""Small SPD solves for the pose LM and the triangulation, and the null
space of EPnP.

Replaces ``orb_slam_2_ros_tpu/ops/linalg.py::solve_spd_unrolled``, which
unrolls a Cholesky at trace time because the TPU's solvers are slow and
approximate. The pose LM's 6x6 system goes through ``torch.linalg`` in
float64 (``solve_spd``: a system that is not positive definite gives NaN,
which the LM rejects). The triangulation's batched 3x3 and 4x4 systems need
the other contract, finite values on a degenerate member, and keep the
reference's clamped, unrolled Cholesky in float32 (``solve_spd_clamped``).
Neither synchronises with the host.

``min_subspace`` replaces the reference's TPU float32 workaround for EPnP's
null space (seed from ``eigh``, polish by block inverse iteration, order by
Rayleigh-Ritz): one float64 ``eigh`` resolves the trailing cluster.
``null_vector`` does the same for the two-view initializer's DLT systems
(9 columns): the reference seeds from an SVD and polishes by inverse
iteration; one float64 ``eigh`` of the Gram matrix gives the same
direction up to sign. ``svd3`` is the initializer's float64 3x3 SVD.
"""

from __future__ import annotations

import torch


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD H (..., n, n), b (..., n); float64 Cholesky,
    result in b's dtype. A system that is not positive definite gives NaN,
    which the LM's finite guard rejects."""
    L, info = torch.linalg.cholesky_ex(H.to(torch.float64))
    # two triangular solves (cuBLAS trsm on the card: asynchronous)
    y = torch.linalg.solve_triangular(L, b.to(torch.float64)[..., None],
                                      upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    x = torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))
    return x.to(b.dtype)


def solve_spd_clamped(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for small SPD H (..., n, n), b (..., n), in H's dtype,
    by a Cholesky factorisation unrolled over n whose pivots are clamped at
    1e-12 before the square root: a batch member that is not positive
    definite (parallel rays in a triangulation) gives large but finite
    values instead of NaN or an exception. The operations and their order
    are the reference's ``solve_spd_unrolled``."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = H[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = H[..., j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    y = [None] * n                  # forward solve L y = b
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n                  # back solve L^T x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def min_subspace(G: torch.Tensor, k: int) -> torch.Tensor:
    """(..., d, k) orthonormal basis of the k smallest eigendirections of
    the symmetric G (..., d, d), smallest first: ``torch.linalg.eigh`` in
    float64, cast back to G's dtype. Signs, and the order inside a
    near-degenerate cluster, may differ from the reference's inverse
    iteration; the span is the same."""
    _, V = torch.linalg.eigh(G.to(torch.float64))
    return V[..., :k].to(G.dtype)


def _finite_or_identity(G: torch.Tensor) -> torch.Tensor:
    """G where every entry of a batch member is finite, the identity where
    one is not: ``eigh`` and ``svd`` raise on a non-finite member on the
    CPU and may not return on the card, and a degenerate hypothesis must
    lose, not stop the batch. No host read."""
    ok = torch.isfinite(G).all(dim=-1).all(dim=-1)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return torch.where(ok[..., None, None], G, eye.expand_as(G))


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """Most-null right-singular vector of A (..., rows, d): the eigenvector
    of the smallest eigenvalue of A^T A, from one float64 ``eigh``, cast to
    A's dtype. Unit norm; its sign is arbitrary, as the reference's is."""
    A64 = A.to(torch.float64)
    _, V = torch.linalg.eigh(_finite_or_identity(A64.mT @ A64))
    return V[..., :, 0].to(A.dtype)


def svd3(M: torch.Tensor):
    """Batched SVD of (..., 3, 3) in float64, cast back: (U, S, Vh) with
    S descending. A non-finite member is decomposed as the identity."""
    U, S, Vh = torch.linalg.svd(_finite_or_identity(M.to(torch.float64)))
    return U.to(M.dtype), S.to(M.dtype), Vh.to(M.dtype)
