"""Batched tiny symmetric eigensolvers for the RANSAC / triangulation path,
the counterpart of ``txr/ops/eigsmall.py``.

The geometry stack solves thousands of independent 9x9 / 4x4 / 3x3
problems per RANSAC (hypothesis null vectors, per-point DLT
triangulation). This module runs the same fixed-sweep cyclic Jacobi as
``txr``: per sweep, d*(d-1)/2 plane rotations, each touching two rows and
two columns of every matrix in the batch; 6 sweeps. It is not
``torch.linalg.eigh`` / ``svd``: their column order and signs differ, and
RANSAC, pose and triangulation depend on those of ``txr``.

In eager PyTorch every rotation is a few dozen small launches over the
batch, so one 9x9 solve is 216 rotations of launches: this module is bound
by launches on the card, not by arithmetic.
"""

from __future__ import annotations

import torch

from txr_torch.core.precision import f32_dots

_SWEEPS = 6


def _rotate(A: torch.Tensor, V: torch.Tensor, p: int, q: int) -> None:
    """One batched Jacobi rotation zeroing A[..., p, q] (p < q), in place."""
    app = A[..., p, p]
    aqq = A[..., q, q]
    apq = A[..., p, q]
    # tan(2 theta) = 2 a_pq / (a_qq - a_pp); stable single-rotation form.
    small = apq.abs() <= 1e-30 * (app.abs() + aqq.abs() + 1e-30)
    tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
    # Zero-safe sign: sign(0) == 0 would skip the rotation when a_pp == a_qq
    # exactly with a_pq != 0; tau == 0 must rotate by 45 degrees (t = 1).
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    cc, ss = c[..., None], s[..., None]

    rp, rq = A[..., p, :], A[..., q, :]
    new_p, new_q = cc * rp - ss * rq, ss * rp + cc * rq
    A[..., p, :] = new_p
    A[..., q, :] = new_q
    cp, cq = A[..., :, p], A[..., :, q]
    new_p, new_q = cc * cp - ss * cq, ss * cp + cc * cq
    A[..., :, p] = new_p
    A[..., :, q] = new_q
    vp, vq = V[..., :, p], V[..., :, q]
    new_p, new_q = cc * vp - ss * vq, ss * vp + cc * vq
    V[..., :, p] = new_p
    V[..., :, q] = new_q


@f32_dots
def eigh_jacobi(M: torch.Tensor, sweeps: int = _SWEEPS):
    """Eigendecomposition of symmetric M (..., d, d), d small.

    Returns (w, V) with M V = V diag(w); w UNSORTED (use argmin / argmax).
    """
    d = M.shape[-1]
    A = M.to(torch.float32).clone()
    V = torch.eye(d, dtype=torch.float32, device=M.device).expand(
        A.shape).clone()
    for _ in range(sweeps):
        for p in range(d - 1):
            for q in range(p + 1, d):
                _rotate(A, V, p, q)
    return torch.diagonal(A, dim1=-2, dim2=-1), V


@f32_dots
def smallest_eigvec(M: torch.Tensor, sweeps: int = _SWEEPS) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric M
    (..., d, d): the RANSAC null-vector solve."""
    w, V = eigh_jacobi(M, sweeps)
    idx = torch.argmin(w, dim=-1)
    idx = idx[..., None, None].expand(*V.shape[:-1], 1)
    return torch.gather(V, -1, idx)[..., 0]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


@f32_dots
def svd3(F: torch.Tensor, sweeps: int = _SWEEPS):
    """SVD of (..., 3, 3) via a Jacobi eigensolve of F^T F.

    Returns (U, s, Vt) with F = U diag(s) Vt, s sorted DESCENDING, s >= 0.
    u_0, u_1 come from F v_i (u_1 orthogonalised against u_0); u_2 is
    ALWAYS u_0 x u_1, sign-matched to F v_2: an essential-manifold F has
    s_2 = 0 exactly, and F v_2 / s_2 is rounding noise in a random
    direction.
    """
    Ft = F.transpose(-1, -2)
    w, V = eigh_jacobi(Ft @ F, sweeps)          # F^T F = V diag(s^2) V^T
    order = torch.argsort(-w, dim=-1, stable=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    s2 = torch.gather(w, -1, order)
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    FV = F @ V
    u0 = _unit(FV[..., :, 0])
    u1 = FV[..., :, 1] - (FV[..., :, 1] * u0).sum(-1, keepdim=True) * u0
    u1 = _unit(u1)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    sgn = (FV[..., :, 2] * u2).sum(-1, keepdim=True)
    u2 = u2 * torch.where(sgn < 0.0, -1.0, 1.0)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)


def det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3): no LU, no host sync."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3), batched, no LU.

    No singularity guard: callers pass normalisation affines / accepted
    homographies, invertible by construction (a singular input gives
    non-finite entries, as ``torch.linalg.inv_ex`` would).
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]
