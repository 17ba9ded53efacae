"""Epipolar geometry as batched tensor ops, the counterpart of
``txr/geometry/epipolar.py``.

- Hartley normalisation / 8-point / Sampson error work on fixed-capacity
  masked correspondence sets (weights zero out invalid rows), batched over
  any leading axes.
- The null vector of the (N, 9) design matrix is the smallest eigenvector of
  the 9x9 normal matrix A^T A (``ops/eigsmall.py``).
- RANSAC is one batch of hypotheses: sampling without replacement takes the
  8 (or 4) largest random priorities of each hypothesis, and every
  hypothesis solves and scores at once.

Priorities come from a ``torch.Generator``, or ready-made through
``priorities=`` (tests and the card-against-CPU check pass the draw of
``txr``'s ``jax.random`` key there). The largest priorities are taken with a
stable sort, so equal values keep index order as ``jax.lax.top_k`` keeps
them, and the first of equal inlier counts wins, as in ``txr``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from txr_torch.core.precision import f32_dots
from txr_torch.ops.eigsmall import smallest_eigvec, svd3

_EPS = 1.0e-12


def normalize_transform(pts: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Hartley normalisation matrix T (..., 3, 3) for weighted 2D points
    (..., N, 2): the reference's mean-distance scaling sqrt(2)/avg_dist,
    invalid points excluded through zero weights."""
    w = weights.to(pts.dtype)
    wsum = torch.clamp(w.sum(-1), min=_EPS)
    centroid = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((pts - centroid[..., None, :]) ** 2).sum(-1))
    avg = (d * w).sum(-1) / wsum
    scale = torch.where(avg > _EPS,
                        math.sqrt(2.0) / torch.clamp(avg, min=_EPS), 1.0)
    zero = torch.zeros_like(scale)
    return torch.stack([
        torch.stack([scale, zero, -scale * centroid[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * centroid[..., 1]], dim=-1),
        torch.stack([zero, zero, torch.ones_like(scale)], dim=-1),
    ], dim=-2)


def keep_110(like: torch.Tensor) -> torch.Tensor:
    """(1, 1, 0) in ``like``'s dtype, made on its device (a tensor built
    from host data would be a copy, which waits for the device)."""
    return (torch.arange(3, device=like.device) < 2).to(like.dtype)


def _homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def eight_point(pts1: torch.Tensor, pts2: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised 8-point fundamental matrix from weighted correspondences.

    pts1, pts2: (..., N, 2); weights: (..., N) with zeros excluding rows.
    Returns (..., 3, 3) F with rank 2 enforced and F /= F[2, 2].
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype,
                             device=pts1.device)
    w = weights.to(pts1.dtype)

    T1 = normalize_transform(pts1, w)
    T2 = normalize_transform(pts2, w)
    p1 = _homogeneous(pts1) @ T1.transpose(-1, -2)
    p2 = _homogeneous(pts2) @ T2.transpose(-1, -2)

    x1, y1, w1 = p1[..., 0], p1[..., 1], p1[..., 2]
    x2, y2, w2 = p2[..., 0], p2[..., 1], p2[..., 2]
    A = torch.stack(
        [x1 * x2, y1 * x2, w1 * x2,
         x1 * y2, y1 * y2, w1 * y2,
         x1 * w2, y1 * w2, w1 * w2], dim=-1)
    A = A * w[..., None]

    f = smallest_eigvec(A.transpose(-1, -2) @ A)
    F0 = f.reshape(*f.shape[:-1], 3, 3)

    # Rank-2 enforcement by zeroing the smallest singular value.
    U, S, Vt = svd3(F0)
    S = S * keep_110(S)
    F0 = (U * S[..., None, :]) @ Vt

    F = T2.transpose(-1, -2) @ F0 @ T1
    f22 = F[..., 2:3, 2:3]
    big = f22.abs() > _EPS
    return torch.where(big, F / torch.where(big, f22, 1.0), F)


def sampson_error(F: torch.Tensor, pts1: torch.Tensor,
                  pts2: torch.Tensor) -> torch.Tensor:
    """Sampson distance per correspondence: F (..., 3, 3), pts (N, 2).
    Returns (..., N)."""
    p1 = _homogeneous(pts1)
    p2 = _homogeneous(pts2)
    Fx1 = p1 @ F.transpose(-1, -2)       # rows = F @ x1
    Ftx2 = p2 @ F                        # rows = F^T @ x2
    x2tFx1 = (p2 * Fx1).sum(-1)
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
             + Ftx2[..., 1] ** 2)
    return torch.where(denom > _EPS,
                       x2tFx1 ** 2 / torch.clamp(denom, min=_EPS), torch.inf)


def sample_indices(mask: torch.Tensor, k: int, num_hypotheses: int,
                   generator: Optional[torch.Generator],
                   priorities: Optional[torch.Tensor]) -> torch.Tensor:
    """(num_hypotheses, k) distinct indices per hypothesis: the k largest
    priorities among the valid rows (invalid rows rank last)."""
    if priorities is None:
        priorities = torch.rand((num_hypotheses, mask.shape[0]),
                                generator=generator, device=mask.device)
    elif priorities.shape != (num_hypotheses, mask.shape[0]):
        raise ValueError(f"priorities of shape {tuple(priorities.shape)}, "
                         f"expected ({num_hypotheses}, {mask.shape[0]})")
    prio = torch.where(mask[None, :], priorities.to(mask.device), -1.0)
    return torch.sort(prio, dim=-1, descending=True, stable=True)[1][:, :k]


def take_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _best(inl: torch.Tensor):
    """Index of the hypothesis with the most inliers (the first of equal
    counts) and its inlier mask."""
    best = torch.argmax(inl.sum(-1))
    return best, take_row(inl, best)


@f32_dots
def fundamental_ransac(pts1: torch.Tensor, pts2: torch.Tensor,
                       mask: torch.Tensor,
                       generator: Optional[torch.Generator],
                       threshold: float = 3.0, num_hypotheses: int = 1024,
                       *, priorities: Optional[torch.Tensor] = None):
    """Batched-hypothesis RANSAC for F.

    pts1, pts2: (N, 2) fixed-capacity correspondences; mask: (N,) validity;
    threshold: Sampson-error inlier threshold. Returns F (3, 3) refitted on
    the best hypothesis's inliers, and that inlier mask (N,).
    """
    idx = sample_indices(mask, 8, num_hypotheses, generator, priorities)
    F_hyp = eight_point(pts1[idx], pts2[idx])                 # (B, 3, 3)
    errs = sampson_error(F_hyp, pts1, pts2)                   # (B, N)
    inl = (errs < threshold) & mask[None, :]
    best, best_inliers = _best(inl)
    # Refit on inliers (weighted rows; needs >= 8 inliers to be meaningful).
    F_refit = eight_point(pts1, pts2, best_inliers.to(pts1.dtype))
    use_refit = best_inliers.sum() >= 8
    return torch.where(use_refit, F_refit, take_row(F_hyp, best)), \
        best_inliers


def _essential_projection(F: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values (1, 1, 0)."""
    U, _, Vt = svd3(F)
    return (U * keep_110(F)[..., None, :]) @ Vt


@f32_dots
def essential_ransac(pts1: torch.Tensor, pts2: torch.Tensor,
                     mask: torch.Tensor, K: torch.Tensor,
                     generator: Optional[torch.Generator],
                     threshold: float = 2.0, num_hypotheses: int = 1024,
                     *, priorities: Optional[torch.Tensor] = None):
    """RANSAC essential matrix via 8-point on K-normalised coordinates.

    The pixel-space Sampson threshold maps into normalised coordinates by
    the mean focal length (cv2.findEssentialMat-style thresholding).

    Returns E (3, 3), inlier_mask (N,).
    """
    f_mean = (K[0, 0] + K[1, 1]) / 2.0
    Kinv = torch.linalg.inv_ex(K.to(pts1.dtype))[0]
    n1 = (_homogeneous(pts1) @ Kinv.T)[:, :2]
    n2 = (_homogeneous(pts2) @ Kinv.T)[:, :2]
    thr_norm = (threshold / f_mean) ** 2  # Sampson error is squared

    idx = sample_indices(mask, 8, num_hypotheses, generator, priorities)
    E_hyp = _essential_projection(eight_point(n1[idx], n2[idx]))
    errs = sampson_error(E_hyp, n1, n2)
    inl = (errs < thr_norm) & mask[None, :]
    best, best_inliers = _best(inl)

    E_refit = _essential_projection(
        eight_point(n1, n2, best_inliers.to(pts1.dtype)))
    use_refit = best_inliers.sum() >= 8
    return torch.where(use_refit, E_refit, take_row(E_hyp, best)), \
        best_inliers
