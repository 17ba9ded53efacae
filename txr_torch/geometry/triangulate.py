"""Batched DLT triangulation, the counterpart of
``txr/geometry/triangulate.py``.

All N points solve at once: the DLT null vector is the smallest
eigenvector of the 4x4 normal matrix A^T A (``ops/eigsmall.py``), batched
over points and over any leading axes of the projection matrices.
"""

from __future__ import annotations

import torch

from txr_torch.core.precision import f32_dots
from txr_torch.ops.eigsmall import smallest_eigvec


def _dlt_single(P1: torch.Tensor, P2: torch.Tensor, pt1: torch.Tensor,
                pt2: torch.Tensor) -> torch.Tensor:
    """P1, P2 (..., 3, 4); pt1, pt2 (..., N, 2) -> (..., N, 3)."""
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    A = torch.stack(torch.broadcast_tensors(
        pt1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        pt1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        pt2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        pt2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]),
        dim=-2)                                       # (..., N, 4, 4)
    X = smallest_eigvec(A.transpose(-1, -2) @ A)
    w = X[..., 3:4]
    ok = w.abs() > 1e-12
    return torch.where(ok, X[..., :3] / torch.where(ok, w, 1.0),
                       torch.inf)


@f32_dots
def triangulate(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor,
                pts2: torch.Tensor) -> torch.Tensor:
    """Triangulate correspondences.

    P1, P2: (..., 3, 4) projection matrices; pts1, pts2: (N, 2) or
    (..., N, 2) pixel coordinates. Returns (..., N, 3) points (inf where
    the homogeneous w vanishes).
    """
    return _dlt_single(P1, P2, pts1, pts2)


@f32_dots
def reprojection_error(P: torch.Tensor, X: torch.Tensor,
                       pts: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error of points X (N, 3) under P (3, 4). (N,)"""
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=-1)
    proj = Xh @ P.T
    z = proj[:, 2]
    zok = z.abs() > 1e-12
    uv = proj[:, :2] / torch.where(zok, z, 1.0)[:, None]
    err = torch.linalg.vector_norm(uv - pts, dim=-1)
    return torch.where(zok, err, torch.inf)


@f32_dots
def depth_in_camera(R: torch.Tensor, t: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
    """Z of points X (N, 3) in the camera frame (R, t world -> cam). (N,)"""
    return X @ R[2, :] + t[2]
