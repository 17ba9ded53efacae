"""Relative pose from the essential matrix, the counterpart of
``txr/geometry/pose.py``.

Decompose E into the four (R, t) candidates and keep the one with the most
triangulated points in front of both cameras (cheirality vote); all four
candidates triangulate in one batched pass.
"""

from __future__ import annotations

import torch

from txr_torch.core.precision import f32_dots
from txr_torch.geometry.epipolar import take_row
from txr_torch.geometry.triangulate import triangulate
from txr_torch.ops.eigsmall import det3, svd3


def _w_matrix(like: torch.Tensor) -> torch.Tensor:
    """[[0, -1, 0], [1, 0, 0], [0, 0, 1]], made on ``like``'s device."""
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return torch.stack([-eye[1], eye[0], eye[2]])


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t) candidate building blocks."""
    U, _, Vt = svd3(E)
    # Keep proper rotations.
    Vt = torch.where(det3(U @ Vt) < 0, -Vt, Vt)
    W = _w_matrix(E)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = torch.where(det3(R1) < 0, -R1, R1)
    R2 = torch.where(det3(R2) < 0, -R2, R2)
    return R1, R2, U[:, 2]


def cheirality_vote(Rs: torch.Tensor, ts: torch.Tensor, pts1: torch.Tensor,
                    pts2: torch.Tensor, K: torch.Tensor, mask: torch.Tensor):
    """The candidate (Rs (C, 3, 3), ts (C, 3)) with the most points in
    front of both cameras (the first of equal counts); returns (R, t,
    good (N,))."""
    K = K.to(Rs.dtype)
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    P1 = K @ torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=1)
    P2 = K @ torch.cat([Rs, ts[..., None]], dim=-1)           # (C, 3, 4)
    X = triangulate(P1, P2, pts1, pts2)                        # (C, N, 3)
    z1 = X[..., 2]
    z2 = (X @ Rs[:, 2, :, None])[..., 0] + ts[:, 2:3]
    good = (z1 > 0) & (z2 > 0) & torch.isfinite(z1) & mask
    best = torch.argmax(good.sum(-1))
    return take_row(Rs, best), take_row(ts, best), take_row(good, best)


@f32_dots
def recover_pose(E: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                 K: torch.Tensor, mask: torch.Tensor):
    """Cheirality-voted pose from E.

    E: (3, 3); pts1, pts2: (N, 2) pixel correspondences; K: (3, 3); mask:
    (N,) validity. Returns R (3, 3), t (3,) with ||t|| = 1, good_mask (N,)
    points in front of both cameras under the winning pose.
    """
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    return cheirality_vote(Rs, ts, pts1, pts2, K, mask)


def chain_pose(R_rel: torch.Tensor, t_rel: torch.Tensor,
               R_prev: torch.Tensor, t_prev: torch.Tensor):
    """Compose world -> camera poses: camera_i = rel o camera_{i-1}."""
    return R_rel @ R_prev, R_rel @ t_prev + t_rel
