"""Homography estimation + decomposition for planar-degenerate two-view
initialisation, the counterpart of ``txr/geometry/homography.py``.

The 8-point essential RANSAC is degenerate when the scene is (near-)planar,
as textureless tunnel walls are. The classical fix (ORB-SLAM's initialiser):
fit a homography too and, when it explains the matches, recover the pose by
SVD homography decomposition (Faugeras; 8 candidate (R, t, n)) with a
cheirality vote. 4-point DLT hypotheses solve in one batch; the 8
candidates score in one batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from txr_torch.core.precision import f32_dots
from txr_torch.geometry.epipolar import (_best, _homogeneous,
                                         normalize_transform, sample_indices,
                                         take_row)
from txr_torch.geometry.pose import cheirality_vote
from txr_torch.ops.eigsmall import det3, inv3, smallest_eigvec, svd3

_EPS = 1e-12


def homography_dlt(pts1: torch.Tensor, pts2: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised DLT homography from >= 4 correspondences (..., N, 2).
    Returns (..., 3, 3), H x1 ~ x2."""
    w = torch.ones(pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device) \
        if weights is None else weights
    T1 = normalize_transform(pts1, w)
    T2 = normalize_transform(pts2, w)
    p1 = _homogeneous(pts1) @ T1.transpose(-1, -2)
    p2 = _homogeneous(pts2) @ T2.transpose(-1, -2)

    zero = torch.zeros_like(p1)
    # Rows: [0, -x1, y2*x1; x1, 0, -x2*x1] per correspondence.
    r1 = torch.cat([zero, -p1, p2[..., 1:2] * p1], dim=-1)
    r2 = torch.cat([p1, zero, -p2[..., 0:1] * p1], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (2N, 9)
    Hn = smallest_eigvec(A.transpose(-1, -2) @ A)
    Hn = Hn.reshape(*Hn.shape[:-1], 3, 3)
    H = inv3(T2) @ Hn @ T1
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() > _EPS, h22, 1.0)


def transfer_error(H: torch.Tensor, pts1: torch.Tensor,
                   pts2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared transfer error per correspondence: H (..., 3, 3),
    pts (N, 2). Returns (..., N)."""
    p1 = _homogeneous(pts1)
    p2 = _homogeneous(pts2)
    q2 = p1 @ H.transpose(-1, -2)
    q1 = p2 @ inv3(H).transpose(-1, -2)
    z2 = torch.where(q2[..., 2:3].abs() > _EPS, q2[..., 2:3], _EPS)
    z1 = torch.where(q1[..., 2:3].abs() > _EPS, q1[..., 2:3], _EPS)
    e12 = ((q2[..., :2] / z2 - pts2) ** 2).sum(-1)
    e21 = ((q1[..., :2] / z1 - pts1) ** 2).sum(-1)
    return e12 + e21


@f32_dots
def homography_ransac(pts1: torch.Tensor, pts2: torch.Tensor,
                      mask: torch.Tensor,
                      generator: Optional[torch.Generator],
                      threshold: float = 3.0, num_hypotheses: int = 1024,
                      *, priorities: Optional[torch.Tensor] = None):
    """Batched 4-point RANSAC. Returns H (3, 3), inlier_mask (N,).

    threshold is in pixels; the symmetric transfer test uses 2*threshold^2
    (two squared distances summed).
    """
    idx = sample_indices(mask, 4, num_hypotheses, generator, priorities)
    H_hyp = homography_dlt(pts1[idx], pts2[idx])
    errs = transfer_error(H_hyp, pts1, pts2)
    inl = (errs < 2.0 * threshold * threshold) & mask[None, :]
    best, best_inliers = _best(inl)
    H_refit = homography_dlt(pts1, pts2, best_inliers.to(pts1.dtype))
    use_refit = best_inliers.sum() >= 4
    return torch.where(use_refit, H_refit, take_row(H_hyp, best)), \
        best_inliers


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras SVD decomposition: 8 candidate (R, t, n) with ||t|| = 1.

    A = K^-1 H K = d R + t n^T up to sign / scale; the two cases d' = +-d2,
    four sign patterns each. Degenerate candidates (equal singular values)
    come out near identity and lose the cheirality vote.
    """
    dt = H.dtype
    Kd = K.to(dt)
    A = torch.linalg.inv_ex(Kd)[0] @ H @ Kd
    U, S, Vt = svd3(A)
    s = det3(U) * det3(Vt)
    d1, d2, d3 = S[0], S[1], S[2]

    denom = torch.clamp(d1 * d1 - d3 * d3, min=_EPS)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    pm = torch.stack([torch.ones_like(d1), -torch.ones_like(d1)])
    x1s = aux1 * pm.repeat_interleave(2)         # (aux1, aux1, -aux1, -aux1)
    x3s = aux3 * pm.repeat(2)                    # (aux3, -aux3, aux3, -aux3)
    signs = torch.stack([pm[0], pm[1], pm[1], pm[0]])   # (+, -, -, +)
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    # Case d' = +d2
    den_p = torch.clamp((d1 + d3) * d2, min=_EPS)
    st = (prod / den_p) * signs
    ct = ((d2 * d2 + d1 * d3) / den_p).expand(4)
    Rp = torch.stack([torch.stack([ct, zero, -st], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([st, zero, ct], -1)], -2)
    tp = (d1 - d3) * torch.stack([x1s, zero, -x3s], -1)

    # Case d' = -d2
    den_n = torch.clamp((d1 - d3) * d2, min=_EPS)
    sp = (prod / den_n) * signs
    cp = ((d1 * d3 - d2 * d2) / den_n).expand(4)
    Rn = torch.stack([torch.stack([cp, zero, sp], -1),
                      torch.stack([zero, -one, zero], -1),
                      torch.stack([sp, zero, -cp], -1)], -2)
    tn = (d1 + d3) * torch.stack([x1s, zero, x3s], -1)

    npl = torch.stack([x1s, zero, x3s], -1)
    Rs = (s * U) @ torch.cat([Rp, Rn]) @ Vt                  # (8, 3, 3)
    ts = (U @ torch.cat([tp, tn])[..., None])[..., 0]        # (8, 3)
    ns = (Vt.T @ torch.cat([npl, npl])[..., None])[..., 0]   # (8, 3)
    tnorm = torch.linalg.vector_norm(ts, dim=-1, keepdim=True)
    return Rs, ts / torch.clamp(tnorm, min=_EPS), ns


@f32_dots
def recover_pose_homography(H: torch.Tensor, pts1: torch.Tensor,
                            pts2: torch.Tensor, K: torch.Tensor,
                            mask: torch.Tensor):
    """Cheirality-voted pose from H (the contract of
    ``pose.recover_pose``)."""
    Rs, ts, _ = decompose_homography(H, K)
    return cheirality_vote(Rs, ts, pts1, pts2, K, mask)
