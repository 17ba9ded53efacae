"""Fusion-from-precomputed-depth pipeline, sparse half: the counterpart of
the pair and scale stages of ``txr/pipelines/fusion_pipeline.py``.

One ``pair_step`` per consecutive frame pair (match -> essential RANSAC and
homography RANSAC with model selection -> cheirality pose -> Gauss-Newton
refinement -> DLT triangulation -> filtering), ``_pairs_batch`` over every
pair of a sequence, and ``_scales_batch``: the metric scale of the first
pair's views and of every later view against its chained pose. Nothing in
these stages reads a value back to the host: the host reads the per-pair
results once, to chain poses with the reference's skip rules.

The ``DepthToReconstructionPipeline`` class, the dense back-projection and
the merge come with the port's cloud ops.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from txr_torch.core.precision import f32_dots
from txr_torch.geometry.epipolar import essential_ransac
from txr_torch.geometry.homography import (homography_ransac,
                                           recover_pose_homography,
                                           transfer_error)
from txr_torch.geometry.pose import recover_pose
from txr_torch.geometry.refine import refine_pose
from txr_torch.geometry.scale import clamp_scale, estimate_scale
from txr_torch.geometry.triangulate import reprojection_error, triangulate
from txr_torch.ops.matching import match_l2_ratio


@f32_dots
def pair_step(uv1: torch.Tensor, uv2: torch.Tensor,
              match_mask: torch.Tensor, K: torch.Tensor,
              generator: Optional[torch.Generator],
              ransac_threshold: float = 2.0, min_depth: float = 0.1,
              max_depth: float = 50.0, max_reproj: float = 5.0,
              num_hypotheses: int = 1024, *,
              priorities: Optional[Sequence[torch.Tensor]] = None):
    """Relative pose + filtered sparse structure for one frame pair.

    Follows SparseReconstructor.compute_pose/triangulate/filter_points
    (depth_to_reconstruction.py:183-271): essential RANSAC -> cheirality
    pose -> DLT triangulation -> filter by depth range in cam1, positive
    depth in cam2 and reprojection error < max_reproj px in both views.

    Planar degeneracy: the 8-point essential solve is ill-posed when the
    matches lie on a plane. A homography is fitted alongside and, when it
    explains most of the E-inlier set (n_H > 0.7 n_E, both counted at the
    same pixel threshold), the pose comes from the homography decomposition
    instead. The winner is polished by Gauss-Newton (``refine_pose``).

    generator draws the RANSAC priorities (essential first, then
    homography); ``priorities=(prio_E, prio_H)``, each (num_hypotheses, N),
    replaces the draw.

    Returns R (3, 3), t (3,), X (N, 3) points in the cam-1 frame, valid
    (N,), n_inliers (0-dim).
    """
    prio_e, prio_h = (None, None) if priorities is None else priorities
    E, inliers_e = essential_ransac(uv1, uv2, match_mask, K, generator,
                                    ransac_threshold, num_hypotheses,
                                    priorities=prio_e)
    R_e, t_e, cheiral_e = recover_pose(E, uv1, uv2, K, inliers_e)

    H, inliers_h = homography_ransac(uv1, uv2, match_mask, generator,
                                     max(ransac_threshold, 3.0),
                                     num_hypotheses, priorities=prio_h)
    R_h, t_h, cheiral_h = recover_pose_homography(H, uv1, uv2, K, inliers_h)

    n_e = inliers_e.sum()
    # Model selection rescores H at the SAME pixel threshold as E.
    h_sel = match_mask & (transfer_error(H, uv1, uv2)
                          < 2.0 * ransac_threshold ** 2)
    use_h = h_sel.sum().to(K.dtype) > 0.7 * n_e.to(K.dtype)

    R = torch.where(use_h, R_h, R_e)
    t = torch.where(use_h, t_h, t_e)
    cheiral = torch.where(use_h, cheiral_h, cheiral_e)
    inliers = torch.where(use_h, inliers_h, inliers_e)

    R, t = refine_pose(R, t, uv1, uv2, K, inliers & cheiral)

    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = K @ torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=1)
    P2 = K @ torch.cat([R, t[:, None]], dim=1)
    X = triangulate(P1, P2, uv1, uv2)

    z1 = X[:, 2]
    z2 = X @ R[2, :] + t[2]
    err1 = reprojection_error(P1, X, uv1)
    err2 = reprojection_error(P2, X, uv2)
    valid = (inliers & cheiral & (z1 > min_depth) & (z1 < max_depth)
             & (z2 > min_depth) & (err1 < max_reproj) & (err2 < max_reproj)
             & torch.isfinite(z1))
    X = torch.where(valid[:, None], X, 0.0)
    return R, t, X, valid, inliers.sum()


@f32_dots
def sparse_to_world(X: torch.Tensor, valid: torch.Tensor,
                    R_prev: torch.Tensor, t_prev: torch.Tensor):
    """Triangulated points (..., N, 3) in the previous camera's frame ->
    world, with the reference's depth-range filter 0.1 < z_w < 100
    (depth_to_reconstruction.py:630-637)."""
    Xw = (X - t_prev[..., None, :]) @ R_prev   # R_prev^T (X - t_prev)
    ok = valid & (Xw[..., 2] > 0.1) & (Xw[..., 2] < 100.0)
    return Xw, ok


def _compact(ok: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` rows with the matched rows first, each
    group in its order (``txr`` takes a stable top-k of the mask)."""
    order = torch.sort(ok.to(torch.uint8), descending=True, stable=True)[1]
    return order[:cap]


def _pairs_batch(desc: torch.Tensor, fmask: torch.Tensor, fuv: torch.Tensor,
                 K: torch.Tensor, generator: Optional[torch.Generator],
                 match_ratio: float, ransac_threshold: float,
                 min_depth: float, max_depth: float,
                 num_hypotheses: int = 1024, *,
                 priorities: Optional[torch.Tensor] = None):
    """Match + pair_step for every consecutive frame pair.

    desc / fmask / fuv: (N, cap, ...) stacked features. priorities:
    optional (N-1, 2, num_hypotheses, rows) ready-made RANSAC priorities
    (see ``pair_step``). Returns per pair (R, t, X, valid, n_inl, n_match,
    uv1, uv2, ok), each with leading dim N-1.

    The pair's rows are compacted to the first TXR_PAIR_CAP (default 4096;
    0 disables) with the matched rows first, in order: pair_step's per-row
    cost scales with the rows, and only matches count. The pairs run one
    after another, as ``txr``'s ``lax.map``, so peak memory stays at one
    pair's (cap, cap) distance matrix (268 MB at cap 8192).
    """
    pair_cap = int(os.environ.get("TXR_PAIR_CAP", "4096"))
    outs = []
    for p in range(desc.shape[0] - 1):
        u1 = fuv[p]
        idx2, ok = match_l2_ratio(desc[p], desc[p + 1], fmask[p],
                                  fmask[p + 1], match_ratio)
        uv2 = fuv[p + 1][idx2]
        n_match = ok.sum()
        if 0 < pair_cap < u1.shape[0]:
            pick = _compact(ok, pair_cap)
            u1, uv2, ok = u1[pick], uv2[pick], ok[pick]
        prio = None if priorities is None else priorities[p]
        R, t, X, valid, n_inl = pair_step(
            u1, uv2, ok, K, generator, ransac_threshold, min_depth,
            max_depth, num_hypotheses=num_hypotheses, priorities=prio)
        outs.append((R, t, X, valid, n_inl, n_match, u1, uv2, ok))
    return tuple(torch.stack(col) for col in zip(*outs))


def _scales_init(X0, valid0, uv1_0, uv2_0, d0, d1):
    """Init-pair scale estimates only (the chunked-sequence split of
    _scales_batch)."""
    s1 = estimate_scale(X0, uv1_0, valid0, d0, min_points=0,
                        per_sample_clamp=True)
    s2 = estimate_scale(X0, uv2_0, valid0, d1, min_points=0,
                        per_sample_clamp=True)
    return clamp_scale(s1), clamp_scale(s2), valid0.sum()


def _scales_views(X, valid, uv2, R_prev, t_prev, depths_next):
    """Per-view world-frame scales for one chunk of pairs (the chunked-
    sequence split of _scales_batch); depths_next[p] is view p+1's depth."""
    Xw, ok = sparse_to_world(X, valid, R_prev, t_prev)
    s = estimate_scale(Xw, uv2, ok, depths_next, min_points=0,
                       per_sample_clamp=True)
    return clamp_scale(s), ok.sum(-1)


@f32_dots
def _scales_batch(X, valid, uv1, uv2, depths, R_prev, t_prev):
    """Init-pair scales + per-view world-frame scales, all pairs at once.

    X / valid / uv1 / uv2: (P, cap, ...) pair outputs (on the device, from
    _pairs_batch). depths: (P+1, H, W). R_prev / t_prev: (P, 3, 3) / (P, 3):
    entry p holds the chained pose of the LAST SUCCESSFUL view before view
    p+1 (host-computed; entry 0 unused).
    Returns (s1, s2, n_valid0, sw (P,), ok_n (P,)).
    """
    # depth_to_reconstruction.py:297-326 semantics: no input-count gate,
    # per-ratio (0.001, 1000) clamp before the median.
    s1 = estimate_scale(X[0], uv1[0], valid[0], depths[0], min_points=0,
                        per_sample_clamp=True)
    s2 = estimate_scale(X[0], uv2[0], valid[0], depths[1], min_points=0,
                        per_sample_clamp=True)
    Xw, ok = sparse_to_world(X, valid, R_prev, t_prev)
    sw = estimate_scale(Xw, uv2, ok, depths[1:], min_points=0,
                        per_sample_clamp=True)
    return s1, s2, valid[0].sum(), sw, ok.sum(-1)


def _pad_pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _seq_chunk() -> int:
    """Pair-slab size for long sequences (TXR_SEQ_CHUNK, default 64),
    rounded up to a power of two so it divides the pow2-padded pair
    count."""
    return _pad_pow2(int(os.environ.get("TXR_SEQ_CHUNK", "64")))
