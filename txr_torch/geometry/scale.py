"""Metric-scale anchoring of relative depth from sparse SfM points, the
counterpart of ``txr/geometry/scale.py``.

Two variants served by one op, as in ``txr``:
- depth_enhanced_reconstruction.py:652-697: >= 5 input points and >= 3
  valid samples, no per-sample clamp (min_points=5, per_sample_clamp=False,
  the defaults).
- depth_to_reconstruction.py:297-326: no input-count gate, each ratio kept
  only if 0.001 < s < 1000, >= 3 survivors (min_points=0,
  per_sample_clamp=True). The final clamp of :315-319 is clamp_scale.
Both read the depth pixel with int() TRUNCATION of the sub-pixel keypoint
(a float-to-int conversion rounds toward zero, as Python's int()).

The median over a masked fixed-capacity set sorts with invalid entries
pushed to +inf and takes the middle of the valid count. Every function here
batches over leading axes and reads nothing back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.precision import f32_dots


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of values[mask] over the last axis; 0.0 when nothing is valid
    (including capacity-0 inputs)."""
    m = values.shape[-1]
    if m == 0:
        return torch.zeros(values.shape[:-1], dtype=values.dtype,
                           device=values.device)
    v = torch.sort(torch.where(mask, values, torch.inf), dim=-1)[0]
    cnt = mask.sum(-1)
    lo = torch.clamp((cnt - 1) // 2, 0, m - 1)
    hi = torch.clamp(cnt // 2, 0, m - 1)
    med = 0.5 * (torch.gather(v, -1, lo[..., None])[..., 0]
                 + torch.gather(v, -1, hi[..., None])[..., 0])
    return torch.where(cnt > 0, med, 0.0)


@f32_dots
def estimate_scale(sparse_xyz_cam: torch.Tensor, sparse_uv: torch.Tensor,
                   sparse_mask: torch.Tensor, depth_map: torch.Tensor,
                   min_points: int = 5, min_valid: int = 3,
                   per_sample_clamp: bool = False) -> torch.Tensor:
    """Scale factor aligning a relative depth map to metric sparse points.

    sparse_xyz_cam: (..., M, 3) points in the camera frame; sparse_uv:
    (..., M, 2) their pixels (u, v); sparse_mask: (..., M); depth_map:
    (..., H, W) relative depth. min_points: minimum INPUT points (0
    disables); min_valid: minimum surviving samples; per_sample_clamp: gate
    each ratio to (0.001, 1000) BEFORE the median.

    Returns the scale (...,); 1.0 where the data do not suffice.
    """
    if sparse_xyz_cam.shape[-2] == 0:
        return torch.ones(sparse_xyz_cam.shape[:-2], dtype=torch.float32,
                          device=sparse_xyz_cam.device)
    h, w = depth_map.shape[-2:]
    u_raw = sparse_uv[..., 0].to(torch.int32)
    v_raw = sparse_uv[..., 1].to(torch.int32)
    # Out-of-image projections are EXCLUDED, not clamped to the border.
    in_image = (u_raw >= 0) & (u_raw < w) & (v_raw >= 0) & (v_raw < h)
    u = torch.clamp(u_raw, 0, w - 1).to(torch.int64)
    v = torch.clamp(v_raw, 0, h - 1).to(torch.int64)
    flat = depth_map.reshape(*depth_map.shape[:-2], h * w)
    d = torch.gather(flat, -1, v * w + u)
    z = sparse_xyz_cam[..., 2]
    valid = (sparse_mask & in_image & (d > 1e-6) & (z > 0)
             & torch.isfinite(d) & torch.isfinite(z))
    ratio = torch.where(valid, z / torch.clamp(d, min=1e-6), 0.0)
    if per_sample_clamp:
        valid = valid & (ratio > 0.001) & (ratio < 1000.0)
        ratio = torch.where(valid, ratio, 0.0)
    med = masked_median(ratio, valid)
    ok = ((sparse_mask.sum(-1) >= min_points)
          & (valid.sum(-1) >= min_valid) & (med > 0))
    return torch.where(ok, med, 1.0)


def clamp_scale(scale, lo: float = 0.001, hi: float = 1000.0,
                default: float = 1.0) -> torch.Tensor:
    """Sanity clamp (reference depth_to_reconstruction.py:315-319)."""
    scale = torch.as_tensor(scale)
    ok = (scale > lo) & (scale < hi) & torch.isfinite(scale)
    return torch.where(ok, scale, default)


def ema_scale(avg_scale, new_scale, alpha: float = 0.7):
    """Running scale EMA avg = alpha*avg + (1-alpha)*new (reference :650)."""
    return alpha * avg_scale + (1.0 - alpha) * new_scale


class DepthScaleEstimator:
    """Reference-named facade (depth_enhanced_reconstruction.py:652-697):
    estimate_scale(sparse_3d, sparse_2d, depth_map, K) -> float, computed on
    ``device`` (``None``: the CUDA device). K is accepted (the reference
    signature takes it) and unused (so does the reference)."""

    def __init__(self, min_points: int = 5, min_valid: int = 3,
                 device=None):
        self.min_points = min_points
        self.min_valid = min_valid
        self.device = resolve_device(device)

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def estimate_scale(self, sparse_points, sparse_2d, depth_map,
                       K=None) -> float:
        pts, uv, depth = (self._tensor(a) for a in
                          (sparse_points, sparse_2d, depth_map))
        if pts.shape[0] == 0:
            return 1.0
        mask = torch.ones(pts.shape[0], dtype=torch.bool, device=self.device)
        return float(estimate_scale(pts, uv, mask, depth,
                                    min_points=self.min_points,
                                    min_valid=self.min_valid))
