"""Depth -> 3D back-projection, the counterpart of ``txr/ops/backproject.py``.

Masking follows the reference semantics (min_depth < d < max_depth, finite),
masked rows are zeroed, and the camera->world transform is
``X_w = R^T (X_c - t)``. The functions take one frame ``(H, W)`` or, with
the batch axis written out, a stack ``(B, H, W)``; a stack returns a
PointSet whose tensors keep the leading batch axis.

Everything here is elementwise f32: the world transform is written as three
scaled adds rather than a matrix product, so no reduced-precision matmul
mode of the card can touch the geometry.
"""

from __future__ import annotations

import torch

from txr_torch.core.types import PointSet


def backproject(depth: torch.Tensor, rgb: torch.Tensor, fx, fy, cx, cy,
                min_depth=0.1, max_depth=50.0, depth_scale=1.0,
                stride: int = 1) -> PointSet:
    """Back-project a depth map to a camera-frame PointSet.

    Args:
      depth: (H, W) or (B, H, W) depth.
      rgb:   (H, W, 3) or (B, H, W, 3) uint8 or float RGB image.
      fx, fy, cx, cy: intrinsics (Python scalars or 0-d tensors).
      min_depth, max_depth: validity range in meters.
      depth_scale: multiplicative scale applied to depth (metric anchor).
      stride: pixel subsampling factor.

    Returns:
      PointSet with capacity ceil(H/stride) * ceil(W/stride) (per frame).
    """
    d = depth[..., ::stride, ::stride].to(torch.float32) * depth_scale
    c = rgb[..., ::stride, ::stride, :]
    integer = not c.is_floating_point()
    c = c.to(torch.float32)
    if integer:
        c = c / 255.0
    h, w = d.shape[-2:]
    dev = d.device

    vv = (torch.arange(h, dtype=torch.float32, device=dev) * stride)[:, None]
    uu = (torch.arange(w, dtype=torch.float32, device=dev) * stride)[None, :]

    x = (uu - cx) / fx * d
    y = (vv - cy) / fy * d
    valid = (d > min_depth) & (d < max_depth) & torch.isfinite(d)

    lead = d.shape[:-2]
    xyz = torch.stack([x, y, d], dim=-1).reshape(*lead, h * w, 3)
    col = c.reshape(*lead, h * w, 3)
    mask = valid.reshape(*lead, h * w)
    zero = xyz.new_zeros(())
    xyz = torch.where(mask[..., None], xyz, zero)
    col = torch.where(mask[..., None], col, zero)
    return PointSet(xyz=xyz, rgb=col, mask=mask)


def transform_to_world(points: PointSet, R: torch.Tensor, t: torch.Tensor
                       ) -> PointSet:
    """Camera-frame -> world-frame transform X_w = R^T (X_c - t), with
    (R, t) mapping world -> camera. R is (3, 3) and t (3,), or (B, 3, 3) and
    (B, 3) for a batched PointSet."""
    R = R.to(torch.float32)
    d = points.xyz - t.to(torch.float32).reshape(*t.shape[:-1], 1, 3)
    # rowwise (X - t) @ R as three scaled adds (exact f32, no matmul)
    xyz = (d[..., 0:1] * R[..., None, 0, :] + d[..., 1:2] * R[..., None, 1, :]
           + d[..., 2:3] * R[..., None, 2, :])
    xyz = torch.where(points.mask[..., None], xyz, xyz.new_zeros(()))
    return PointSet(xyz=xyz, rgb=points.rgb, mask=points.mask)


def backproject_world(depth, rgb, R, t, fx, fy, cx, cy, min_depth=0.1,
                      max_depth=50.0, depth_scale=1.0, stride: int = 1
                      ) -> PointSet:
    """Back-projection followed by the world transform."""
    pts = backproject(depth, rgb, fx, fy, cx, cy, min_depth, max_depth,
                      depth_scale, stride)
    return transform_to_world(pts, R, t)


# The batched form is the same code: the batch axis is written out above.
backproject_batch = backproject
