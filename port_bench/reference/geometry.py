"""Back-projection of a depth grid to world points, in plain PyTorch.

Pixel (u, v) of depth d gives the camera point ((u - cx) / fx * d,
(v - cy) / fy * d, d); it is valid where min_depth < d < max_depth and d is
finite, and an invalid row is all zeros. With the pose (R, t) mapping world
to camera, the world point is R^T (X - t), summed over the three rows of R
in order. ``dtype`` float32 is the reference; a lower type is a control.
"""

from __future__ import annotations

import torch


def backproject_world(depth: torch.Tensor, colour: torch.Tensor,
                      R: torch.Tensor, t: torch.Tensor, intr: tuple,
                      depth_range: tuple, dtype=torch.float32) -> tuple:
    """depth (B, h, w), colour (B, h, w, 3), R (B, 3, 3), t (B, 3), intr
    (fx, fy, cx, cy) at the grid -> (xyz (B*h*w, 3), rgb (B*h*w, 3), mask
    (B*h*w,)); xyz in float32, computed in ``dtype``."""
    fx, fy, cx, cy = intr
    lo, hi = depth_range
    b, h, w = depth.shape
    d = depth.to(dtype)
    u = torch.arange(w, device=d.device, dtype=dtype).view(1, 1, w)
    v = torch.arange(h, device=d.device, dtype=dtype).view(1, h, 1)
    cam = torch.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], dim=-1)
    mask = (d > lo) & (d < hi) & torch.isfinite(d)
    rel = cam - t.to(dtype).view(b, 1, 1, 3)
    Rt = R.to(dtype)
    world = (rel[..., 0:1] * Rt[:, None, None, 0, :]
             + rel[..., 1:2] * Rt[:, None, None, 1, :]
             + rel[..., 2:3] * Rt[:, None, None, 2, :])
    zero = torch.zeros((), dtype=dtype, device=d.device)
    world = torch.where(mask[..., None], world, zero).to(torch.float32)
    rgb = torch.where(mask[..., None], colour.to(dtype).to(torch.float32),
                      torch.zeros((), device=d.device))
    return (world.reshape(-1, 3), rgb.reshape(-1, 3), mask.reshape(-1))
