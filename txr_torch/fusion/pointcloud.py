"""Dense point-cloud generation and merging, the counterpart of
``txr/fusion/pointcloud.py``.

Per-frame back-projection with pose and scale, and the Open3D-style merge
(reference depth_to_reconstruction.py:274-420): concatenate -> voxel
downsample -> statistical outlier removal. Every stage takes and returns
fixed-capacity PointSets on the device; compaction happens only at the
host boundary.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.types import PointSet
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.outlier import (remove_statistical_outliers,
                                   remove_statistical_outliers_grid)
from txr_torch.ops.voxel import voxel_downsample


def backproject_views(depths: torch.Tensor, bgrs: torch.Tensor,
                      Rs: torch.Tensor, ts: torch.Tensor,
                      scales: torch.Tensor, keep: torch.Tensor, fx, fy, cx,
                      cy, min_depth, max_depth, subsample: int):
    """Back-project a stack of views (depths (V, H, W), BGR (V, H, W, 3),
    world -> camera poses (V, 3, 3) / (V, 3), scales (V,)) into one flat
    world-frame PointSet; views with ``keep`` False contribute no point.
    Returns (points, per-view counts (V,))."""
    ps = backproject_world(depths, bgrs.flip(-1), Rs, ts, fx, fy, cx, cy,
                           min_depth, max_depth, scales[:, None, None],
                           subsample)
    m = ps.mask & keep[:, None]
    flat = PointSet(ps.xyz.reshape(-1, 3), ps.rgb.reshape(-1, 3),
                    m.reshape(-1))
    return flat, m.sum(dim=1)


def depth_to_pointcloud(depth: np.ndarray, bgr: np.ndarray, R: np.ndarray,
                        t: np.ndarray, fx: float, fy: float, cx: float,
                        cy: float, scale: float = 1.0, subsample: int = 2,
                        min_depth: float = 0.1, max_depth: float = 50.0,
                        device=None) -> PointSet:
    """Back-project one frame into a world-frame PointSet on ``device``.

    Mirrors DenseReconstructor.depth_to_pointcloud
    (depth_to_reconstruction.py:328-384): depth * scale, subsampled grid,
    validity range, camera -> world via R^T (P - t); BGR -> RGB.
    """
    dev = resolve_device(device)
    rgb = torch.as_tensor(np.asarray(bgr)).to(dev).flip(-1)
    return backproject_world(
        torch.as_tensor(np.asarray(depth)).to(dev), rgb,
        torch.as_tensor(np.asarray(R, np.float32)).to(dev),
        torch.as_tensor(np.asarray(t, np.float32).reshape(3)).to(dev),
        fx, fy, cx, cy, min_depth, max_depth, scale, subsample)


def merge_pointclouds(clouds: Sequence[Tuple[np.ndarray, np.ndarray]],
                      voxel_size: float = 0.005, outlier_neighbors: int = 20,
                      outlier_std_ratio: float = 2.0,
                      remove_outliers: bool = True, device=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate -> voxel downsample -> statistical outlier removal.

    Takes host (xyz, rgb[0..1]) pairs, pads the concatenation to a
    power-of-two capacity (at least 1024, as ``txr``'s shape buckets) and
    returns compacted host arrays with colours scaled to 0..255 like the
    reference's merge output (depth_to_reconstruction.py:386-420). Above
    2^17 rows the outlier pass takes the grid kNN with a cell of 2.5 voxels.
    """
    dev = resolve_device(device)
    # pairs filtered together: a cloud with points but no colours gets
    # zero colours rather than desynchronising the two concatenations
    xs, cs = [], []
    for x, c in clouds:
        x = np.asarray(x)
        if not len(x):
            continue
        xs.append(x)
        c = np.asarray(c)
        cs.append(c if len(c) == len(x) else np.zeros((len(x), 3), np.float32))
    if not xs:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    xyz = np.concatenate(xs).astype(np.float32)
    rgb = np.concatenate(cs).astype(np.float32)
    if rgb.max() > 1.5:  # tolerate 0..255 inputs
        rgb = rgb / 255.0

    cap = 1 << max(10, int(np.ceil(np.log2(max(len(xyz), 1)))))
    ps = voxel_downsample(PointSet.from_numpy(xyz, rgb, capacity=cap,
                                              device=dev), voxel_size)
    if remove_outliers:
        if cap > (1 << 17):
            ps = remove_statistical_outliers_grid(
                ps, cell=2.5 * voxel_size, nb_neighbors=outlier_neighbors,
                std_ratio=outlier_std_ratio)
        else:
            ps = remove_statistical_outliers(ps, outlier_neighbors,
                                             outlier_std_ratio)
    out_xyz, out_rgb = ps.to_numpy()
    return out_xyz, out_rgb * 255.0


class DensePointCloudGenerator:
    """Reference-named facade (depth_enhanced_reconstruction.py:535-645):
    depth_to_pointcloud with an (R, t) pose, and a merge (voxel downsample
    only: this script's merge has no statistical-outlier pass)."""

    def __init__(self, K: np.ndarray, min_depth: float = 0.1,
                 max_depth: float = 100.0, device=None):
        self.K = np.asarray(K, np.float64)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.device = resolve_device(device)

    def depth_to_pointcloud(self, depth, color, R=None, t=None,
                            scale: float = 1.0, subsample: int = 4):
        R = np.eye(3) if R is None else np.asarray(R)
        t = np.zeros(3) if t is None else np.asarray(t).reshape(3)
        ps = depth_to_pointcloud(
            depth, color, R, t, *(float(v) for v in self.K[[0, 1, 0, 1],
                                                           [0, 1, 2, 2]]),
            scale=scale, subsample=subsample,
            min_depth=self.min_depth, max_depth=self.max_depth,
            device=self.device)
        xyz, rgb = ps.to_numpy()
        return xyz, rgb * 255.0

    def merge_pointclouds(self, clouds, voxel_size: float = 0.005):
        return merge_pointclouds(clouds, voxel_size=voxel_size,
                                 remove_outliers=False, device=self.device)
