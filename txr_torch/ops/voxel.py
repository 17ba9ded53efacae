"""Voxel-grid downsampling, the counterpart of ``txr/ops/voxel.py``.

Open3D-equivalent semantics (reference: depth_to_reconstruction.py:386-420
via ``o3d.voxel_down_sample``): all points falling in the same voxel of edge
``voxel_size`` are averaged (positions and colours). The reduction is the
sort-and-scan of ``ops/segment.py:sorted_voxel_reduce``: one segmented-scan
launch per reduce on the card. Output: one averaged point per occupied
voxel, compacted to the front in ascending voxel order; capacity equals the
input capacity.

Voxel coordinates divide by ``voxel_size`` held in a float32 tensor: on the
card PyTorch divides by a Python number by multiplying by its rounded
reciprocal, which moves a point on a voxel boundary into the next voxel.
"""

from __future__ import annotations

import torch

from txr_torch.core.types import PointSet
from txr_torch.ops.segment import INT_MAX, sorted_voxel_reduce

_BIG = 3.0e38


def f32_scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device (a tensor is
    cast), so that a division by it is a true division on every device."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=torch.float32, device=like.device)
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, voxel_size) -> tuple:
    """Integer voxel coords relative to the masked min-bound; invalid points
    get INT_MAX keys so they sort to the tail."""
    min_bound = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    return _keys_from(xyz, mask, min_bound, voxel_size)


def _keys_from(xyz, mask, origin, voxel_size) -> tuple:
    rel = torch.floor((xyz - origin) / f32_scalar(voxel_size, xyz))
    rel = torch.where(mask[:, None], rel.to(torch.int32), INT_MAX)
    return rel[:, 0], rel[:, 1], rel[:, 2]


def _weighted_cols(points: PointSet) -> tuple:
    m = points.mask[:, None]
    xyz = torch.where(m, points.xyz, 0.0)
    rgb = torch.where(m, points.rgb, 0.0)
    return (xyz[:, 0], xyz[:, 1], xyz[:, 2], rgb[:, 0], rgb[:, 1], rgb[:, 2],
            points.mask.to(torch.float32))


def _means(sums: tuple, is_seg: torch.Tensor) -> PointSet:
    sx, sy, sz, sr, sg, sb, cnt = sums
    valid = is_seg & (cnt > 0.0)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    out_xyz = torch.where(valid[:, None],
                          torch.stack([sx, sy, sz], dim=1) / denom, 0.0)
    out_rgb = torch.where(valid[:, None],
                          torch.stack([sr, sg, sb], dim=1) / denom, 0.0)
    return PointSet(xyz=out_xyz, rgb=out_rgb, mask=valid)


def voxel_sums(points: PointSet, voxel_size, origin: torch.Tensor):
    """Per-voxel SUMS keyed to an EXPLICIT origin (not the masked min).

    The building block of the chunked dense merge
    (``txr_torch.fusion.chunked_merge``): sums from disjoint view chunks
    keyed to the same global origin add associatively, so per-voxel means
    of the merged rows equal a single-pass ``voxel_downsample`` up to float
    summation order.

    Returns (keys (C, 3) int32, sums (C, 7) float32 [x y z r g b weight],
    valid (C,) bool, n_voxels (0-d)) — one row per occupied voxel,
    compacted to the front in ascending key order; invalid rows carry
    INT_MAX keys and zero sums so they can feed a second reduce unchanged.
    """
    kx, ky, kz = _keys_from(points.xyz, points.mask,
                            origin.to(points.xyz.device), voxel_size)
    okx, oky, okz, sums, is_seg = sorted_voxel_reduce(
        kx, ky, kz, _weighted_cols(points), capacity=points.capacity)
    valid = is_seg & (sums[6] > 0.0)
    keys = torch.where(valid[:, None], torch.stack([okx, oky, okz], dim=1),
                       INT_MAX)
    sums = torch.where(valid[:, None], torch.stack(sums, dim=1), 0.0)
    return keys, sums, valid, valid.sum(dtype=torch.int32)


def voxel_means_of_sums(keys: torch.Tensor, sums: torch.Tensor) -> PointSet:
    """Reduce (M, 3) int32 keys + (M, 7) float32 partial sums (INT_MAX keys
    on invalid rows) to per-voxel means. The second half of the chunked
    merge; output capacity = M."""
    cols = tuple(sums[:, j].contiguous() for j in range(7))
    _, _, _, osums, is_seg = sorted_voxel_reduce(
        keys[:, 0], keys[:, 1], keys[:, 2], cols, capacity=keys.shape[0])
    return _means(osums, is_seg)


def voxel_downsample(points: PointSet, voxel_size) -> PointSet:
    """Average points per voxel. Deterministic sorted-voxel output order."""
    kx, ky, kz = _voxel_keys(points.xyz, points.mask, voxel_size)
    _, _, _, sums, is_seg = sorted_voxel_reduce(
        kx, ky, kz, _weighted_cols(points), capacity=points.capacity)
    return _means(sums, is_seg)
