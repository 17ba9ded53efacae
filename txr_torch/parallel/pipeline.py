"""Data-parallel depth -> fusion over a (dp, tp) mesh, the counterpart of
``txr/parallel/pipeline.py``.

Frames split over dp; the ViT runs tensor-parallel over tp when the model
was laid out by ``txr_torch.parallel.mesh.shard_params``; every dp rank
back-projects its own frames and keeps a local offset voxel map; the local
maps combine with the exact weighted merge
(``txr_torch.fusion.offset_map.offset_map_merge``). ``txr`` stacks the
per-shard maps into one (dp, C) array sharded over dp; here each rank holds
its own map, ``stack_sharded_maps`` gathers them into that (dp, C) stack,
and ``merge_sharded_maps`` folds a stack exactly as ``txr`` does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from txr_torch.core.device import device_constant
from txr_torch.core.precision import kernel_autocast
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (NCOLS, OffsetVoxelMap,
                                         create_offset_map, offset_map_insert,
                                         offset_map_merge)
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def create_sharded_maps(mesh, capacity: int,
                        voxel_size: float) -> OffsetVoxelMap:
    """This rank's empty map (its row of ``txr``'s (dp, C) stack)."""
    return create_offset_map(capacity, voxel_size, device=mesh_device(mesh))


def make_sharded_fusion_step(model: Callable[[torch.Tensor], torch.Tensor],
                             intrinsics: Tuple[float, float, float, float],
                             min_depth: float = 1e-4,
                             max_depth: float = 1e6):
    """``step(frames, Rs, ts, scales, vm) -> vm`` on this rank's dp slice
    (``txr``'s step without its mesh argument: the model carries its tp
    layout, and each rank passes its own slice and map).

    frames: (B, H, W, 3) float RGB in [0, 1] at the model's operating size
    (this rank's slice, ``shard_batch``); ImageNet normalization happens
    inside the step. Rs, ts, scales: (B, 3, 3), (B, 3), (B,) per-frame
    world -> camera poses and depth scales. vm: this rank's map
    (``create_sharded_maps``), returned updated; as in ``txr`` the map
    passed in is consumed. Depth runs batched (tp-parallel when the model
    is laid out so), back-projection batched, one insert per step."""
    fx, fy, cx, cy = intrinsics

    @torch.no_grad()
    def step(frames, Rs, ts, scales, vm: OffsetVoxelMap) -> OffsetVoxelMap:
        dev = frames.device
        mean = device_constant(np.asarray(IMAGENET_MEAN, np.float32), dev)
        std = device_constant(np.asarray(IMAGENET_STD, np.float32), dev)
        xn = (frames - mean) / std
        with kernel_autocast(dev.type):
            depth = model(xn)
        ps = backproject_world(depth.float(), frames, Rs, ts, fx, fy, cx, cy,
                               min_depth, max_depth,
                               scales.to(torch.float32).reshape(-1, 1, 1), 1)
        n = ps.xyz.shape[0] * ps.xyz.shape[1]
        flat = PointSet(ps.xyz.reshape(n, 3), ps.rgb.reshape(n, 3),
                        ps.mask.reshape(n))
        return offset_map_insert(vm, flat)

    return step


def stack_sharded_maps(vm: OffsetVoxelMap, mesh) -> OffsetVoxelMap:
    """Every dp rank's map gathered into one (dp, C) stack in rank order
    (a collective over dp; every rank gets the stack)."""
    group = mesh["dp"].get_group()
    dp = mesh["dp"].size()
    cols = []
    for col in vm[:NCOLS]:
        parts = [torch.empty_like(col) for _ in range(dp)]
        dist.all_gather(parts, col.contiguous(), group=group)
        cols.append(torch.stack(parts))
    return OffsetVoxelMap(*cols, vm.voxel_size)


def merge_sharded_maps(vms: OffsetVoxelMap) -> OffsetVoxelMap:
    """Fold a (dp, C) map stack into one map with the exact weighted
    merge, pairwise in ``txr``'s order: (0, 1), (2, 3), ..., the odd one
    carried to the next round. The merged f32 sums depend on that order."""
    dp = vms.khi.shape[0]
    maps = [OffsetVoxelMap(*[c[i] for c in vms[:NCOLS]], vms.voxel_size)
            for i in range(dp)]
    while len(maps) > 1:
        nxt = [offset_map_merge(maps[i], maps[i + 1])
               for i in range(0, len(maps) - 1, 2)]
        if len(maps) % 2:
            nxt.append(maps[-1])
        maps = nxt
    return maps[0]
