"""The system under test: the port's public calls, and nothing else of it.

This module and the architecture files (``archs/*.py``, which build each
architecture's model from the port's public constructors) are the only
modules of the benchmark that import ``txr_torch``. A step is the repo's
main path (``bench.py:105-139`` on the port): ``ops.resize.resize_bicubic``
to the model grid (the architecture's ``model_grid``) and ImageNet
normalisation, the forward in bfloat16 of the model the architecture
builds, ``ops.backproject.backproject_world`` with each frame's pose, and
``fusion.offset_map.offset_map_insert``.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (create_offset_map,
                                         offset_map_insert)
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD, resize_bicubic


class Step:
    """One step of the main path on a batch of frames. ``marks`` (a list of
    four callables or None) records a point before the preprocess, after
    the forward, after the back-projection and after the insert; ``scope``
    names a host range around each stage."""

    def __init__(self, model: torch.nn.Module, cfg: dict, traffic: dict,
                 model_hw, device):
        self.model = model
        self.hw = model_hw
        cam = cfg["camera"]
        frame_h, frame_w = traffic["frame_hw"]
        sy, sx = model_hw[0] / frame_h, model_hw[1] / frame_w
        self.intr = (cam["fx"] * sx, cam["fy"] * sy, cam["cx"] * sx,
                     cam["cy"] * sy)
        self.depth_range = tuple(cfg["depth_range_m"])
        self.mean = torch.tensor(IMAGENET_MEAN, device=device)
        self.std = torch.tensor(IMAGENET_STD, device=device)

    @torch.no_grad()
    def __call__(self, frames_u8, R, t, vm, marks=None, scope=None):
        scope = scope or (lambda name: nullcontext())
        mark = marks or (lambda i: None)
        mark(0)
        with scope("depth"):
            x = frames_u8.to(torch.float32) / 255.0
            xm = resize_bicubic(x, self.hw[0], self.hw[1],
                                align_corners=False)
            xn = ((xm - self.mean) / self.std).to(torch.bfloat16)
            depth = self.model(xn).to(torch.float32)
        mark(1)
        with scope("backproject"):
            ps = backproject_world(depth, xm, R, t, *self.intr,
                                   *self.depth_range, 1.0, 1)
            flat = PointSet(ps.xyz.reshape(-1, 3), ps.rgb.reshape(-1, 3),
                            ps.mask.reshape(-1))
        mark(2)
        with scope("insert"):
            new = offset_map_insert(vm, flat)
        mark(3)
        return new, depth, flat


def create_map(capacity: int, voxel: float, device):
    return create_offset_map(capacity, voxel, device=device)


def insert(vm, xyz, rgb, mask):
    return offset_map_insert(vm, PointSet(xyz, rgb, mask))


def map_columns(vm) -> tuple:
    return tuple(vm[:4])
