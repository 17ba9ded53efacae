"""The system under test: the port's public calls, and nothing else of it.

This is the only module of the benchmark that imports ``txr_torch``. A
step is the repo's main path (``bench.py:105-139`` on the port):
``ops.resize.resize_bicubic`` to the model grid and ImageNet
normalisation, ``DepthAnything.forward`` in bfloat16,
``ops.backproject.backproject_world`` with each frame's pose, and
``fusion.offset_map.offset_map_insert``.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (create_offset_map,
                                         offset_map_insert)
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD, resize_bicubic


def build(cfg: dict, weights: dict, device, quant: str = "none"
          ) -> DepthAnything:
    """The configuration's model on ``device`` holding ``weights`` in
    bfloat16 (``quant``: the port's int8 policy of the encoder's dense
    layers, for the control)."""
    vit = ViTConfig(hidden_size=cfg["hidden_size"],
                    num_layers=cfg["num_hidden_layers"],
                    num_heads=cfg["num_attention_heads"],
                    patch_size=cfg["patch_size"],
                    mlp_ratio=float(cfg["mlp_ratio"]),
                    layerscale_init=1.0,
                    pos_embed_size=cfg["pos_embed_grid"],
                    out_layers=tuple(cfg["out_indices"]), quant=quant)
    dpt = DPTConfig(features=cfg["features"],
                    out_channels=tuple(cfg["out_channels"]),
                    head_hidden=cfg["head_hidden"], metric=True,
                    max_depth=float(cfg["max_depth"]))
    with torch.device("meta"):
        model = DepthAnything(vit, dpt)
    model = model.to_empty(device=device).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(weights, strict=True)
    return model.eval()


class Step:
    """One step of the main path on a batch of frames. ``marks`` (a list of
    four callables or None) records a point before the preprocess, after
    the forward, after the back-projection and after the insert; ``scope``
    names a host range around each stage."""

    def __init__(self, model: DepthAnything, cfg: dict, traffic: dict,
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


def attention_modules(model: DepthAnything) -> list:
    """(qkv, proj) of each encoder block: attention proper runs between
    the end of the first and the start of the second."""
    enc = model.encoder
    return [(getattr(enc, f"block_{i}").attn.qkv,
             getattr(enc, f"block_{i}").attn.proj)
            for i in range(enc.cfg.num_layers)]

