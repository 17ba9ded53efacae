"""The toy cross-view architecture (``archs/toy_crossview.py``) in plain
float32 PyTorch: a patch convolution, layers of attention over every token
of every view of the step (one sequence), residual, then a linear readout
of each token upsampled bilinearly to the model grid, sigmoid * max_depth.
A frame's depth depends on every frame of its step."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.depth_anything_v2 import exact_float32, preprocess


def depth(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
          ) -> torch.Tensor:
    """Normalised NCHW input of a whole step -> depth (B, h, w)."""
    c, heads, p = cfg["width"], cfg["heads"], cfg["patch_size"]
    b, _, h, wd = x.shape
    t = F.conv2d(x, w["stem.weight"], w["stem.bias"], stride=p)
    ph, pw = t.shape[2:]
    t = t.flatten(2).transpose(1, 2).reshape(1, -1, c)   # views in a row
    n = t.shape[1]
    for i in range(cfg["layers"]):
        k = f"views.{i}."
        qkv = F.linear(t, w[k + "qkv.weight"], w[k + "qkv.bias"])
        q, kk, v = qkv.reshape(1, n, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4)
        att = torch.softmax(q @ kk.transpose(-1, -2) *
                            (c // heads) ** -0.5, dim=-1)
        o = (att @ v).transpose(1, 2).reshape(1, n, c)
        t = t + F.linear(o, w[k + "out.weight"], w[k + "out.bias"])
    y = F.linear(t, w["readout.weight"], w["readout.bias"])
    y = y.reshape(b, ph, pw, 1).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(h, wd), mode="bilinear", align_corners=False)
    return torch.sigmoid(y[:, 0]) * cfg["max_depth"]


@torch.no_grad()
def reference(frames_u8: torch.Tensor, w: Dict[str, torch.Tensor],
              cfg: dict, model_hw, dtype: torch.dtype = torch.float32
              ) -> tuple:
    """A step's frames (B, H, W, 3) uint8 -> (depth (B, h, w) float32,
    colour image (B, h, w, 3)), all frames at once, with TF32 off."""
    wd = {k: v.to(dtype) for k, v in w.items()}
    with exact_float32():
        colour, x = preprocess(frames_u8, model_hw)
        d = depth(x.to(dtype), wd, cfg).to(torch.float32)
    return d, colour
