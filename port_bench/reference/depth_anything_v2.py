"""Depth Anything V2 with its metric head, in plain float32 PyTorch.

Written from the published architecture (DINOv2 ViT encoder, DPT head;
github.com/DepthAnything/Depth-Anything-V2, ``depth_anything_v2/dpt.py``,
``metric_depth``), in the layout of the Hugging Face port:

- preprocess: uint8 RGB / 255, bicubic resize (a = -0.75, no antialias,
  align_corners False) to the model grid, ImageNet mean and std;
- ViT: 14 x 14 patch conv, cls token, position embedding resized bicubically
  to the patch grid by size (Hugging Face's ``interpolate_pos_encoding``;
  the original code resizes by a scale factor with a 0.1 offset), pre-norm
  blocks (LayerNorm 1e-6, one qkv product, softmax(q k^T / sqrt(d)) v,
  exact GELU MLP, LayerScale), the final LayerNorm on each taken layer;
- DPT: per taken layer a 1 x 1 projection and the 4x / 2x / 1x / 0.5x
  resize, 3 x 3 scratch convs, four fusion blocks of pre-activation
  residual units with bilinear (align_corners True) upsampling, then
  conv 3 x 3, upsample to the input grid, conv 3 x 3, ReLU, conv 1 x 1,
  sigmoid * max_depth.

No kernel, no cache, no batching beyond the frames given: ``reference``,
the architecture's reference of a step (``archs/depth_anything_v2.py``),
takes the step's frames one at a time, since a frame's depth depends on
that frame alone, and turns off TF32 for its call.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def exact_float32():
    """float32 products and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def preprocess(frames_u8: torch.Tensor, model_hw) -> tuple:
    """(B, H, W, 3) uint8 -> (colour image (B, h, w, 3) in [0, 1] units,
    normalised NCHW input)."""
    x = frames_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    x = F.interpolate(x, size=tuple(model_hw), mode="bicubic",
                      align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return x.permute(0, 2, 3, 1), (x - mean) / std


def _ln(x, w, p):
    return F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"],
                        eps=1e-6)


def _lin(x, w, p):
    return F.linear(x, w[p + ".weight"], w[p + ".bias"])


def _conv(x, w, p, stride=1, padding=0, bias=True):
    return F.conv2d(x, w[p + ".weight"], w[p + ".bias"] if bias else None,
                    stride=stride, padding=padding)


def _up(x, size, align_corners):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def encoder(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
            ) -> List[torch.Tensor]:
    d, heads, p = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["patch_size"])
    hd = d // heads
    b, _, h, wd = x.shape
    ph, pw = h // p, wd // p
    t = _conv(x, w, "encoder.patch_embed", stride=p)          # (B, D, ph, pw)
    t = t.flatten(2).transpose(1, 2)
    pos = w["encoder.pos_embed"]
    g = cfg["pos_embed_grid"]
    if (ph, pw) != (g, g):
        grid = pos[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(ph, pw), mode="bicubic",
                             align_corners=False)
        pos = torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)
    t = torch.cat([w["encoder.cls_token"].expand(b, -1, -1), t], 1) + pos
    taken = {}
    for i in range(cfg["num_hidden_layers"]):
        k = f"encoder.block_{i}."
        y = _ln(t, w, k + "norm1")
        qkv = _lin(y, w, k + "attn.qkv").reshape(b, -1, 3, heads, hd)
        q, kk, v = qkv.permute(2, 0, 3, 1, 4)                 # (B, H, S, hd)
        att = torch.softmax(q @ kk.transpose(-1, -2) * hd ** -0.5, dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, -1, d)
        t = t + _lin(o, w, k + "attn.proj") * w[k + "ls1"]
        y = _ln(t, w, k + "norm2")
        y = _lin(F.gelu(_lin(y, w, k + "mlp.fc1")), w, k + "mlp.fc2")
        t = t + y * w[k + "ls2"]
        if i in cfg["out_indices"]:
            taken[i] = _ln(t, w, "encoder.norm")
    return [taken[i] for i in cfg["out_indices"]]


def _rcu(x, w, p):
    h = _conv(F.relu(x), w, p + ".conv1", padding=1)
    return x + _conv(F.relu(h), w, p + ".conv2", padding=1)


def _fusion(x, w, p, residual=None, size=None):
    if residual is not None:
        if residual.shape[2:] != x.shape[2:]:
            residual = _up(residual, x.shape[2:], False)
        x = x + _rcu(residual, w, p + ".rcu1")
    x = _rcu(x, w, p + ".rcu2")
    if size is None:
        size = (x.shape[2] * 2, x.shape[3] * 2)
    return _conv(_up(x, size, True), w, p + ".project")


def head(hidden: List[torch.Tensor], w: Dict[str, torch.Tensor], cfg: dict,
         ph: int, pw: int) -> torch.Tensor:
    feats = []
    for i, hs in enumerate(hidden):
        x = hs[:, 1:].transpose(1, 2).reshape(hs.shape[0], -1, ph, pw)
        x = _conv(x, w, f"head.project_{i}")
        if i == 0:
            x = F.conv_transpose2d(x, w["head.resize_0.weight"],
                                   w["head.resize_0.bias"], stride=4)
        elif i == 1:
            x = F.conv_transpose2d(x, w["head.resize_1.weight"],
                                   w["head.resize_1.bias"], stride=2)
        elif i == 3:
            x = _conv(x, w, "head.resize_3", stride=2, padding=1)
        feats.append(_conv(x, w, f"head.scratch_{i}", padding=1, bias=False))
    f1, f2, f3, f4 = feats
    y = _fusion(f4, w, "head.fusion_3", size=f3.shape[2:])
    y = _fusion(y, w, "head.fusion_2", f3, size=f2.shape[2:])
    y = _fusion(y, w, "head.fusion_1", f2, size=f1.shape[2:])
    y = _fusion(y, w, "head.fusion_0", f1)
    p = cfg["patch_size"]
    y = _conv(y, w, "head.head_conv1", padding=1)
    y = _up(y, (ph * p, pw * p), True)
    y = F.relu(_conv(y, w, "head.head_conv2", padding=1))
    y = _conv(y, w, "head.head_conv3")[:, 0]
    return torch.sigmoid(y) * cfg["max_depth"]


def depth(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
          ) -> torch.Tensor:
    """Normalised NCHW input -> metric depth (B, h, w)."""
    p = cfg["patch_size"]
    return head(encoder(x, w, cfg), w, cfg, x.shape[2] // p, x.shape[3] // p)


@torch.no_grad()
def reference(frames_u8: torch.Tensor, w: Dict[str, torch.Tensor],
              cfg: dict, model_hw, dtype: torch.dtype = torch.float32
              ) -> tuple:
    """Frames (B, H, W, 3) uint8 -> (depth (B, h, w) float32, colour
    image (B, h, w, 3)), one frame at a time, with TF32 off. ``dtype``
    other than float32 computes the network in that type (a control)."""
    wd = {k: v.to(dtype) for k, v in w.items()}
    depths, colours = [], []
    with exact_float32():
        for i in range(frames_u8.shape[0]):
            colour, x = preprocess(frames_u8[i:i + 1], model_hw)
            depths.append(depth(x.to(dtype), wd, cfg).to(torch.float32))
            colours.append(colour)
    return torch.cat(depths), torch.cat(colours)
