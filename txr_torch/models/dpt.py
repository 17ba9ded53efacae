"""DPT head (Depth Anything neck + depth-estimation head), the counterpart
of ``txr/models/dpt.py``.

Reassemble (project + resize per stage), 3x3 scratch convs, top-down feature
fusion with pre-activation residual units and align_corners=True bilinear
upsampling, then the 3-conv output head with ReLU (relative) or
Sigmoid*max_depth (metric) activation. The output tail (upsample + conv2 +
ReLU + conv3) goes through ``txr_torch.ops.dpt_tail.fused_head_tail``. With
``fused_convs`` the 3x3 convs of the residual units on the large maps and
the output head's conv1 go through ``txr_torch.ops.conv_stripe``. Every
other conv is ``F.conv2d`` / ``F.conv_transpose2d`` through ``nn`` modules,
as ``txr`` leaves them to its compiler.

The public interface keeps ``txr``'s layout: hidden states (B, 1+ph*pw, D)
in, depth (B, H, W) out. Inside, feature maps are NCHW tensors in
``channels_last`` memory, which is NHWC in memory, so the views between the
two cost no copy. Submodule names mirror ``txr``'s parameter tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from txr_torch.core.derived import Derived
from txr_torch.ops.conv_stripe import conv3x3_stripe, pack_weight
from txr_torch.ops.dpt_tail import fused_head_tail

# FeatureFusionBlock sends its residual units through the 3x3 conv kernel
# only on maps of at least this many pixels (txr's gate)
_FUSED_CONV_MIN_AREA = 96 * 96


@dataclass(frozen=True)
class DPTConfig:
    features: int = 64                       # fusion hidden size
    out_channels: Tuple[int, ...] = (48, 96, 192, 384)
    head_hidden: int = 32
    metric: bool = False
    max_depth: float = 20.0
    # fused_head: the fused resize+conv2+relu+conv3 output tail
    #   (txr_torch/ops/dpt_tail.py). None / True = on (the kernel on a CUDA
    #   tensor, its plain version on a CPU tensor); False = separate ops.
    # fused_convs: the 3x3 conv kernel (txr_torch/ops/conv_stripe.py) for the
    #   residual conv units on maps of at least 96 x 96 pixels and, when the
    #   fused tail is on too, for the output head's conv1. None / False = off.
    fused_head: Optional[bool] = None
    fused_convs: Optional[bool] = None


def _bilinear(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    return weight.permute(2, 3, 1, 0)


def _packed(weight: torch.Tensor) -> torch.Tensor:
    return pack_weight(_hwio(weight))


class Conv3x3(nn.Conv2d):
    """A 3x3, pad-1 ``nn.Conv2d`` (same parameters and state-dict keys) that
    can also run through the 3x3 conv kernel on NHWC activations."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)
        self._wp = Derived(_packed)

    def fused(self, x_nhwc: torch.Tensor, relu_in: bool) -> torch.Tensor:
        """conv(relu(x)) or conv(x) on (B, H, W, C) -> (B, H, W, F)."""
        packed = self._wp.get(self.weight) if x_nhwc.is_cuda else None
        return conv3x3_stripe(x_nhwc, _hwio(self.weight), self.bias, relu_in,
                              packed)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv3x3(features, features)
        self.conv2 = Conv3x3(features, features)

    def forward(self, x, fused: bool = False):
        if fused:
            # channels_last memory IS contiguous NHWC: both permutes are views
            h = self.conv1.fused(x.permute(0, 2, 3, 1), True)
            h = self.conv2.fused(h, True)
            return x + h.permute(0, 3, 1, 2)
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        return x + h


class FeatureFusionBlock(nn.Module):
    """``has_residual`` is False for the deepest block, whose rcu1 never
    runs (``txr``'s tree holds no parameters for it either)."""

    def __init__(self, features: int, has_residual: bool = True,
                 fused: bool = False):
        super().__init__()
        self.fused = fused
        if has_residual:
            self.rcu1 = ResidualConvUnit(features)
        self.rcu2 = ResidualConvUnit(features)
        self.project = nn.Conv2d(features, features, 1)

    def forward(self, x, residual=None, size=None):
        # the kernel pays off on the large maps only; the small fusion stages
        # stay on the library's conv (txr's gate)
        fuse = (self.fused
                and x.shape[2] * x.shape[3] >= _FUSED_CONV_MIN_AREA)
        if residual is not None:
            if residual.shape[2:] != x.shape[2:]:
                residual = _bilinear(residual, x.shape[2:],
                                     align_corners=False)
            x = x + self.rcu1(residual, fuse)
        x = self.rcu2(x, fuse)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        x = _bilinear(x, size, align_corners=True)
        return self.project(x)


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig, hidden_size: int):
        super().__init__()
        self.cfg = cfg
        c = cfg
        for i, oc in enumerate(c.out_channels):
            self.add_module(f"project_{i}", nn.Conv2d(hidden_size, oc, 1))
            self.add_module(f"scratch_{i}", nn.Conv2d(oc, c.features, 3,
                                                      padding=1, bias=False))
        self.resize_0 = nn.ConvTranspose2d(c.out_channels[0],
                                           c.out_channels[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(c.out_channels[1],
                                           c.out_channels[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(c.out_channels[3], c.out_channels[3], 3,
                                  stride=2, padding=1)
        fconv = bool(c.fused_convs)          # None / unset -> off
        self.fusion_3 = FeatureFusionBlock(c.features, has_residual=False,
                                           fused=fconv)
        self.fusion_2 = FeatureFusionBlock(c.features, fused=fconv)
        self.fusion_1 = FeatureFusionBlock(c.features, fused=fconv)
        self.fusion_0 = FeatureFusionBlock(c.features, fused=fconv)
        self.head_conv1 = Conv3x3(c.features, c.features // 2)
        self.head_conv2 = nn.Conv2d(c.features // 2, c.head_hidden, 3,
                                    padding=1)
        self.head_conv3 = nn.Conv2d(c.head_hidden, 1, 1)

    def forward(self, hidden_states: List[torch.Tensor], ph: int, pw: int,
                patch_size: int = 14) -> torch.Tensor:
        """hidden_states: 4 x (B, 1+ph*pw, D) from the encoder (cls first).

        Returns depth (B, ph*patch_size, pw*patch_size).
        """
        c = self.cfg
        feats = []
        # Reassemble: drop cls, reshape to maps, project, resize per stage.
        for i, hs in enumerate(hidden_states):
            b = hs.shape[0]
            x = hs[:, 1:].reshape(b, ph, pw, hs.shape[-1]).permute(0, 3, 1, 2)
            x = getattr(self, f"project_{i}")(x)
            if i == 0:      # 4x up
                x = self.resize_0(x)
            elif i == 1:    # 2x up
                x = self.resize_1(x)
            elif i == 3:    # 2x down
                x = self.resize_3(x)
            feats.append(getattr(self, f"scratch_{i}")(x))

        # Top-down fusion (refinenet4 -> refinenet1). Each block upsamples to
        # the next stage's spatial size (HF fusion_stage semantics).
        f1, f2, f3, f4 = feats
        y = self.fusion_3(f4, size=f3.shape[2:])
        y = self.fusion_2(y, f3, size=f2.shape[2:])
        y = self.fusion_1(y, f2, size=f1.shape[2:])
        y = self.fusion_0(y, f1)

        # Output head.
        out_h, out_w = ph * patch_size, pw * patch_size
        if c.fused_head is False:
            y = self.head_conv1(y)
            y = _bilinear(y, (out_h, out_w), align_corners=True)
            y = F.relu(self.head_conv2(y))
            y = self.head_conv3(y)[:, 0]
        else:
            # channels_last memory IS contiguous NHWC: the permute is a view
            # and contiguous() copies only if the conv chose another format.
            if c.fused_convs:
                x = self.head_conv1.fused(y.permute(0, 2, 3, 1), False)
            else:
                x = self.head_conv1(y).permute(0, 2, 3, 1).contiguous()
            w2 = self.head_conv2.weight.permute(2, 3, 1, 0)   # (3, 3, C, F)
            y = fused_head_tail(x, w2, self.head_conv2.bias,
                                self.head_conv3.weight.reshape(-1),
                                self.head_conv3.bias, out_h, out_w)
        if c.metric:
            return torch.sigmoid(y) * c.max_depth
        return F.relu(y)
