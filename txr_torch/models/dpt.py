"""DPT head (Depth Anything neck + depth-estimation head), the counterpart
of ``txr/models/dpt.py``.

Reassemble (project + resize per stage), 3x3 scratch convs, top-down feature
fusion with pre-activation residual units and align_corners=True bilinear
upsampling, then the 3-conv output head with ReLU (relative) or
Sigmoid*max_depth (metric) activation. The output tail (upsample + conv2 +
ReLU + conv3) goes through ``txr_torch.ops.dpt_tail.fused_head_tail``. Every
other bilinear resize (the fusion blocks', the unfused tail's) goes through
``txr_torch.ops.upsample.upsample_bilinear`` (``_bilinear``). With
``fused_convs`` the 3x3 convs of the residual units on the large maps and
the output head's conv1 go through ``txr_torch.ops.conv_stripe``. Every
other conv is ``F.conv2d`` / ``F.conv_transpose2d`` through ``nn`` modules,
as ``txr`` leaves them to its compiler.

With ``DPTConfig.dual`` the head is Depth Anything 3's dual DPT (not in
``txr``): the projections, resizes and scratch convs are shared; a second
fusion stack (``ray_fusion_*``) and output tail (``ray_conv*``) give 7
channels beside the depth branch's 2, each tail through the tail kernel
(or not, as ``fused_head`` says). ``forward`` then returns a dict: depth
exp(y0), its confidence 1 + exp(y1), rays (B, H, W, 6) and their
confidence 1 + exp(y6), in float32.

VGGT's heads (``models/vggt.py:VGGTHead``, not in ``txr``) subclass
``DPTHead``: ``DPTConfig.special_tokens`` says how many tokens precede the
patches, ``relu_skip`` makes the residual units add their branch to
relu(x), and the head overrides the projection (``_project``), the
unfused tail (``_tail``), the fused tail's position term
(``tail_position_term``, None here) and the activations (``_outputs``).

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
from txr_torch.ops.dpt_tail import fused_head_tail, pack_conv2
from txr_torch.ops.upsample import upsample_bilinear
from txr_torch.utils.profiling import count, span

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
    # Depth Anything 3's dual head: a depth branch of 2 channels and a ray
    # branch of 7 (metric is then not read)
    dual: bool = False
    # tokens before the patches in each hidden state (the cls token;
    # VGGT's camera token and 4 registers)
    special_tokens: int = 1
    # the residual units add their branch to relu(x), not to x (VGGT's
    # units rectify their input in place)
    relu_skip: bool = False

# channels of the dual head's two outputs
DEPTH_CHANNELS, RAY_CHANNELS = 2, 7


def _bilinear(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """``ops.upsample``: ``F.interpolate``'s bilinear resize, one kernel on
    the card; counts ``models.upsample_kernel_calls`` or
    ``models.upsample_plain_calls``, one a call."""
    count("models.upsample_plain_calls" if x.device.type == "cpu"
          else "models.upsample_kernel_calls", 1)
    return upsample_bilinear(x, size, align_corners)


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    return weight.permute(2, 3, 1, 0)


def _packed(weight: torch.Tensor) -> torch.Tensor:
    return pack_weight(_hwio(weight))


def _f32(param: torch.Tensor) -> torch.Tensor:
    return param.to(torch.float32).reshape(-1).contiguous()


def _tail_w2(weight: torch.Tensor) -> torch.Tensor:
    """conv2's OIHW weight -> the tail kernel's (9, F, C) bf16."""
    return pack_conv2(_hwio(weight))


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


class PixelShuffleUp(nn.Module):
    """A transposed conv with stride equal to its kernel, written as one
    (B*H*W, C) x (C, k*k*F) product and a pixel shuffle (``txr``'s
    ``PixelShuffleUp``). Its parameters are ``nn.ConvTranspose2d``'s,
    ``weight`` (C, F, k, k) and ``bias`` (F,), as ``txr``'s tree is
    ``nn.ConvTranspose``'s, so converted weights load unchanged. NCHW in,
    NCHW out, like the layer it stands for; the head keeps
    ``nn.ConvTranspose2d``, as ``txr``'s does."""

    def __init__(self, in_features: int, features: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(
            torch.empty(in_features, features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        k = self.kernel
        f = self.weight.shape[1]
        y = x.permute(0, 2, 3, 1).reshape(b * h * w, c) @ self.weight.reshape(
            c, f * k * k)
        y = y.reshape(b, h, w, f, k, k).permute(0, 3, 1, 4, 2, 5)
        return y.reshape(b, f, h * k, w * k) + self.bias.reshape(1, f, 1, 1)


class ResidualConvUnit(nn.Module):
    """x + conv2(relu(conv1(relu(x)))); with ``relu_skip`` relu(x) + the
    same branch (VGGT's units run ``nn.ReLU(inplace=True)`` on their
    input, so their skip adds the rectified input)."""

    def __init__(self, features: int, relu_skip: bool = False):
        super().__init__()
        self.conv1 = Conv3x3(features, features)
        self.conv2 = Conv3x3(features, features)
        self.relu_skip = relu_skip

    def forward(self, x, fused: bool = False):
        if fused:
            # channels_last memory IS contiguous NHWC: both permutes are views
            h = self.conv1.fused(x.permute(0, 2, 3, 1), True)
            h = self.conv2.fused(h, True)
            skip = F.relu(x) if self.relu_skip else x
            return skip + h.permute(0, 3, 1, 2)
        r = F.relu(x)
        h = self.conv1(r)
        h = self.conv2(F.relu(h))
        return (r if self.relu_skip else x) + h


class FeatureFusionBlock(nn.Module):
    """``has_residual`` is False for the deepest block, whose rcu1 never
    runs (``txr``'s tree holds no parameters for it either)."""

    def __init__(self, features: int, has_residual: bool = True,
                 fused: bool = False, relu_skip: bool = False):
        super().__init__()
        self.fused = fused
        if has_residual:
            self.rcu1 = ResidualConvUnit(features, relu_skip)
        self.rcu2 = ResidualConvUnit(features, relu_skip)
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
        rs = c.relu_skip
        self.fusion_3 = FeatureFusionBlock(c.features, has_residual=False,
                                           fused=fconv, relu_skip=rs)
        self.fusion_2 = FeatureFusionBlock(c.features, fused=fconv,
                                           relu_skip=rs)
        self.fusion_1 = FeatureFusionBlock(c.features, fused=fconv,
                                           relu_skip=rs)
        self.fusion_0 = FeatureFusionBlock(c.features, fused=fconv,
                                           relu_skip=rs)
        self.head_conv1 = Conv3x3(c.features, c.features // 2)
        self.head_conv2 = nn.Conv2d(c.features // 2, c.head_hidden, 3,
                                    padding=1)
        self.head_conv3 = nn.Conv2d(c.head_hidden,
                                    DEPTH_CHANNELS if c.dual else 1, 1)
        if c.dual:
            self.ray_fusion_3 = FeatureFusionBlock(
                c.features, has_residual=False, fused=fconv)
            self.ray_fusion_2 = FeatureFusionBlock(c.features, fused=fconv)
            self.ray_fusion_1 = FeatureFusionBlock(c.features, fused=fconv)
            self.ray_fusion_0 = FeatureFusionBlock(c.features, fused=fconv)
            self.ray_conv1 = Conv3x3(c.features, c.features // 2)
            self.ray_conv2 = nn.Conv2d(c.features // 2, c.head_hidden, 3,
                                       padding=1)
            self.ray_conv3 = nn.Conv2d(c.head_hidden, RAY_CHANNELS, 1)
        # the tail kernel's operands of each branch, derived once per
        # parameter version
        self._tail_ops = {
            prefix: tuple(Derived(fn) for fn in (_tail_w2, _f32, _f32, _f32))
            for prefix in (("head_conv", "ray_conv") if c.dual
                           else ("head_conv",))}
        self.span_name = "models.head"

    def tail_operands(self, prefix: str = "head_conv"
                      ) -> Tuple[torch.Tensor, ...]:
        """``ops.dpt_tail.pack_params`` of a branch's conv2 / conv3
        (``prefix`` ``"head_conv"`` or, in the dual head, ``"ray_conv"``),
        kept until a parameter changes."""
        conv2, conv3 = (getattr(self, f"{prefix}{i}") for i in (2, 3))
        return tuple(d.get(t) for d, t in zip(
            self._tail_ops[prefix],
            (conv2.weight, conv2.bias, conv3.weight, conv3.bias)))

    def tail_position_term(self, prefix: str, out_h: int, out_w: int
                           ) -> Optional[torch.Tensor]:
        """The ``pos_term`` the tail kernel adds to the branch's conv2
        output at an (out_h, out_w) map; None: no term (a VGGT head has
        one)."""
        return None

    def _fuse(self, feats, prefix: str) -> torch.Tensor:
        """Top-down fusion (refinenet4 -> refinenet1). Each block upsamples
        to the next stage's spatial size (HF fusion_stage semantics)."""
        f1, f2, f3, f4 = feats
        y = getattr(self, prefix + "3")(f4, size=f3.shape[2:])
        y = getattr(self, prefix + "2")(y, f3, size=f2.shape[2:])
        y = getattr(self, prefix + "1")(y, f2, size=f1.shape[2:])
        return getattr(self, prefix + "0")(y, f1)

    def _tail(self, y, prefix: str, out_h: int, out_w: int):
        """The unfused output tail of the branch ``prefix``: conv1,
        upsample to the output size, conv2, ReLU, conv3; (B, channels,
        out_h, out_w)."""
        conv1, conv2, conv3 = (getattr(self, f"{prefix}{i}")
                               for i in (1, 2, 3))
        y = conv1(y)
        y = _bilinear(y, (out_h, out_w), align_corners=True)
        y = F.relu(conv2(y))
        return conv3(y)

    def _tail_fused(self, y, prefix: str, out_h: int, out_w: int):
        """conv1, then the tail kernel on its NHWC output: (B, out_h,
        out_w) for one output channel, (B, out_h, out_w, channels) for
        more."""
        conv1, conv2, conv3 = (getattr(self, f"{prefix}{i}")
                               for i in (1, 2, 3))
        # channels_last memory IS contiguous NHWC: the permute is a view and
        # contiguous() copies only if the conv chose another format.
        if self.cfg.fused_convs:
            x = conv1.fused(y.permute(0, 2, 3, 1), False)
        else:
            x = conv1(y).permute(0, 2, 3, 1).contiguous()
        # (3, 3, C, F) and (1, 1, F, channels)
        return fused_head_tail(
            x, conv2.weight.permute(2, 3, 1, 0), conv2.bias,
            conv3.weight.permute(2, 3, 1, 0), conv3.bias, out_h, out_w,
            self.tail_operands(prefix) if x.is_cuda else None,
            self.tail_position_term(prefix, out_h, out_w))

    def _branch(self, feats, fusion: str, prefix: str, out_h: int,
                out_w: int):
        """A branch of several output channels: its fusion stack and tail,
        (B, out_h, out_w, channels) in float32."""
        y = self._fuse(feats, fusion)
        if self.cfg.fused_head is False:
            return self._tail(y, prefix, out_h, out_w).permute(
                0, 2, 3, 1).float()
        return self._tail_fused(y, prefix, out_h, out_w).float()

    def _dual(self, feats, out_h: int, out_w: int) -> dict:
        y = self._branch(feats, "fusion_", "head_conv", out_h, out_w)
        with span("models.head.ray", feats[0]):
            r = self._branch(feats, "ray_fusion_", "ray_conv", out_h, out_w)
        return {"depth": y[..., 0].exp(), "confidence": 1 + y[..., 1].exp(),
                "rays": r[..., :6], "ray_confidence": 1 + r[..., 6].exp()}

    def _project(self, i: int, x: torch.Tensor, ph: int,
                 pw: int) -> torch.Tensor:
        """Stage ``i``'s projection of the patch tokens (B, ph*pw, D):
        (B, out_channels[i], ph, pw)."""
        x = x.reshape(x.shape[0], ph, pw, x.shape[-1]).permute(0, 3, 1, 2)
        return getattr(self, f"project_{i}")(x)

    def _outputs(self, feats, out_h: int, out_w: int):
        """The fusion stack(s) and output tail(s) on the reassembled
        features: depth (B, out_h, out_w), or the dual head's dict."""
        c = self.cfg
        if c.dual:
            return self._dual(feats, out_h, out_w)
        y = self._fuse(feats, "fusion_")
        if c.fused_head is False:
            y = self._tail(y, "head_conv", out_h, out_w)[:, 0]
        else:
            y = self._tail_fused(y, "head_conv", out_h, out_w)
        if c.metric:
            return torch.sigmoid(y) * c.max_depth
        return F.relu(y)

    def forward(self, hidden_states: List[torch.Tensor], ph: int, pw: int,
                patch_size: int = 14):
        """hidden_states: 4 x (B, special_tokens + ph*pw, D) from the
        encoder (the special tokens first).

        Returns depth (B, ph*patch_size, pw*patch_size), or the dict of
        the outputs (``dual``, a VGGT head).
        """
        c = self.cfg
        with span(self.span_name, hidden_states[0]):
            feats = []
            # Reassemble: drop the special tokens, reshape to maps,
            # project, resize per stage.
            for i, hs in enumerate(hidden_states):
                x = self._project(i, hs[:, c.special_tokens:], ph, pw)
                if i == 0:      # 4x up
                    x = self.resize_0(x)
                elif i == 1:    # 2x up
                    x = self.resize_1(x)
                elif i == 3:    # 2x down
                    x = self.resize_3(x)
                feats.append(getattr(self, f"scratch_{i}")(x))
            return self._outputs(feats, ph * patch_size, pw * patch_size)
