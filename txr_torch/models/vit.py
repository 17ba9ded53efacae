"""DINOv2-style ViT encoder (the Depth Anything backbone), the counterpart
of ``txr/models/vit.py``.

Patch-14 conv embedding, cls token, bicubically interpolated position
embeddings, pre-norm blocks with LayerScale, exact GELU, and a final
LayerNorm applied to each harvested intermediate hidden state. The fused qkv
projection stays one matrix product. Attention goes through
``txr_torch.ops.attention.fused_attention`` for an even head count and
through ``multi_head_attention`` on (B, H, S, D) views for an odd one, as in
``txr``. The large matrix products (qkv, proj, fc1, fc2, w12, w3, the patch
embedding) are ``nn.Linear`` / ``nn.Conv2d``, as ``txr`` leaves them to its
compiler, unless ``ViTConfig.quant`` selects an int8 policy for the block's
dense layers (``_dense``).

Submodule names mirror ``txr``'s parameter tree (``block_0`` ...,
``attn.qkv``, ``mlp.fc1``), so ``txr_torch.models.convert.from_txr_params``
is a walk over that tree. Activations are (B, S, D); pixels are NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from txr_torch.ops.attention import (fused_attention, multi_head_attention,
                                     split_heads)
from txr_torch.ops.quant import Int8Linear
from txr_torch.ops.quant_fused import Int8LinearFused
from txr_torch.ops.resize import resize_bicubic


@dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    patch_size: int = 14
    mlp_ratio: float = 4.0
    layerscale_init: float = 1.0
    pos_embed_size: int = 37          # grid side the stored pos embed was trained at
    use_swiglu: bool = False          # DINOv2-giant uses SwiGLU-fused FFN
    out_layers: Tuple[int, ...] = (2, 5, 8, 11)
    # True / None: attention through the kernel on a CUDA tensor and its
    # plain version on a CPU tensor; False: the plain version everywhere.
    use_flash: Optional[bool] = None
    # Dense layers of the blocks: "none" nn.Linear; "int8" W8A8 with the
    # product left to a library (txr_torch.ops.quant); "int8p" the fused
    # W8A8 kernel (txr_torch.ops.quant_fused); "int8mix" the kernel for
    # fc2 / w3 and "int8" elsewhere. The parameters are the same either way.
    quant: str = "none"


VIT_PRESETS = {
    "vits": ViTConfig(384, 12, 6, out_layers=(2, 5, 8, 11)),
    "vitb": ViTConfig(768, 12, 12, out_layers=(2, 5, 8, 11)),
    "vitl": ViTConfig(1024, 24, 16, out_layers=(4, 11, 17, 23)),
    # DINOv2-giant: mlp_ratio 4 with the SwiGLU 2/3-round-to-8 reduction
    # gives the checkpoint hidden size round8(1536*4*2/3) = 4096.
    "vitg": ViTConfig(1536, 40, 24, mlp_ratio=4.0, use_swiglu=True,
                      out_layers=(9, 19, 29, 39)),
}


QUANT_POLICIES = ("none", "int8", "int8p", "int8mix")


def _dense(quant: str, role: str = ""):
    """Linear layer class for the quant policy; identical parameters.

    ``txr``'s table: "int8" the library product everywhere, "int8p" the
    fused kernel everywhere, "int8mix" the fused kernel only for the role
    "fc2" (the reduction over the wide hidden dimension) and "int8"
    elsewhere.
    """
    if quant not in QUANT_POLICIES:
        raise ValueError(
            f"unknown quant policy {quant!r}; expected one of "
            f"{QUANT_POLICIES}")
    if quant == "int8" or (quant == "int8mix" and role != "fc2"):
        return Int8Linear
    if quant == "int8p" or (quant == "int8mix" and role == "fc2"):
        return Int8LinearFused
    return nn.Linear


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, quant: str = "none"):
        super().__init__()
        self.fc1 = _dense(quant, "fc1")(dim, hidden)
        self.fc2 = _dense(quant, "fc2")(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwiGLU(nn.Module):
    """SwiGLU-fused FFN (DINOv2 giant)."""

    def __init__(self, dim: int, hidden: int, out: int, quant: str = "none"):
        super().__init__()
        self.w12 = _dense(quant)(dim, 2 * hidden)
        # w3 contracts the wide hidden dimension: the fc2 role
        self.w3 = _dense(quant, "fc2")(hidden, out)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        dense = _dense(cfg.quant)
        self.qkv = dense(d, 3 * d)   # one fused matrix product
        self.proj = dense(d, d)

    def forward(self, x, kv_len: Optional[int] = None):
        c = self.cfg
        b, s, d = x.shape
        head_dim = d // c.num_heads
        qkv = self.qkv(x)
        if c.use_flash is not False and c.num_heads % 2 == 0:
            # the kernel reads the fused layout in place
            o = fused_attention(qkv, c.num_heads, head_dim, kv_len)
        else:
            q, k, v = split_heads(qkv, c.num_heads, head_dim)
            o = multi_head_attention(q, k, v, kv_len=kv_len,
                                     use_flash=c.use_flash)
            o = o.transpose(1, 2).reshape(b, s, d)
        return self.proj(o)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ls1 = nn.Parameter(torch.full((d,), float(cfg.layerscale_init)))
        self.ls2 = nn.Parameter(torch.full((d,), float(cfg.layerscale_init)))
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        mlp_hidden = int(d * cfg.mlp_ratio)
        if cfg.use_swiglu:
            # DINOv2 rounds SwiGLU hidden to a multiple of 8 after 2/3 scaling.
            sw_hidden = (int(mlp_hidden * 2 / 3) + 7) // 8 * 8
            self.mlp = SwiGLU(d, sw_hidden, d, quant=cfg.quant)
        else:
            self.mlp = Mlp(d, mlp_hidden, d, quant=cfg.quant)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1
        return x + self.mlp(self.norm2(x)) * self.ls2


class ViTEncoder(nn.Module):
    """Returns the hidden states (cls token included, final LN applied) at
    cfg.out_layers, matching HF Dinov2Backbone(apply_layernorm=True)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        _dense(cfg.quant)                 # an unknown policy raises here
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + cfg.pos_embed_size ** 2, d))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def interpolate_pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        """Patch position embeddings at a (ph, pw) grid: bicubic,
        align_corners=False, through ``resize_bicubic`` as ``txr`` does."""
        c = self.cfg
        pos = self.pos_embed
        if (ph, pw) == (c.pos_embed_size, c.pos_embed_size):
            return pos
        d = pos.shape[-1]
        pos_patch = pos[:, 1:].reshape(1, c.pos_embed_size, c.pos_embed_size,
                                       d)
        pos_patch = resize_bicubic(pos_patch, ph, pw, align_corners=False)
        return torch.cat([pos[:, :1], pos_patch.reshape(1, ph * pw, d)],
                         dim=1)

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        """pixels: (B, H, W, 3) normalized; H, W multiples of patch_size."""
        c = self.cfg
        b, h, w, _ = pixels.shape
        ph, pw = h // c.patch_size, w // c.patch_size

        # NHWC viewed as NCHW is channels_last memory: no copy on the way in,
        # and the conv's channels_last result reshapes to tokens for free.
        x = self.patch_embed(pixels.permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, ph * pw, c.hidden_size)

        pos = self.interpolate_pos_embed(ph, pw)
        x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x],
                      dim=1)
        x = x + pos.to(x.dtype)

        collected = {}
        want = set(c.out_layers)
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x)
            if i in want:
                collected[i] = self.norm(x)
        # One output per requested index, duplicates allowed.
        return [collected[i] for i in c.out_layers]
