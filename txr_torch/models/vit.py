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
dense layers (``_dense``). A block's two residual updates, x + branch *
LayerScale, and after attention the ``norm2`` of that too, go through
``txr_torch.ops.residual_norm`` (on the card one kernel each, on the CPU
the plain operators).

The position embedding resized to a frame's patch grid is a function of
the parameter and the grid alone, so it is kept (``core.derived.Derived``)
and reused while both stay the same: a new frame size, a weight load,
``.to`` or an in-place update recomputes it. The native grid needs no
resize, and a call through which autograd can reach ``pos_embed`` resizes
anew (``ViTEncoder.interpolate_pos_embed``).

Depth Anything 3's any-view encoder (``ViTConfig.anyview_start``; -1, off,
by default) adds to the same blocks and the same loop, from that layer on:
odd layers attend across every token of every view of the batch (the
(B, S, 3D) projection viewed as (1, B*S, 3D), no copy, through the same
kernel) and even layers within each view; q and k take a LayerNorm over
the head dimension and a 2-D rotary embedding (``QKPrep``: on the card one
kernel, ``ops.qk_prep``, that updates q and k of the fused projection in
place in float32 registers; on the CPU its plain version); a learned camera
token takes the cls slot (one for view 0, one shared by the others); each
taken layer hands on the last within-view layer's output joined to its own
(2 D channels), each after the final LayerNorm. None of this is in
``txr``.

For VGGT (``models/vggt.py``; not in ``txr``) the same encoder is DINOv2
with registers (``ViTConfig.num_registers``: learned tokens after the cls
token, without position embedding, left out of the outputs) and resizes
its position embedding with antialiasing (``pos_embed_antialias``); the
aggregator's blocks are these blocks with LayerNorms of eps 1e-5
(``norm_eps``), and so are the camera head's, 2048 wide with heads of
128, built with ``use_flash=False`` (the kernels take heads of 64).

StreamVGGT (``models/vggt.py:StreamVGGT``; not in ``txr``) streams frames
through the same blocks. Its global blocks call ``Attention`` with a
``KVSlot`` of the stream's key / value cache: the chunk's k and v rows
(after QK-norm and RoPE) are written into the slot's slab behind the rows it
holds, and the chunk's queries attend to all of them under a frame-causal
mask (``ops.attention.cached_attention``: the kernel's cached entry point
on the card). Its camera trunk asks for the same mask without a cache
(``frame_tokens``), on the plain route.

Submodule names mirror ``txr``'s parameter tree (``block_0`` ...,
``attn.qkv``, ``mlp.fc1``), so ``txr_torch.models.convert.from_txr_params``
is a walk over that tree. Activations are (B, S, D); pixels are NHWC.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from txr_torch.core.derived import Derived
from txr_torch.ops.attention import (attention_cached_plain,
                                     cached_attention, fused_attention,
                                     multi_head_attention, split_heads)
from txr_torch.ops.qk_prep import qk_prep, rope_tables
from txr_torch.ops.quant import Int8Linear
from txr_torch.ops.quant_fused import Int8LinearFused
from txr_torch.ops.residual_norm import residual_norm
from txr_torch.ops.resize import resize_bicubic
from txr_torch.utils.profiling import count, span


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
    # Depth Anything 3 any-view from this layer on (-1: off): the batch is
    # the views of one scene; odd layers attend across every token of every
    # view, q and k take QK-norm and 2-D RoPE, a camera token takes the cls
    # slot and each taken layer is joined to the last within-view output.
    anyview_start: int = -1
    # DINOv2 with registers (``dinov2_vitl14_reg``, VGGT's front): this many
    # learned tokens after the cls token, without position embedding, left
    # out of the outputs; and the position embedding resized with
    # antialiasing (DINOv2's ``interpolate_antialias``)
    num_registers: int = 0
    pos_embed_antialias: bool = False
    # eps of every LayerNorm of the blocks, the final norm and QK-norm
    # (DINOv2's 1e-6; VGGT's aggregator keeps ``nn.LayerNorm``'s 1e-5)
    norm_eps: float = 1e-6

    @property
    def anyview(self) -> bool:
        return self.anyview_start >= 0

    def crossview(self, layer: int) -> bool:
        """Whether ``layer`` attends across the views."""
        return 0 <= self.anyview_start <= layer and layer % 2 == 1


VIT_PRESETS = {
    "vits": ViTConfig(384, 12, 6, out_layers=(2, 5, 8, 11)),
    "vitb": ViTConfig(768, 12, 12, out_layers=(2, 5, 8, 11)),
    "vitl": ViTConfig(1024, 24, 16, out_layers=(4, 11, 17, 23)),
    # DINOv2-giant: mlp_ratio 4 with the SwiGLU 2/3-round-to-8 reduction
    # gives the checkpoint hidden size round8(1536*4*2/3) = 4096.
    "vitg": ViTConfig(1536, 40, 24, mlp_ratio=4.0, use_swiglu=True,
                      out_layers=(9, 19, 29, 39)),
}
# Depth Anything 3 any-view, DA3-LARGE (arXiv:2511.10647): ViT-L with
# cross-view attention on the odd layers from 8, QK-norm, 2-D RoPE and the
# camera token from 8, and layers 11, 15, 19, 23 taken joined
VIT_PRESETS["vitl-anyview"] = replace(
    VIT_PRESETS["vitl"], out_layers=(11, 15, 19, 23), anyview_start=8)
# the 2-D RoPE's base frequency (Depth Anything 3, as CroCo and VGGT)
ROPE_BASE = 100.0


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


class QKPrep(nn.Module):
    """Depth Anything 3's QK-norm (a LayerNorm over the head dimension, with
    weight and bias, one for q and one for k) and 2-D RoPE on the fused
    (B, S, 3*H*D) projection, in float32 rounded once, through
    ``ops.qk_prep.qk_prep``: on the card one kernel updates q and k of the
    fused tensor in place, on the CPU the plain version returns a new one.
    Either way its forward returns the tensor the attention call reads. A
    module of its own so that attention proper starts where its forward
    ends; it counts ``models.qk_prep_kernel_calls`` or
    ``models.qk_prep_plain_calls``, one a call."""

    def __init__(self, head_dim: int, eps: float = 1e-6):
        super().__init__()
        self.q_norm = nn.LayerNorm(head_dim, eps=eps)
        self.k_norm = nn.LayerNorm(head_dim, eps=eps)

    def forward(self, qkv: torch.Tensor, heads: int, tables):
        """``tables``: ``rope_tables`` of the batch's patch grid."""
        with span("models.encoder.qk_prep", qkv):
            count("models.qk_prep_plain_calls" if qkv.device.type == "cpu"
                  else "models.qk_prep_kernel_calls", 1)
            return qk_prep(qkv, heads, self.q_norm, self.k_norm, tables)


@dataclass
class KVSlot:
    """One global layer's part of a stream's key / value cache: ``slab``
    (rows, 2 H D), each row k of every head then v, after QK-norm and RoPE;
    its first ``cached`` rows hold the stream's earlier frames."""
    slab: torch.Tensor
    cached: int


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, layer: int = 0):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        dense = _dense(cfg.quant)
        self.qkv = dense(d, 3 * d)   # one fused matrix product
        self.proj = dense(d, d)
        self.crossview = cfg.crossview(layer)
        self.qk_prep = (QKPrep(d // cfg.num_heads, cfg.norm_eps)
                        if 0 <= cfg.anyview_start <= layer else None)

    def forward(self, x, kv_len: Optional[int] = None, rope=None,
                cache: Optional[KVSlot] = None,
                frame_tokens: Optional[int] = None):
        """``cache``: a cross-view layer's ``KVSlot``; the B frames of ``x``
        (S tokens each) attend to the slot's rows and, frame-causally, to
        each other (``_cached``). ``frame_tokens`` without a cache: the
        B S tokens attend frame-causally in frames of that many tokens,
        on the plain route."""
        c = self.cfg
        b, s, d = x.shape
        head_dim = d // c.num_heads
        qkv = self.qkv(x)
        # a tensor-parallel rank holds whole heads of the fused product
        # (txr_torch.parallel.mesh), so the head count is read off its width
        heads = qkv.shape[-1] // (3 * head_dim)
        if self.qk_prep is not None:
            qkv = self.qk_prep(qkv, heads, rope)
        if cache is not None:
            return self._cached(qkv, cache, heads, head_dim)
        if frame_tokens is not None:
            return self._frame_causal(qkv, frame_tokens, heads, head_dim)
        if self.crossview:
            # every token of every view as one sequence: a view, no copy
            qkv = qkv.view(1, b * s, qkv.shape[-1])
        qb, qs = qkv.shape[:2]
        pairs = qb * qs * (qs if kv_len is None else kv_len)
        count("models.attention_pairs_crossview" if self.crossview
              else "models.attention_pairs_local", pairs)
        count("models.attention_flops", 4 * heads * head_dim * pairs)
        with span("models.encoder.crossview" if self.crossview
                  else "models.encoder.attention", qkv):
            if c.use_flash is not False and heads % 2 == 0:
                # the kernel reads the fused layout in place
                o = fused_attention(qkv, heads, head_dim, kv_len)
            else:
                q, k, v = split_heads(qkv, heads, head_dim)
                o = multi_head_attention(q, k, v, kv_len=kv_len,
                                         use_flash=c.use_flash)
                o = o.transpose(1, 2).reshape(qb, qs, heads * head_dim)
        return self.proj(o.view(b, s, -1) if self.crossview else o)

    def _cached(self, qkv: torch.Tensor, slot: KVSlot, heads: int,
                head_dim: int) -> torch.Tensor:
        """The B frames of the (B, S, 3 H D) ``qkv`` after the slot's rows:
        their k and v written to ``slot.slab[cached:cached + B S]``, then
        each query row against the cached rows and the chunk's rows up to
        the end of its frame. Counts the query-key pairs the mask keeps,
        against cached rows and against the chunk's own."""
        if not self.crossview:
            raise ValueError("only a cross-view layer attends to a cache")
        b, s, _ = qkv.shape
        rows, c0 = b * s, slot.cached
        with span("models.aggregator.kv_append", qkv):
            slot.slab[c0:c0 + rows].copy_(
                qkv.view(rows, -1)[:, heads * head_dim:])
        fresh = s * s * b * (b + 1) // 2
        count("models.kv_rows_written", rows)
        count("models.kv_pairs_cached", rows * c0)
        count("models.kv_pairs_fresh", fresh)
        count("models.attention_pairs_crossview", rows * c0 + fresh)
        count("models.attention_flops",
              4 * heads * head_dim * (rows * c0 + fresh))
        with span("models.encoder.cached", qkv):
            o = cached_attention(qkv.view(1, rows, -1), slot.slab, heads,
                                 head_dim, c0, s)
        return self.proj(o.view(b, s, -1))

    def _frame_causal(self, qkv: torch.Tensor, frame_tokens: int,
                      heads: int, head_dim: int) -> torch.Tensor:
        """Each of the B sequences of ``qkv`` attending frame-causally in
        frames of ``frame_tokens`` tokens, without a cache, on the plain
        route (StreamVGGT's camera trunk: a token a frame, heads of 128)."""
        b, s, _ = qkv.shape
        q, k, v = split_heads(qkv, heads, head_dim)
        n = s // frame_tokens
        pairs = b * frame_tokens ** 2 * n * (n + 1) // 2
        count("models.attention_pairs_local", pairs)
        count("models.attention_flops", 4 * heads * head_dim * pairs)
        with span("models.encoder.attention", qkv):
            o = attention_cached_plain(q, k, v, 0, frame_tokens)
        return self.proj(o.transpose(1, 2).reshape(b, s, heads * head_dim))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, layer: int = 0):
        super().__init__()
        d = cfg.hidden_size
        self.ls1 = nn.Parameter(torch.full((d,), float(cfg.layerscale_init)))
        self.ls2 = nn.Parameter(torch.full((d,), float(cfg.layerscale_init)))
        self.norm1 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.attn = Attention(cfg, layer)
        self.norm2 = nn.LayerNorm(d, eps=cfg.norm_eps)
        mlp_hidden = int(d * cfg.mlp_ratio)
        if cfg.use_swiglu:
            # DINOv2 rounds SwiGLU hidden to a multiple of 8 after 2/3 scaling.
            sw_hidden = (int(mlp_hidden * 2 / 3) + 7) // 8 * 8
            self.mlp = SwiGLU(d, sw_hidden, d, quant=cfg.quant)
        else:
            self.mlp = Mlp(d, mlp_hidden, d, quant=cfg.quant)

    def forward(self, x, rope=None, cache: Optional[KVSlot] = None,
                frame_tokens: Optional[int] = None):
        x, h = self._residual(x, self.attn(self.norm1(x), rope=rope,
                                           cache=cache,
                                           frame_tokens=frame_tokens),
                              self.ls1, self.norm2)
        return self._residual(x, self.mlp(h), self.ls2)

    @staticmethod
    def _residual(x, branch, gamma, norm=None):
        """``ops.residual_norm``: x + branch * gamma, and the norm of that
        where ``norm`` is given, in one kernel on the card; counts
        ``models.residual_norm_kernel_calls`` or
        ``models.residual_norm_plain_calls``, one a call."""
        count("models.residual_norm_plain_calls" if x.device.type == "cpu"
              else "models.residual_norm_kernel_calls", 1)
        return residual_norm(x, branch, gamma, norm)


def _resize_pos_embed(pos: torch.Tensor, ph: int, pw: int,
                      antialias: bool = False) -> torch.Tensor:
    """(1, 1 + g*g, d) position embedding -> (1, 1 + ph*pw, d): the patch
    rows resized bicubically (align_corners=False, through
    ``resize_bicubic`` as ``txr`` does), the cls row kept first. With
    ``antialias`` DINOv2-reg's resize: bicubic with antialiasing by size
    (offset 0), in float32 and cast back, as DINOv2's
    ``interpolate_pos_encoding`` does (it differs from the plain resize
    where a side shrinks, VGGT's 37 -> 21 rows)."""
    d = pos.shape[-1]
    g = math.isqrt(pos.shape[1] - 1)
    grid = pos[:, 1:].reshape(1, g, g, d)
    if antialias:
        patch = F.interpolate(grid.permute(0, 3, 1, 2).float(),
                              size=(ph, pw), mode="bicubic",
                              align_corners=False, antialias=True)
        patch = patch.permute(0, 2, 3, 1).to(pos.dtype)
    else:
        patch = resize_bicubic(grid, ph, pw, align_corners=False)
    return torch.cat([pos[:, :1], patch.reshape(1, ph * pw, d)], dim=1)


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
        if cfg.num_registers:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_registers, d))
        if cfg.anyview:
            # (1, 2, d): the reference view's token, then the others'
            self.camera_token = nn.Parameter(torch.zeros(1, 2, d))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg, i))
        self.norm = nn.LayerNorm(d, eps=cfg.norm_eps)
        # the resized embedding of the latest grid, per parameter state
        self._pos_resized = Derived(_resize_pos_embed)

    def interpolate_pos_embed(self, ph: int, pw: int) -> torch.Tensor:
        """Position embeddings (cls row first) at a (ph, pw) patch grid.

        The native grid returns the parameter. Any other grid takes
        ``_resize_pos_embed``, kept in ``Derived`` for the latest grid and
        the parameter's state (storage, version, dtype, device, shape,
        stride), so a new grid, ``load_state_dict``, ``.to(...)`` or an
        in-place update resizes again and every other call reuses it; the
        counters ``models.pos_embed_hits`` / ``models.pos_embed_misses``
        say which. Where autograd would reach ``pos_embed`` (grad enabled
        and the parameter requiring it) the resize runs uncached, so the
        gradient flows through it.
        """
        c = self.cfg
        pos = self.pos_embed
        if (ph, pw) == (c.pos_embed_size, c.pos_embed_size):
            return pos
        aa = c.pos_embed_antialias
        if torch.is_grad_enabled() and pos.requires_grad:
            return _resize_pos_embed(pos, ph, pw, aa)
        out = self._pos_resized.get(pos, ph, pw, aa)
        count("models.pos_embed_misses" if self._pos_resized.computed
              else "models.pos_embed_hits", 1)
        return out

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        """pixels: (B, H, W, 3) normalized; H, W multiples of patch_size."""
        with span("models.encoder", pixels):
            c = self.cfg
            b, h, w, _ = pixels.shape
            ph, pw = h // c.patch_size, w // c.patch_size

            # NHWC viewed as NCHW is channels_last memory: no copy on the way
            # in, and the conv's channels_last result reshapes to tokens for
            # free.
            x = self.patch_embed(pixels.permute(0, 3, 1, 2))
            x = x.permute(0, 2, 3, 1).reshape(b, ph * pw, c.hidden_size)

            pos = self.interpolate_pos_embed(ph, pw)
            x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x],
                          dim=1)
            x = x + pos.to(x.dtype)
            r = c.num_registers
            if r:
                x = torch.cat([x[:, :1], self.register_tokens.expand(
                    b, -1, -1).to(x.dtype), x[:, 1:]], dim=1)

            rope = (rope_tables(ph, pw, c.hidden_size // c.num_heads,
                                ROPE_BASE, x.device) if c.anyview else None)
            collected = {}
            want = set(c.out_layers)
            local = x
            for i in range(c.num_layers):
                if i == c.anyview_start:
                    x = torch.cat([self._camera_tokens(b, x.dtype), x[:, 1:]],
                                  dim=1)
                block = getattr(self, f"block_{i}")
                x = block(x, rope)
                if not block.attn.crossview:
                    local = x
                if i in want:
                    collected[i] = (torch.cat([self.norm(local),
                                               self.norm(x)], dim=-1)
                                    if c.anyview else self.norm(x))
                    if r:
                        collected[i] = torch.cat(
                            [collected[i][:, :1], collected[i][:, 1 + r:]],
                            dim=1)
            # One output per requested index, duplicates allowed.
            return [collected[i] for i in c.out_layers]

    def _camera_tokens(self, b: int, dtype) -> torch.Tensor:
        """(b, 1, d): view 0's camera token, then the shared one."""
        t = self.camera_token.to(dtype)
        return torch.cat([t[:, :1], t[:, 1:].expand(b - 1, -1, -1)], dim=0)
